"""Forward-warping (splatting) ops (PyTorch port of ``slrsfs_tpu/ops/splat.py``).

Layout is NHWC and a displacement is ``(..., 2)`` with channel 0 = x. Every
source pixel ``(y, x)`` moves to ``(x + u, y + v)`` and its value is split
bilinearly over the four integer neighbours of the target; corners outside
the grid are dropped.

``splat_dual_normalize`` is the main path's kernel wrapper (K2,
``csrc/splat.cu``): the dual-ended sparse splat plus the softmax-splat
normalisation of ``slrsfs_tpu/engine/rollout.py:577-581``.
``splat_dual_normalize_slr`` is the same splat with the SLR epilogue
(``slrsfs_tpu/models/slr.py:slr_unpack_splatted``, two normalisers). Both
accumulate in the dtype of the rows they are given: float32, or bfloat16
for the render's ``bfloat16-fast`` mode.

``softsplat_sum_at`` (``_paired``, ``_quad``: the JAX package's TPU row
layouts of one sum, here names of one kernel) and the raw two-ended
``softsplat_sum_at_quad_dual`` are the sparse splats without an epilogue
(K8, entry ``splat_sum_at`` of ``csrc/splat.cu``).

``*_plain`` are the plain versions: the JAX quad layout (weighted rows
rounded to the rows' dtype, one ``index_add_`` into a padded
``(H·W + 2·(W+1), 4C)`` buffer, the four-quarter combine), which repeats
the JAX order of bf16 roundings, then the division.

``softsplat_sum`` is the dense summation splat of the training pass and the
dense rollouts (K3, ``csrc/splat_dense.cu``) as a
``torch.autograd.Function``: on the card a scatter kernel forward and a
gather kernel backward; on the CPU its plain versions
``softsplat_sum_plain`` and ``softsplat_sum_grad_plain``. ``softsplat``
builds the reference's four splat modes on it.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch

from slrsfs_tpu_torch import kernels

Tensor = torch.Tensor

NORM_EPS = 1e-8  # reference animating_softmax_splating.py:691


def corners(ox: Tensor, oy: Tensor, height: int, width: int
            ) -> List[Tuple[Tensor, Tensor, Tensor]]:
    """Flat target index (clipped), bilinear weight and in-grid flag of the
    four corners (NW, NE, SW, SE) of target positions ``(ox, oy)``, as the
    JAX ``_corners`` computes them."""
    x0f = torch.floor(ox)
    y0f = torch.floor(oy)
    dx = ox - x0f
    dy = oy - y0f
    x0 = x0f.to(torch.int64)
    y0 = y0f.to(torch.int64)
    out = []
    for cx, cy, w in ((x0, y0, (1.0 - dx) * (1.0 - dy)),
                      (x0 + 1, y0, dx * (1.0 - dy)),
                      (x0, y0 + 1, (1.0 - dx) * dy),
                      (x0 + 1, y0 + 1, dx * dy)):
        inside = (cx >= 0) & (cx < width) & (cy >= 0) & (cy < height)
        lin = cy.clamp(0, height - 1) * width + cx.clamp(0, width - 1)
        out.append((lin, w, inside))
    return out


def _corner_taps(ox: Tensor, oy: Tensor, height: int, width: int
                 ) -> List[Tuple[Tensor, Tensor]]:
    """Flat target index (clipped) and validity-masked bilinear weight of the
    four corners of target positions ``(ox, oy)``."""
    return [(lin, torch.where(inside, w, torch.zeros_like(w)))
            for lin, w, inside in corners(ox, oy, height, width)]


def softsplat_sum_plain(inp: Tensor, flow: Tensor) -> Tensor:
    """Summation forward splat (plain). inp (B, H, W, C), flow (B, H, W, 2).

    Weights are computed at flow precision and cast to ``inp.dtype``, as the
    JAX ``_splat_sum_single`` does."""
    B, H, W, C = inp.shape
    xs = torch.arange(W, dtype=flow.dtype, device=flow.device)[None, :]
    ys = torch.arange(H, dtype=flow.dtype, device=flow.device)[:, None]
    out = torch.zeros((B, H * W, C), dtype=inp.dtype, device=inp.device)
    for b in range(B):
        ox = (xs + flow[b, ..., 0]).reshape(-1)
        oy = (ys + flow[b, ..., 1]).reshape(-1)
        rows = inp[b].reshape(H * W, C)
        for lin, w in _corner_taps(ox, oy, H, W):
            out[b].index_add_(0, lin, rows * w.to(inp.dtype)[:, None])
    return out.reshape(B, H, W, C)


def softsplat_sum_grad_plain(inp: Tensor, flow: Tensor, g: Tensor
                             ) -> Tuple[Tensor, Tensor]:
    """Plain VJP of ``softsplat_sum_plain``: (grad_inp, grad_flow) for the
    output cotangent ``g`` (B, H, W, C), op for op the JAX
    ``_splat_grad_single`` with ``_corner_weight_grads``: per corner,
    gather g at the clipped target (0 where the corner is outside the
    grid), add g·w to grad_inp and (Σ_c inp·g)·dw/d{x,y} to grad_flow, in
    f32 (float64 inputs: in float64); grad_inp is cast back to
    ``inp.dtype``."""
    B, H, W, C = inp.shape
    f32 = torch.promote_types(inp.dtype, torch.float32)
    xs = torch.arange(W, dtype=flow.dtype, device=flow.device)[None, :]
    ys = torch.arange(H, dtype=flow.dtype, device=flow.device)[:, None]
    grad_inp = torch.zeros((B, H * W, C), dtype=f32, device=inp.device)
    grad_flow = torch.zeros((B, H * W, 2), dtype=flow.dtype, device=flow.device)
    for b in range(B):
        ox = (xs + flow[b, ..., 0]).reshape(-1)
        oy = (ys + flow[b, ..., 1]).reshape(-1)
        dx = ox - torch.floor(ox)
        dy = oy - torch.floor(oy)
        dwdx = (-(1.0 - dy), (1.0 - dy), -dy, dy)
        dwdy = (-(1.0 - dx), -dx, (1.0 - dx), dx)
        gflat = g[b].reshape(H * W, C)
        x = inp[b].reshape(H * W, C).to(f32)
        gfx = torch.zeros((H * W,), dtype=flow.dtype, device=flow.device)
        gfy = torch.zeros((H * W,), dtype=flow.dtype, device=flow.device)
        for (lin, w, inside), dwx, dwy in zip(corners(ox, oy, H, W), dwdx, dwdy):
            g_at = torch.where(inside[:, None], gflat[lin], 0.0).to(f32)
            grad_inp[b] = grad_inp[b] + g_at * w.to(f32)[:, None]
            inner = torch.sum(x * g_at, dim=-1)
            gfx = gfx + (inner * dwx).to(flow.dtype)
            gfy = gfy + (inner * dwy).to(flow.dtype)
        grad_flow[b] = torch.stack([gfx, gfy], dim=-1)
    return (grad_inp.reshape(B, H, W, C).to(inp.dtype),
            grad_flow.reshape(B, H, W, 2))


def _check_dense(inp: Tensor, flow: Tensor) -> None:
    if inp.ndim != 4 or flow.ndim != 4 or flow.shape[-1] != 2 \
            or tuple(flow.shape[:3]) != tuple(inp.shape[:3]):
        raise ValueError(f"inp (B, H, W, C) and flow (B, H, W, 2) do not "
                         f"match: {tuple(inp.shape)}, {tuple(flow.shape)}")
    if flow.dtype != torch.float32:
        raise TypeError(f"flow must be float32, got {flow.dtype}")
    if inp.device != flow.device:
        raise ValueError(f"inp is on {inp.device}, flow on {flow.device}")
    if inp.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {inp.device}")


def _cuda_args(named: dict):
    for name, t in named.items():
        if t.dtype != torch.float32:
            raise TypeError(f"the K3 kernels take float32 {name}, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 8:
            raise ValueError(f"{name} must be contiguous and 8-byte aligned")
    return [t.data_ptr() for t in named.values()]


def softsplat_sum_fwd_kernel(inp: Tensor, flow: Tensor) -> Tensor:
    """K3 forward on the card: ``softsplat_sum_plain(inp, flow)`` by the
    window scatter (``csrc/splat_window.cuh``) into a zeroed output."""
    B, H, W, C = inp.shape
    out = torch.zeros_like(inp)
    ptrs = _cuda_args(dict(inp=inp, flow=flow, out=out))
    with torch.cuda.device(inp.device):
        kernels.SPLAT_DENSE_FWD.launch(*ptrs, B, H, W, C,
                                       torch.cuda.current_stream().cuda_stream)
    return out


def softsplat_sum_bwd_kernel(inp: Tensor, flow: Tensor, g: Tensor
                             ) -> Tuple[Tensor, Tensor]:
    """K3 backward on the card: ``softsplat_sum_grad_plain(inp, flow, g)``
    by a gather, a warp per 4 x 8 tile of source pixels with the tile's inp
    rows and its g rows (a window, or row by row) staged in shared memory
    (``csrc/splat_dense.cu``)."""
    B, H, W, C = inp.shape
    if tuple(g.shape) != tuple(inp.shape):
        raise ValueError(f"g must be {tuple(inp.shape)}, got {tuple(g.shape)}")
    grad_inp = torch.empty_like(inp)
    grad_flow = torch.empty_like(flow)
    ptrs = _cuda_args(dict(inp=inp, flow=flow, g=g, grad_inp=grad_inp,
                           grad_flow=grad_flow))
    with torch.cuda.device(inp.device):
        kernels.SPLAT_DENSE_BWD.launch(*ptrs, B, H, W, C,
                                       torch.cuda.current_stream().cuda_stream)
    return grad_inp, grad_flow


class SoftsplatSum(torch.autograd.Function):
    """The summation splat with its gather VJP (the JAX ``custom_vjp``).
    ``plain`` selects the plain versions on any device; otherwise tensors on
    the card go through the K3 kernels and tensors on the CPU through the
    plain versions."""

    @staticmethod
    def forward(ctx, inp: Tensor, flow: Tensor, plain: bool) -> Tensor:
        ctx.save_for_backward(inp, flow)
        ctx.plain = plain or inp.device.type == "cpu"
        if ctx.plain:
            return softsplat_sum_plain(inp, flow)
        return softsplat_sum_fwd_kernel(inp, flow)

    @staticmethod
    def backward(ctx, g: Tensor):
        inp, flow = ctx.saved_tensors
        g = g.contiguous()
        if ctx.plain:
            grad_inp, grad_flow = softsplat_sum_grad_plain(inp, flow, g)
        else:
            grad_inp, grad_flow = softsplat_sum_bwd_kernel(inp, flow, g)
        return grad_inp, grad_flow, None


def softsplat_sum(inp: Tensor, flow: Tensor) -> Tensor:
    """K3 wrapper: the summation splat of inp (B, H, W, C) by flow
    (B, H, W, 2), differentiable in both. On the card its forward and
    backward are the K3 kernels (float32, contiguous inputs); on the CPU
    their plain versions."""
    _check_dense(inp, flow)
    return SoftsplatSum.apply(inp, flow, False)


def softsplat_sum_plain_vjp(inp: Tensor, flow: Tensor) -> Tensor:
    """``softsplat_sum`` through the plain versions on any device: the
    plain path that a kernel-path training step is held against."""
    _check_dense(inp, flow)
    return SoftsplatSum.apply(inp, flow, True)


SPLAT_MODES = ("summation", "average", "linear", "softmax")


def softsplat(inp: Tensor, flow: Tensor, metric: Optional[Tensor] = None,
              mode: str = "summation") -> Tensor:
    """The four splat modes of reference ``FunctionSoftsplat`` (the JAX
    ``softsplat``) over ``softsplat_sum`` (K3 on the card). inp (B, H, W,
    C), flow (B, H, W, 2), metric (B, H, W, 1) or None. Other modes than
    summation splat a last weight channel and divide by it, exact zeros
    replaced by 1."""
    if mode not in SPLAT_MODES:
        raise ValueError(f"mode must be one of {SPLAT_MODES}, got {mode!r}")
    if mode == "average":
        inp = torch.cat([inp, torch.ones_like(inp[..., :1])], dim=-1)
    elif mode == "linear":
        inp = torch.cat([inp * metric, metric], dim=-1)
    elif mode == "softmax":
        m = torch.exp(metric)
        inp = torch.cat([inp * m, m], dim=-1)
    out = softsplat_sum(inp.contiguous(), flow)
    if mode == "summation":
        return out
    norm = out[..., -1:]
    norm = torch.where(norm == 0.0, torch.ones_like(norm), norm)
    return out[..., :-1] / norm


def _quad_rows_plain(u: Tensor, positions: Tensor, disp: Tensor,
                     height: int, width: int, keep: Optional[Tensor] = None):
    """The JAX ``_quad_rows``: padded flat index q (P,) of each row's NW
    corner and its (P, 4C) row [NW·u | NE·u | SW·u | SE·u] with the
    bilinear weights computed in float32 (times ``keep``, 0 for padding
    rows, when given) and the product rounded to ``u.dtype``."""
    ox = positions[:, 0].to(disp.dtype) + disp[:, 0]
    oy = positions[:, 1].to(disp.dtype) + disp[:, 1]
    x0f = torch.floor(ox)
    y0f = torch.floor(oy)
    dx = ox - x0f
    dy = oy - y0f
    x0 = x0f.to(torch.int64)
    y0 = y0f.to(torch.int64)
    rows = []
    for cx, cy, w in ((x0, y0, (1.0 - dx) * (1.0 - dy)),
                      (x0 + 1, y0, dx * (1.0 - dy)),
                      (x0, y0 + 1, (1.0 - dx) * dy),
                      (x0 + 1, y0 + 1, dx * dy)):
        inside = (cx >= 0) & (cx < width) & (cy >= 0) & (cy < height)
        w = w * inside.to(w.dtype)
        if keep is not None:
            w = w * keep
        rows.append(u.to(w.dtype) * w[:, None])
    pad = width + 1
    q = (y0 * width + x0 + pad).clamp(0, height * width + 2 * pad - 1)
    return q, torch.cat(rows, dim=-1).to(u.dtype)


def _quad_combine(buf: Tensor, height: int, width: int, C: int) -> Tensor:
    """The JAX ``_quad_combine``: NE, SW, SE quarters shifted by +1, +W,
    +W+1 flat cells onto the NW quarter, summed left to right."""
    pad = width + 1
    HW = height * width
    return (buf[pad:pad + HW, :C]
            + buf[pad - 1:pad - 1 + HW, C:2 * C]
            + buf[pad - width:pad - width + HW, 2 * C:3 * C]
            + buf[pad - width - 1:pad - width - 1 + HW, 3 * C:]
            ).reshape(height, width, C)


def _quad_sum_plain(ends, positions: Tensor, height: int, width: int,
                    keep: Optional[Tensor] = None) -> Tensor:
    """Sum of the splats of ``ends`` [(rows (P, C), disp (P, 2))] in the
    rows' dtype: all ends' quad rows in one ``index_add_``, then the
    combine."""
    qs, upds = zip(*(_quad_rows_plain(u, positions, d, height, width, keep)
                     for u, d in ends))
    u = ends[0][0]
    C = u.shape[-1]
    buf = torch.zeros((height * width + 2 * (width + 1), 4 * C), dtype=u.dtype,
                      device=u.device)
    buf.index_add_(0, torch.cat(qs), torch.cat(upds))
    return _quad_combine(buf, height, width, C)


def _scaled(u: Tensor, w: float) -> Tensor:
    """``(u · w).astype(u.dtype)`` with the product in float32."""
    return (u.to(torch.float32) * w).to(u.dtype)


def softsplat_sum_at_plain(u: Tensor, positions: Tensor, disp: Tensor,
                           height: int, width: int) -> Tensor:
    """Plain K8, one end: the summation splat of rows ``u`` (P, C) (padding
    rows zero) from ``positions`` (P, 2) int [x, y] moved by ``disp`` (P, 2)
    f32, onto a zero (height, width, C) grid in ``u.dtype``. The JAX
    ``softsplat_sum_at``, ``_paired`` and ``_quad`` up to summation order."""
    return _quad_sum_plain([(u, disp)], positions, height, width)


softsplat_sum_at_paired_plain = softsplat_sum_at_plain
softsplat_sum_at_quad_plain = softsplat_sum_at_plain


def softsplat_sum_at_quad_dual_plain(u: Tensor, positions: Tensor,
                                     disp_a: Tensor, disp_b: Tensor,
                                     w_a: float, w_b: float, height: int,
                                     width: int) -> Tensor:
    """Plain K8, two ends: ``splat(u·w_a, disp_a) + splat(u·w_b, disp_b)``
    with the scaled rows rounded to ``u.dtype`` (the JAX
    ``softsplat_sum_at_quad_dual``)."""
    return _quad_sum_plain([(_scaled(u, w_a), disp_a), (_scaled(u, w_b), disp_b)],
                           positions, height, width)


def _splat_dual_plain(u_mov: Tensor, positions: Tensor, valid: Tensor,
                      disp_a: Tensor, disp_b: Tensor, w_a: float, w_b: float,
                      u_static: Tensor) -> Tensor:
    """``g = splat(u_mov·w_a, disp_a) + splat(u_mov·w_b, disp_b) + u_static``
    in the rows' dtype, then float32: (H, W, C1), the accumulator both K2
    epilogues normalise. Rows with ``valid`` 0 contribute nothing."""
    H, W, C1 = u_static.shape
    keep = (valid != 0).to(torch.float32)
    g = _quad_sum_plain([(_scaled(u_mov, w_a), disp_a),
                         (_scaled(u_mov, w_b), disp_b)], positions, H, W, keep)
    return (g + u_static).to(torch.float32)


def splat_dual_normalize_plain(u_mov: Tensor, positions: Tensor,
                               valid: Tensor, disp_a: Tensor, disp_b: Tensor,
                               w_a: float, w_b: float, u_static: Tensor,
                               out_dtype: torch.dtype) -> Tensor:
    """Plain version of K2.

    u_mov (P, C+1) moving rows; positions (P, 2) int [x, y]; valid (P,)
    f32, rows with 0 are padding and contribute nothing; disp_a / disp_b
    (P, 2) f32; w_a / w_b the temporal weights; u_static (H, W, C+1), the
    static identity. u_mov and u_static are float32, or bfloat16 to
    accumulate in bf16. Returns ``g[..., :C] / max(g[..., C], 1e-8)`` in
    ``out_dtype``, shape (H, W, C), where ``g = splat(u_mov·w_a, disp_a) +
    splat(u_mov·w_b, disp_b) + u_static`` in the rows' dtype, divided in
    float32.
    """
    g = _splat_dual_plain(u_mov, positions, valid, disp_a, disp_b, w_a, w_b,
                          u_static)
    return (g[..., :-1] / torch.clamp(g[..., -1:], min=NORM_EPS)).to(out_dtype)


def splat_dual_normalize_slr_plain(u_mov: Tensor, positions: Tensor,
                                   valid: Tensor, disp_a: Tensor,
                                   disp_b: Tensor, w_a: float, w_b: float,
                                   u_static: Tensor,
                                   out_dtype: torch.dtype) -> Tensor:
    """Plain version of K2's SLR epilogue: the splat of
    ``splat_dual_normalize_plain`` over the SLR layout ``[fs·e^Z (C-1),
    af·e^C, e^C, e^Z]`` (C1 = C + 2 channels), then
    ``[fs·e^Z / max(e^Z, 1e-8), af·e^C / max(e^C, 1e-8)]``, shape (H, W, C):
    ``slr_unpack_splatted`` with ``use_alpha0``, both halves in one tensor."""
    g = _splat_dual_plain(u_mov, positions, valid, disp_a, disp_b, w_a, w_b,
                          u_static)
    return torch.cat([g[..., :-3] / torch.clamp(g[..., -1:], min=NORM_EPS),
                      g[..., -3:-2] / torch.clamp(g[..., -2:-1], min=NORM_EPS)],
                     dim=-1).to(out_dtype)


def place_windows(cx: Tensor, cy: Tensor, live: Tensor, height: int, width: int,
                  cap: int):
    """The f32 scatters' window of each unit (``csrc/splat_window.cuh:
    place_window``, repeated in integers on any device): cx, cy (U, n)
    int64 corners of the U units' items, ``live`` (U, n) the corners of
    items that add anything. Returns (in-grid (U, n) bool, in-window (U, n)
    bool): the bounding box of a unit's in-grid corners when it holds at
    most ``cap`` cells, else a box about isqrt(cap) on a side, widened
    where the bounding box is narrow, centred on the corners' mean (floor)
    and clamped into the bounding box."""
    ins = live & (cx >= 0) & (cx < width) & (cy >= 0) & (cy < height)
    big = 1 << 40
    n = ins.sum(1)
    bx0 = torch.where(ins, cx, big).amin(1)
    bx1 = torch.where(ins, cx, -big).amax(1)
    by0 = torch.where(ins, cy, big).amin(1)
    by1 = torch.where(ins, cy, -big).amax(1)
    sx = torch.where(ins, cx, 0).sum(1) // n.clamp(min=1)
    sy = torch.where(ins, cy, 0).sum(1) // n.clamp(min=1)
    bw = (bx1 - bx0 + 1).clamp(min=1)
    bh = (by1 - by0 + 1).clamp(min=1)
    if cap < 1:
        return ins, torch.zeros_like(ins)
    lw = bw.clamp(max=math.isqrt(cap))
    rows = torch.minimum(bh, cap // lw)
    lw = torch.minimum(bw, cap // rows)
    ox = torch.where(bw <= lw, bx0,
                     torch.minimum(torch.maximum(sx - lw // 2, bx0), bx1 - lw + 1))
    oy = torch.where(bh <= rows, by0,
                     torch.minimum(torch.maximum(sy - rows // 2, by0), by1 - rows + 1))
    dx, dy = cx - ox[:, None], cy - oy[:, None]
    return ins, ins & (dx >= 0) & (dx < lw[:, None]) & (dy >= 0) & (dy < rows[:, None])


def _corner_xy(ox: Tensor, oy: Tensor) -> Tuple[Tensor, Tensor]:
    """The four corners' integer (x, y), (..., 4) int64, of positions in f32."""
    x0 = torch.floor(ox).to(torch.int64)
    y0 = torch.floor(oy).to(torch.int64)
    return (torch.stack([x0, x0 + 1, x0, x0 + 1], -1),
            torch.stack([y0, y0, y0 + 1, y0 + 1], -1))


def rows_window_misses(positions: Tensor, valid: Optional[Tensor], disps,
                       height: int, width: int, run: int, cap: int
                       ) -> Tuple[int, int]:
    """(corners in the grid, corners outside their window) of K2's or K8's
    f32 scatter: each end of ``disps`` split into runs of ``run``
    consecutive rows, rows with valid 0 skipped; ``run`` and ``cap`` as the
    kernel's library reports them (``splat_rows_run``,
    ``splat_rows_window_cells``)."""
    P = positions.shape[0]
    n_runs = -(-P // run)
    pad = n_runs * run - P
    keep = torch.ones(P, dtype=torch.bool, device=positions.device) \
        if valid is None else valid != 0
    n_in = n_miss = 0
    for d in disps:
        cx, cy = _corner_xy(positions[:, 0].to(torch.float32) + d[:, 0],
                            positions[:, 1].to(torch.float32) + d[:, 1])
        live = keep[:, None].expand(P, 4)
        cx, cy, live = (torch.nn.functional.pad(t.reshape(P * 4), (0, 4 * pad))
                        .reshape(n_runs, 4 * run) for t in (cx, cy, live))
        ins, hit = place_windows(cx, cy, live, height, width, cap)
        n_in += int(ins.sum())
        n_miss += int((ins & ~hit).sum())
    return n_in, n_miss


def _dense_windows(flow: Tensor, tile: Tuple[int, int], cap: int
                   ) -> Tuple[Tensor, Tensor]:
    """``place_windows`` over the tiles of flow (B, H, W, 2): each sample
    cut into ``tile`` (rows, columns) tiles, ragged at the edges. Returns
    (in-grid, in-window), each (tiles, 4 · rows · columns) bool."""
    B, H, W, _ = flow.shape
    ty, tx = tile
    Hp, Wp = -(-H // ty) * ty, -(-W // tx) * tx
    xs = torch.arange(W, dtype=torch.float32, device=flow.device)[None, :]
    ys = torch.arange(H, dtype=torch.float32, device=flow.device)[:, None]
    cx, cy = _corner_xy(xs + flow[..., 0], ys + flow[..., 1])
    live = torch.ones_like(cx, dtype=torch.bool)

    def tiles(t):
        t = torch.nn.functional.pad(t, (0, 0, 0, Wp - W, 0, Hp - H))
        return (t.reshape(B, Hp // ty, ty, Wp // tx, tx, 4)
                .permute(0, 1, 3, 2, 4, 5).reshape(-1, ty * tx * 4))

    return place_windows(tiles(cx), tiles(cy), tiles(live), H, W, cap)


def dense_window_misses(flow: Tensor, tile: Tuple[int, int], cap: int
                        ) -> Tuple[int, int]:
    """(corners in the grid, corners outside their window) of K3's forward
    or backward on flow (B, H, W, 2): each sample cut into ``tile`` (rows,
    columns) tiles, ragged at the edges; ``tile`` and ``cap`` as the
    kernel's library reports them (forward: ``splat_dense_tile_rows``,
    ``splat_dense_tile_cols``, ``splat_dense_window_cells``; backward:
    ``splat_dense_bwd_tile_rows``, ``splat_dense_bwd_tile_cols``,
    ``splat_dense_bwd_window_cells(C)``)."""
    ins, hit = _dense_windows(flow, tile, cap)
    return int(ins.sum()), int((ins & ~hit).sum())


def dense_window_units(flow: Tensor, tile: Tuple[int, int], cap: int
                       ) -> Tuple[int, int]:
    """(tiles, tiles with a corner in the grid outside their window) on the
    tiling of ``dense_window_misses``: K3's backward stages such a tile's
    corner rows one by one instead of its window."""
    ins, hit = _dense_windows(flow, tile, cap)
    return ins.shape[0], int((ins & ~hit).any(1).sum())


SPLAT_DTYPES = (torch.float32, torch.bfloat16)


def _check_rows(u: Tensor, named: dict) -> None:
    """``named`` {name: (tensor, shape, dtype)}: shapes, types, the rows'
    device and contiguity, as the kernels take them; the rows ``u`` are
    float32 or bfloat16 (the accumulation dtype)."""
    if u.dtype not in SPLAT_DTYPES:
        raise TypeError(f"rows must be float32 or bfloat16, got {u.dtype}")
    if u.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {u.device}")
    for name, (t, shape, dtype) in named.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != u.device:
            raise ValueError(f"{name} is on {t.device}, the rows on {u.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if u.device.type == "cuda" and t.data_ptr() % 8:
            raise ValueError(f"{name} must be 8-byte aligned")


def splat_scratch(height: int, width: int, C1: int, dtype: torch.dtype,
                  device) -> Tensor:
    """The K2 kernel's accumulator for rows of ``dtype``: (H·W·C1,) float32,
    or the (H·W·4·C1p,) bfloat16 quarters of the bf16 mode (one per corner,
    combined as the JAX quad layout combines them). C1p is C1 rounded up to
    a multiple of 8, so that the kernel adds 8 channels of a quarter with
    one 16-byte reduction; the pad channels receive 0 and are never read."""
    return torch.empty((_scratch_numel(height, width, C1, dtype),), dtype=dtype,
                       device=device)


def _scratch_numel(height: int, width: int, C1: int, dtype: torch.dtype) -> int:
    if dtype == torch.bfloat16:  # csrc/splat.cu:quarter_stride
        return height * width * 4 * (-(-C1 // 8) * 8)
    return height * width * C1


def _splat_launch(kernel, plain, n_norm, u_mov, positions, valid, disp_a,
                  disp_b, w_a, w_b, u_static, out, acc):
    P, C1 = u_mov.shape
    H, W = u_static.shape[:2]
    named = {"u_mov": (u_mov, (P, C1), u_mov.dtype),
             "positions": (positions, (P, 2), torch.int32),
             "valid": (valid, (P,), torch.float32),
             "disp_a": (disp_a, (P, 2), torch.float32),
             "disp_b": (disp_b, (P, 2), torch.float32),
             "u_static": (u_static, (H, W, C1), u_mov.dtype),
             "out": (out, (H, W, C1 - n_norm), out.dtype)}
    if out.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"out must be float32 or bfloat16, got {out.dtype}")
    if acc is None and u_mov.device.type == "cuda":
        acc = splat_scratch(H, W, C1, u_mov.dtype, u_mov.device)
    if acc is not None:  # checked on every device, used on the card
        named["acc"] = (acc, (_scratch_numel(H, W, C1, u_mov.dtype),), u_mov.dtype)
    _check_rows(u_mov, named)
    if u_mov.device.type == "cuda" and u_mov.dtype == torch.bfloat16 \
            and acc.data_ptr() % 16:
        raise ValueError("the bf16 acc must be 16-byte aligned")
    if u_mov.device.type == "cpu":
        out.copy_(plain(u_mov, positions, valid, disp_a, disp_b, w_a, w_b,
                        u_static, out.dtype))
        return out
    with torch.cuda.device(u_mov.device):
        stream = torch.cuda.current_stream().cuda_stream
        kernel.launch(
            u_mov.data_ptr(), positions.data_ptr(), valid.data_ptr(),
            disp_a.data_ptr(), disp_b.data_ptr(), float(w_a), float(w_b),
            u_static.data_ptr(), acc.data_ptr(), out.data_ptr(), P, C1, H, W,
            int(out.dtype == torch.bfloat16),
            int(u_mov.dtype == torch.bfloat16), stream)
    return out


def splat_dual_normalize(u_mov: Tensor, positions: Tensor, valid: Tensor,
                         disp_a: Tensor, disp_b: Tensor, w_a: float,
                         w_b: float, u_static: Tensor, out: Tensor,
                         acc: Tensor = None) -> Tensor:
    """K2 wrapper: writes ``splat_dual_normalize_plain(...)`` into ``out``
    ((H, W, C), f32 or bf16, e.g. one frame slot of a decode chunk).

    On the card the CUDA kernel computes it, accumulating in ``u_mov``'s
    dtype, with ``acc`` (``splat_scratch``) as its scratch accumulator
    (allocated when None); on the CPU the plain version does. A given
    ``acc`` must have ``splat_scratch``'s size and dtype on every device."""
    return _splat_launch(kernels.SPLAT, splat_dual_normalize_plain, 1, u_mov,
                         positions, valid, disp_a, disp_b, w_a, w_b, u_static,
                         out, acc)


def splat_dual_normalize_slr(u_mov: Tensor, positions: Tensor, valid: Tensor,
                             disp_a: Tensor, disp_b: Tensor, w_a: float,
                             w_b: float, u_static: Tensor, out: Tensor,
                             acc: Tensor = None) -> Tensor:
    """K2 with the SLR epilogue: writes ``splat_dual_normalize_slr_plain(...)``
    into ``out`` ((H, W, C1 - 2), f32 or bf16), which is then both the fluid
    decoder's input (its first C1 - 3 channels) and the alpha decoder's
    ``[gen_fs, af]``. Kernel on the card, plain version on the CPU; ``acc``
    as for ``splat_dual_normalize``."""
    return _splat_launch(kernels.SPLAT_SLR, splat_dual_normalize_slr_plain, 2,
                         u_mov, positions, valid, disp_a, disp_b, w_a, w_b,
                         u_static, out, acc)


def _splat_at(u: Tensor, positions: Tensor, disp_a: Tensor,
              disp_b: Optional[Tensor], w_a: float, w_b: float, height: int,
              width: int) -> Tensor:
    """K8 on the card: the splat of each end's rows, scaled by its weight,
    onto a zero (height, width, C) grid in ``u.dtype`` (bf16: summed in four
    corner quarters, then combined, as the plain version sums)."""
    P, C = u.shape
    named = {"u": (u, (P, C), u.dtype),
             "positions": (positions, (P, 2), torch.int32),
             "disp_a": (disp_a, (P, 2), torch.float32)}
    if disp_b is not None:
        named["disp_b"] = (disp_b, (P, 2), torch.float32)
    _check_rows(u, named)
    if u.device.type == "cpu":
        if disp_b is None:
            return softsplat_sum_at_plain(u, positions, disp_a, height, width)
        return softsplat_sum_at_quad_dual_plain(u, positions, disp_a, disp_b,
                                                w_a, w_b, height, width)
    bf16 = u.dtype == torch.bfloat16
    out = (torch.empty if bf16 else torch.zeros)((height, width, C), dtype=u.dtype,
                                                 device=u.device)
    quarters = splat_scratch(height, width, C, u.dtype, u.device) if bf16 else None
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        kernels.SPLAT_SUM_AT.launch(
            u.data_ptr(), positions.data_ptr(), disp_a.data_ptr(),
            0 if disp_b is None else disp_b.data_ptr(), float(w_a), float(w_b),
            out.data_ptr(), 0 if quarters is None else quarters.data_ptr(), P, C,
            height, width, int(bf16), stream)
    return out


def softsplat_sum_at(u: Tensor, positions: Tensor, disp: Tensor, height: int,
                     width: int) -> Tensor:
    """K8 wrapper, one end: ``softsplat_sum_at_plain``'s result, from the
    kernel (an atomic scatter in ``u``'s dtype) for tensors on the card and
    the plain version on the CPU. Also the port's ``softsplat_sum_at_paired``
    and ``softsplat_sum_at_quad``, whose row layouts are TPU scatter-row
    tricks for the same sum."""
    return _splat_at(u, positions, disp, None, 1.0, 0.0, height, width)


softsplat_sum_at_paired = softsplat_sum_at
softsplat_sum_at_quad = softsplat_sum_at


def softsplat_sum_at_quad_dual(u: Tensor, positions: Tensor, disp_a: Tensor,
                               disp_b: Tensor, w_a: float, w_b: float,
                               height: int, width: int) -> Tensor:
    """K8 wrapper, two ends (the raw K2 scatter, no epilogue):
    ``softsplat_sum_at_quad_dual_plain``'s result."""
    return _splat_at(u, positions, disp_a, disp_b, w_a, w_b, height, width)
