"""Plain versions of the port's kernels, frozen for the benchmark's
reference: the Euler integrators (K1's render form and K7's training form),
the dense summation splat (K3, differentiated by autograd) and the
two-ended moving-row splat with its normalisation (K2). Plain PyTorch,
no kernels; copied from ``slrsfs_tpu_torch/ops/{euler,splat}.py``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

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
    JAX ``_splat_sum_single`` does. Differentiable in both by autograd
    (``floor`` carries no gradient, so the weights' is the bilinear one)."""
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


# the training pass's splat: autograd through the plain forward
softsplat_sum_plain_vjp = softsplat_sum_plain


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


def _scan_plain(motion: Tensor, coord: Tensor, sign: Tensor, n_steps: int
                ) -> Tuple[Tensor, Tensor]:
    """Steps 1..n_steps of the JAX scan body for rows ``coord`` (R, 2) f32
    [x, y], each adding the gathered motion times ``sign`` (R, 1), ±1 (an
    exact product). Returns (disps (n_steps, R, 2), visible (n_steps, R)
    bool)."""
    H, W, _ = motion.shape
    oob = torch.full_like(coord, float(max(H, W) + 1))
    motion_flat = motion.reshape(H * W, 2)
    dest = coord
    invalid = torch.zeros(coord.shape[:1], dtype=torch.bool, device=motion.device)
    disps, visible = [], []
    for _ in range(n_steps):
        ix = torch.round(dest[:, 0]).to(torch.int64).clamp(0, W - 1)
        iy = torch.round(dest[:, 1]).to(torch.int64).clamp(0, H - 1)
        m = motion_flat[iy * W + ix] * sign
        dest = dest + m
        out = ((dest[:, 0] > W - 1) | (dest[:, 0] < 0)
               | (dest[:, 1] > H - 1) | (dest[:, 1] < 0))
        invalid = invalid | out
        dest = torch.where(invalid[:, None], coord, dest)
        disps.append(torch.where(invalid[:, None], oob, dest - coord))
        visible.append(~invalid)
    if not disps:
        return (coord.new_zeros((0,) + tuple(coord.shape)),
                torch.zeros((0,) + tuple(coord.shape[:1]), dtype=torch.bool,
                            device=motion.device))
    return torch.stack(disps), torch.stack(visible)


def _grid(H: int, W: int, device) -> Tensor:
    """(H·W, 2) int32 [x, y] of every pixel, row-major."""
    ys, xs = torch.meshgrid(torch.arange(H, device=device),
                            torch.arange(W, device=device), indexing="ij")
    return torch.stack([xs, ys], dim=-1).reshape(H * W, 2).to(torch.int32)


def euler_compact_dual_plain(motion: Tensor, positions: Tensor, n_fwd: int,
                             n_bwd: int) -> Tuple[Tensor, Tensor]:
    """Both directions (M and -M) of P trajectories.

    motion (H, W, 2) f32; positions (P, 2) int [x, y]. Returns
    (disp_fwd (n_fwd+1, P, 2), disp_bwd (n_bwd+1, P, 2)); entry 0 is zero.
    Element for element the JAX ``euler_integrate_compact_dual``.
    """
    dtype = motion.dtype
    P = positions.shape[0]
    coord = torch.cat([positions, positions]).to(dtype)  # (2P, 2)
    sign = torch.cat([torch.ones((P, 1), dtype=dtype, device=motion.device),
                      -torch.ones((P, 1), dtype=dtype, device=motion.device)])
    stack, _ = _scan_plain(motion, coord, sign, max(n_fwd, n_bwd))
    zero = torch.zeros((1, P, 2), dtype=dtype, device=motion.device)
    disp_f = torch.cat([zero, stack[:n_fwd, :P]])
    disp_b = torch.cat([zero, stack[:n_bwd, P:]])
    return disp_f, disp_b


def _phased_scan(motion: Tensor, coord: Tensor, t_fwd: Tensor,
                 t_bwd: Tensor, n_steps: int) -> Tuple[Tensor, Tensor]:
    """The phase-switched scan over rows ``coord`` (B, R, 2) f32 [x, y] of
    each sample: step for step the JAX scan body (``euler.py:273-299``),
    with the batch written out instead of vmapped. Returns the latched
    (out_f, out_p), each (B, R, 2)."""
    B, H, W, _ = motion.shape
    dtype = motion.dtype
    oob = torch.tensor(float(max(H, W) + 1), dtype=dtype, device=motion.device)
    motion_flat = motion.reshape(B, H * W, 2)
    tf = t_fwd.to(torch.int64)[:, None]  # (B, 1)
    tp = t_bwd.to(torch.int64)[:, None]
    one = torch.ones((), dtype=dtype, device=motion.device)
    dest = coord
    invalid = torch.zeros(coord.shape[:2], dtype=torch.bool, device=motion.device)
    out_f = torch.zeros_like(coord)
    out_p = torch.zeros_like(coord)
    for k in range(1, n_steps + 1):
        reset = k == tf + 1
        dest = torch.where(reset[..., None], coord, dest)
        invalid = torch.where(reset, False, invalid)
        sign = torch.where(k <= tf, one, -one)[..., None]  # (B, 1, 1)
        ix = torch.round(dest[..., 0]).to(torch.int64).clamp(0, W - 1)
        iy = torch.round(dest[..., 1]).to(torch.int64).clamp(0, H - 1)
        m = torch.gather(motion_flat, 1, (iy * W + ix)[..., None].expand(-1, -1, 2))
        dest = dest + m * sign
        out = ((dest[..., 0] > W - 1) | (dest[..., 0] < 0)
               | (dest[..., 1] > H - 1) | (dest[..., 1] < 0))
        invalid = invalid | out
        dest = torch.where(invalid[..., None], coord, dest)
        disp = torch.where(invalid[..., None], oob, dest - coord)
        out_f = torch.where((k == tf)[..., None], disp, out_f)
        out_p = torch.where(((k == tf + tp) & (tp > 0))[..., None], disp, out_p)
    return out_f, out_p


def euler_integrate_phased_plain(motion: Tensor, t_fwd: Tensor, t_bwd: Tensor,
                                 n_steps: int) -> Tuple[Tensor, Tensor]:
    """Plain version of dense K7: the JAX ``euler_integrate_phased`` for
    each sample. motion (B, H, W, 2) f32; t_fwd, t_bwd (B,) int with
    t_fwd + t_bwd <= n_steps. Returns (disp_fwd, disp_bwd), each
    (B, H, W, 2): the displacement after t_fwd steps of +M and after t_bwd
    steps of -M (zero where the count is 0)."""
    B, H, W, _ = motion.shape
    ys, xs = torch.meshgrid(torch.arange(H, device=motion.device),
                            torch.arange(W, device=motion.device),
                            indexing="ij")
    coord = torch.stack([xs, ys], dim=-1).reshape(1, H * W, 2).to(motion.dtype)
    out_f, out_p = _phased_scan(motion, coord.expand(B, -1, -1), t_fwd, t_bwd,
                                n_steps)
    return out_f.reshape(B, H, W, 2), out_p.reshape(B, H, W, 2)


def euler_integrate_phased_compact_plain(motion: Tensor, positions: Tensor,
                                         valid: Tensor, t_fwd: Tensor,
                                         t_bwd: Tensor, n_steps: int
                                         ) -> Tuple[Tensor, Tensor]:
    """Plain version of compact K7: the JAX ``euler_integrate_phased_compact``
    for each sample. positions (B, P, 2) int32 [x, y], the moving set padded
    with ``valid`` (B, P) f32 = 0. The rows' results, times ``valid``, are
    added onto a zero (B, H, W, 2) grid at their source pixels."""
    B, H, W, _ = motion.shape
    out_f, out_p = _phased_scan(motion, positions.to(motion.dtype), t_fwd,
                                t_bwd, n_steps)
    cell = (torch.arange(B, device=motion.device)[:, None] * (H * W)
            + positions[..., 1].to(torch.int64) * W
            + positions[..., 0].to(torch.int64)).reshape(-1)
    v = valid.to(motion.dtype)[..., None]
    grids = []
    for out in (out_f, out_p):
        grid = torch.zeros((B * H * W, 2), dtype=motion.dtype, device=motion.device)
        grid.index_put_((cell,), (out * v).reshape(-1, 2), accumulate=True)
        grids.append(grid.reshape(B, H, W, 2))
    return grids[0], grids[1]
