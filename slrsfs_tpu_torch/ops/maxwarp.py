"""Maximum-warp norm, the v2 Z-normaliser (PyTorch port of
``slrsfs_tpu/ops/splat.py:maximum_warp_norm_splat``, its two halves
``max_splat`` and ``inverse_max_gather``, and ``maximum_warp_norm_sparse``).

For every source pixel: the max of Z over the cells its bilinear splat
reaches, where a cell holds the max of ``z·w`` over everything splatted onto
it (floor −1000, reference ``softsplat.py:590``). The v2 normalisation is
then ``z − zmax``.

``maximum_warp_norm_splat`` is the dense form, used by the dense
rollouts: for one channel it is K6, ONE cooperative launch of
``csrc/maxwarp.cu``; for C > 1 it runs its two halves in turn,
``max_splat`` (K6a) and ``inverse_max_gather`` (K6b), the kernels of
``csrc/maxsplat.cu``. ``maximum_warp_norm_sparse`` is the sparse form (K5)
of the sparse rollouts, where static pixels reduce to fixed stencils and
only the moving rows scatter, one cooperative launch of ``maxwarp.cu``.
Each wrapper launches its kernel for tensors on the card and runs its
``*_plain`` version for tensors on the CPU. On the card the K5 and K6
wrappers allocate once: their outputs and the kernel's scratch max map are
views of one buffer.

The kernels take the max with ``fmaxf`` and an atomic max on the float's
bits: they agree with the plain versions up to the sign of a zero, and a
NaN input is dropped where ``torch.maximum`` keeps it. Inputs are finite.
"""

from __future__ import annotations

from typing import Tuple

import torch

from slrsfs_tpu_torch import kernels
from slrsfs_tpu_torch.ops.splat import corners

Tensor = torch.Tensor

NEG_INIT = -1000.0  # reference max-splat init (models/softsplat.py:590)
_NEG_INF = float("-inf")


def _taps(flow: Tensor, b: int):
    """The four corners of sample ``b``'s pixels moved by ``flow[b]``."""
    H, W = flow.shape[1:3]
    xs = torch.arange(W, dtype=flow.dtype, device=flow.device)[None, :]
    ys = torch.arange(H, dtype=flow.dtype, device=flow.device)[:, None]
    return corners((xs + flow[b, ..., 0]).reshape(-1),
                   (ys + flow[b, ..., 1]).reshape(-1), H, W)


def max_splat_plain(inp: Tensor, flow: Tensor) -> Tensor:
    """Plain version of K6a. inp (B, H, W, C), flow (B, H, W, 2) → (B, H,
    W, C): per target cell the max of ``inp · w`` over the in-grid corners
    that reach it; cells nothing reaches stay at −1000."""
    B, H, W, C = inp.shape
    out = []
    for b in range(B):
        f = inp[b].reshape(H * W, C)
        mx = torch.full((H * W, C), NEG_INIT, dtype=inp.dtype, device=inp.device)
        for lin, w, inside in _taps(flow, b):
            v = torch.where(inside[:, None], f * w[:, None], _NEG_INF)
            mx.scatter_reduce_(0, lin[:, None].expand(-1, C), v, reduce="amax")
        out.append(mx.reshape(H, W, C))
    return torch.stack(out)


def inverse_max_gather_plain(maxmap: Tensor, flow: Tensor, init: Tensor) -> Tensor:
    """Plain version of K6b. maxmap, init (B, H, W, C), flow (B, H, W, 2) →
    (B, H, W, C): per source pixel the max of ``init`` and ``maxmap`` at its
    in-grid corners."""
    B, H, W, C = maxmap.shape
    out = []
    for b in range(B):
        flat = maxmap[b].reshape(H * W, C)
        o = init[b].reshape(H * W, C)
        for lin, _, inside in _taps(flow, b):
            o = torch.maximum(o, torch.where(inside[:, None], flat[lin], _NEG_INF))
        out.append(o.reshape(H, W, C))
    return torch.stack(out)


def maximum_warp_norm_splat_plain(z: Tensor, flow: Tensor) -> Tensor:
    """Plain version of K6 (and of the K6a → K6b pair). z (B, H, W, C),
    flow (B, H, W, 2) → (B, H, W, C): max-splat ``z`` (init −1000;
    off-grid corners do not write), then gather the per-target maxima back
    onto each source, starting from ``z``."""
    return inverse_max_gather_plain(max_splat_plain(z, flow), flow, z)


def _shift2d(a: Tensor, dy: int, dx: int, fill: float) -> Tensor:
    """(H, W) tensor shifted so out[y, x] = a[y+dy, x+dx], ``fill`` outside."""
    H, W = a.shape
    out = torch.full_like(a, fill)
    out[max(-dy, 0):H + min(-dy, 0), max(-dx, 0):W + min(-dx, 0)] = \
        a[max(dy, 0):H + min(dy, 0), max(dx, 0):W + min(dx, 0)]
    return out


def maximum_warp_norm_sparse_plain(z: Tensor, static_mask: Tensor,
                                   z_mov: Tensor, positions: Tensor,
                                   valid: Tensor, disp: Tensor
                                   ) -> Tuple[Tensor, Tensor]:
    """Plain version of K5 → (zmax_dense (H, W), zmax_mov (P,)).

    z, static_mask (H, W) f32 (mask 1 where motion is zero); z_mov (P,),
    positions (P, 2) int [x, y], valid (P,), disp (P, 2): the moving set.
    ``zmax_dense`` is exact at static pixels and ``zmax_mov`` at the moving
    set, as in the JAX version; the moving rows are scattered straight into
    the static stencil's max map (max is exact, so the order changes no
    bit)."""
    H, W = z.shape
    is_static = static_mask > 0.5
    # static pixels: z at their own cell (w = 1), 0 at E / S / SE (w = 0)
    zero_contrib = (_shift2d(static_mask, 0, -1, 0.0)
                    + _shift2d(static_mask, -1, 0, 0.0)
                    + _shift2d(static_mask, -1, -1, 0.0)) > 0.5
    mx = torch.maximum(torch.where(is_static, z, NEG_INIT),
                       torch.where(zero_contrib, 0.0, NEG_INIT)
                       .to(z.dtype)).reshape(-1)
    taps = corners(positions[:, 0].to(disp.dtype) + disp[:, 0],
                   positions[:, 1].to(disp.dtype) + disp[:, 1], H, W)
    ok = valid > 0.5
    for lin, w, inside in taps:
        mx.scatter_reduce_(0, lin, torch.where(inside & ok, z_mov * w, _NEG_INF),
                           reduce="amax")
    mx2 = mx.reshape(H, W)
    zmax_dense = torch.maximum(z, torch.maximum(
        torch.maximum(mx2, _shift2d(mx2, 0, 1, _NEG_INF)),
        torch.maximum(_shift2d(mx2, 1, 0, _NEG_INF),
                      _shift2d(mx2, 1, 1, _NEG_INF))))
    zmax_mov = z_mov
    for lin, _, inside in taps:
        zmax_mov = torch.maximum(zmax_mov, torch.where(inside, mx[lin], _NEG_INF))
    return zmax_dense, zmax_mov


def _check(named: dict, device) -> None:
    for name, (t, shape, dtype) in named.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")


def _launch(kernel: kernels.Kernel, device: torch.device, *args) -> None:
    """Launch ``kernel`` on ``device``'s current stream. The C entries
    launch on the calling thread's current device, so the device context is
    entered only when another device is current."""
    if device.index == torch.cuda.current_device():
        kernel.launch(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(device):
            kernel.launch(*args, torch.cuda.current_stream().cuda_stream)


def _dense_inputs(named: dict, device) -> Tuple[int, int, int, int]:
    """Check the dense wrappers' (B, H, W, C) f32 tensors and their (B, H,
    W, 2) f32 ``flow``, all on ``device``; returns (B, H, W, C)."""
    first, t = next(iter(named.items()))
    if t.dim() != 4:
        raise ValueError(f"{first} must be (B, H, W, C), got {tuple(t.shape)}")
    B, H, W, C = t.shape
    f32 = torch.float32
    _check({**{k: (t, (B, H, W, C), f32) for k, t in named.items() if k != "flow"},
            "flow": (named["flow"], (B, H, W, 2), f32)}, device)
    if device.type == "cuda" and named["flow"].data_ptr() % 8:
        raise ValueError("flow must be 8-byte aligned")
    return B, H, W, C


def max_splat(inp: Tensor, flow: Tensor) -> Tensor:
    """K6a wrapper: ``max_splat_plain(inp, flow)``, inp (B, H, W, C) f32,
    flow (B, H, W, 2) f32. The CUDA kernel computes it on the card (the
    −1000 fill and the scatter, two launches of one entry), the plain
    version on the CPU."""
    B, H, W, C = _dense_inputs({"inp": inp, "flow": flow}, inp.device)
    if inp.device.type == "cpu":
        return max_splat_plain(inp, flow)
    out = torch.empty_like(inp)
    _launch(kernels.MAX_SPLAT, inp.device, inp.data_ptr(), flow.data_ptr(),
            out.data_ptr(), B, H, W, C)
    return out


def inverse_max_gather(maxmap: Tensor, flow: Tensor, init: Tensor) -> Tensor:
    """K6b wrapper: ``inverse_max_gather_plain(maxmap, flow, init)``, maxmap
    and init (B, H, W, C) f32, flow (B, H, W, 2) f32. The CUDA kernel
    computes it on the card, the plain version on the CPU."""
    B, H, W, C = _dense_inputs({"maxmap": maxmap, "init": init, "flow": flow},
                               maxmap.device)
    if maxmap.device.type == "cpu":
        return inverse_max_gather_plain(maxmap, flow, init)
    out = torch.empty_like(maxmap)
    _launch(kernels.INVERSE_MAX_GATHER, maxmap.device, maxmap.data_ptr(),
            flow.data_ptr(), init.data_ptr(), out.data_ptr(), B, H, W, C)
    return out


def maximum_warp_norm_splat(z: Tensor, flow: Tensor) -> Tensor:
    """``maximum_warp_norm_splat_plain(z, flow)``, z (B, H, W, C) f32, flow
    (B, H, W, 2) f32. On the card one channel is K6's one cooperative
    launch (the dense v2 render's form) and C > 1 runs ``max_splat`` (K6a)
    and then ``inverse_max_gather`` (K6b); the plain version on the CPU."""
    B, H, W, C = _dense_inputs({"z": z, "flow": flow}, z.device)
    if z.device.type == "cpu":
        return maximum_warp_norm_splat_plain(z, flow)
    if C > 1:
        return inverse_max_gather(max_splat(z, flow), flow, z)
    buf = torch.empty((2, B, H, W, 1), dtype=torch.float32, device=z.device)
    out = buf[0]  # buf[1] is the scratch max map
    _launch(kernels.MAXWARP_SPLAT, z.device, z.data_ptr(), flow.data_ptr(),
            buf.data_ptr() + out.nbytes, out.data_ptr(), B, H, W)
    return out


def maximum_warp_norm_sparse(z: Tensor, static_mask: Tensor, z_mov: Tensor,
                             positions: Tensor, valid: Tensor, disp: Tensor
                             ) -> Tuple[Tensor, Tensor]:
    """K5 wrapper: ``maximum_warp_norm_sparse_plain(...)``, computed by the
    CUDA kernel on the card and by the plain version on the CPU."""
    H, W = z.shape
    P = z_mov.shape[0]
    f32 = torch.float32
    _check({"z": (z, (H, W), f32), "static_mask": (static_mask, (H, W), f32),
            "z_mov": (z_mov, (P,), f32),
            "positions": (positions, (P, 2), torch.int32),
            "valid": (valid, (P,), f32), "disp": (disp, (P, 2), f32)},
           z.device)
    if z.device.type == "cpu":
        return maximum_warp_norm_sparse_plain(z, static_mask, z_mov, positions,
                                              valid, disp)
    for name, t in (("positions", positions), ("disp", disp)):
        if t.data_ptr() % 8:
            raise ValueError(f"{name} must be 8-byte aligned")
    # [zmax_dense (H, W) | scratch max map (H, W) | zmax_mov (P,)]
    buf = torch.empty((2 * H * W + P,), dtype=f32, device=z.device)
    zmax_dense = buf[:H * W].view(H, W)
    zmax_mov = buf[2 * H * W:]
    _launch(kernels.MAXWARP_SPARSE, z.device, z.data_ptr(),
            static_mask.data_ptr(), z_mov.data_ptr(), positions.data_ptr(),
            valid.data_ptr(), disp.data_ptr(),
            buf.data_ptr() + zmax_dense.nbytes, zmax_dense.data_ptr(),
            zmax_mov.data_ptr(), P, H, W)
    return zmax_dense, zmax_mov
