"""Maximum-warp norm, the v2 Z-normaliser (PyTorch port of
``slrsfs_tpu/ops/splat.py:maximum_warp_norm_splat`` and
``maximum_warp_norm_sparse``).

For every source pixel: the max of Z over the cells its bilinear splat
reaches, where a cell holds the max of ``z·w`` over everything splatted onto
it (floor −1000, reference ``softsplat.py:590``). The v2 normalisation is
then ``z − zmax``.

``maximum_warp_norm_splat`` is the dense form (K6), used by the dense
rollouts; ``maximum_warp_norm_sparse`` is the sparse form (K5) of the
sparse rollouts, where static pixels reduce to fixed stencils and only the
moving rows scatter. Both kernels live in ``csrc/maxwarp.cu``, one
cooperative launch each. Each wrapper launches its kernel for tensors on
the card and runs its ``*_plain`` version for tensors on the CPU. On the
card a wrapper allocates once: its outputs and the kernel's scratch max
map are views of one buffer.
"""

from __future__ import annotations

from typing import Tuple

import torch

from slrsfs_tpu_torch import kernels
from slrsfs_tpu_torch.ops.splat import corners

Tensor = torch.Tensor

NEG_INIT = -1000.0  # reference max-splat init (models/softsplat.py:590)
_NEG_INF = float("-inf")


def maximum_warp_norm_splat_plain(z: Tensor, flow: Tensor) -> Tensor:
    """Plain version of K6. z (B, H, W, C), flow (B, H, W, 2) → (B, H, W, C).

    Max-splat ``z`` (init −1000; off-grid corners do not write), then gather
    the per-target maxima back onto each source, starting from ``z``."""
    B, H, W, C = z.shape
    xs = torch.arange(W, dtype=flow.dtype, device=flow.device)[None, :]
    ys = torch.arange(H, dtype=flow.dtype, device=flow.device)[:, None]
    out = []
    for b in range(B):
        taps = corners((xs + flow[b, ..., 0]).reshape(-1),
                       (ys + flow[b, ..., 1]).reshape(-1), H, W)
        zf = z[b].reshape(H * W, C)
        mx = torch.full((H * W, C), NEG_INIT, dtype=z.dtype, device=z.device)
        for lin, w, inside in taps:
            v = torch.where(inside[:, None], zf * w[:, None], _NEG_INF)
            mx.scatter_reduce_(0, lin[:, None].expand(-1, C), v, reduce="amax")
        o = zf
        for lin, _, inside in taps:
            o = torch.maximum(o, torch.where(inside[:, None], mx[lin], _NEG_INF))
        out.append(o.reshape(H, W, C))
    return torch.stack(out)


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


def maximum_warp_norm_splat(z: Tensor, flow: Tensor) -> Tensor:
    """K6 wrapper: ``maximum_warp_norm_splat_plain(z, flow)`` for one
    channel, z (B, H, W, 1) f32, flow (B, H, W, 2) f32. The CUDA kernel
    computes it on the card, the plain version on the CPU."""
    B, H, W = z.shape[:3]
    f32 = torch.float32
    _check({"z": (z, (B, H, W, 1), f32), "flow": (flow, (B, H, W, 2), f32)},
           z.device)
    if z.device.type == "cpu":
        return maximum_warp_norm_splat_plain(z, flow)
    if flow.data_ptr() % 8:
        raise ValueError("flow must be 8-byte aligned")
    buf = torch.empty((2, B, H, W, 1), dtype=f32, device=z.device)
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
