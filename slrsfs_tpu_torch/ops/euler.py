"""Euler integration of a constant-in-time motion field (PyTorch port of
``slrsfs_tpu/ops/euler.py``).

Starting from each pixel's own coordinate, the destination is advected by
the motion gathered at its half-to-even rounded position; a trajectory that
leaves the frame becomes invalid for good, is pinned back to its source and
reports a displacement of ``max(H, W) + 1`` so downstream splats drop it.

``euler_compact_dual`` is the render path's kernel wrapper (K1,
``csrc/euler.cu``); ``euler_compact_dual_plain`` is its plain PyTorch
version, a loop over steps on tensors. ``euler_integrate_all_dual`` is the
dense form, used only by the plain dense rollout.

``euler_integrate_phased`` and ``euler_integrate_phased_compact`` are the
training pass's integrators (K7, ``csrc/euler_phased.cu``), batched over
samples with per-sample step counts; ``*_plain`` are their plain versions.
"""

from __future__ import annotations

from typing import Tuple

import torch

from slrsfs_tpu_torch import kernels

Tensor = torch.Tensor


def euler_compact_dual_plain(motion: Tensor, positions: Tensor, n_fwd: int,
                             n_bwd: int) -> Tuple[Tensor, Tensor]:
    """Both directions (M and -M) of P trajectories.

    motion (H, W, 2) f32; positions (P, 2) int [x, y]. Returns
    (disp_fwd (n_fwd+1, P, 2), disp_bwd (n_bwd+1, P, 2)); entry 0 is zero.
    Element for element the JAX ``euler_integrate_compact_dual``.
    """
    H, W, _ = motion.shape
    dtype = motion.dtype
    P = positions.shape[0]
    coord = torch.cat([positions, positions]).to(dtype)  # (2P, 2)
    sign = torch.cat([torch.ones((P, 1), dtype=dtype, device=motion.device),
                      -torch.ones((P, 1), dtype=dtype, device=motion.device)])
    oob = torch.full_like(coord, float(max(H, W) + 1))
    motion_flat = motion.reshape(H * W, 2)
    L = max(n_fwd, n_bwd)

    dest = coord
    invalid = torch.zeros((2 * P,), dtype=torch.bool, device=motion.device)
    disps = []
    for _ in range(L):
        ix = torch.round(dest[:, 0]).to(torch.int64).clamp(0, W - 1)
        iy = torch.round(dest[:, 1]).to(torch.int64).clamp(0, H - 1)
        m = motion_flat[iy * W + ix] * sign
        dest = dest + m
        out = ((dest[:, 0] > W - 1) | (dest[:, 0] < 0)
               | (dest[:, 1] > H - 1) | (dest[:, 1] < 0))
        invalid = invalid | out
        dest = torch.where(invalid[:, None], coord, dest)
        disps.append(torch.where(invalid[:, None], oob, dest - coord))
    zero = torch.zeros((1, P, 2), dtype=dtype, device=motion.device)
    stack = (torch.stack(disps) if disps
             else torch.zeros((0, 2 * P, 2), dtype=dtype, device=motion.device))
    disp_f = torch.cat([zero, stack[:n_fwd, :P]])
    disp_b = torch.cat([zero, stack[:n_bwd, P:]])
    return disp_f, disp_b


def _check(motion: Tensor, positions: Tensor, n_fwd: int, n_bwd: int) -> None:
    if motion.ndim != 3 or motion.shape[-1] != 2:
        raise ValueError(f"motion must be (H, W, 2), got {tuple(motion.shape)}")
    if positions.ndim != 2 or positions.shape[-1] != 2:
        raise ValueError(
            f"positions must be (P, 2), got {tuple(positions.shape)}")
    if motion.dtype != torch.float32:
        raise TypeError(f"motion must be float32, got {motion.dtype}")
    if positions.dtype != torch.int32:
        raise TypeError(f"positions must be int32, got {positions.dtype}")
    if motion.device != positions.device:
        raise ValueError("motion and positions are on different devices")
    if n_fwd < 0 or n_bwd < 0:
        raise ValueError(f"negative step counts {n_fwd}, {n_bwd}")
    for name, t in (("motion", motion), ("positions", positions)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def euler_compact_dual(motion: Tensor, positions: Tensor, n_fwd: int,
                       n_bwd: int) -> Tuple[Tensor, Tensor]:
    """K1 wrapper: ``euler_compact_dual_plain``'s result, computed by the
    CUDA kernel for tensors on the card and by the plain version for tensors
    on the CPU."""
    _check(motion, positions, n_fwd, n_bwd)
    if motion.device.type == "cpu":
        return euler_compact_dual_plain(motion, positions, n_fwd, n_bwd)
    if motion.device.type != "cuda":
        raise ValueError(f"unsupported device {motion.device}")
    for name, t in (("motion", motion), ("positions", positions)):
        if t.data_ptr() % 8:
            raise ValueError(f"{name} must be 8-byte aligned")
    H, W, _ = motion.shape
    P = positions.shape[0]
    disp_f = torch.empty((n_fwd + 1, P, 2), dtype=torch.float32,
                         device=motion.device)
    disp_b = torch.empty((n_bwd + 1, P, 2), dtype=torch.float32,
                         device=motion.device)
    with torch.cuda.device(motion.device):
        stream = torch.cuda.current_stream().cuda_stream
        kernels.EULER.launch(motion.data_ptr(), positions.data_ptr(),
                             disp_f.data_ptr(), disp_b.data_ptr(), P, H, W,
                             n_fwd, n_bwd, stream)
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


def _check_phased(motion: Tensor, t_fwd: Tensor, t_bwd: Tensor,
                  n_steps: int) -> None:
    if motion.ndim != 4 or motion.shape[-1] != 2:
        raise ValueError(f"motion must be (B, H, W, 2), got {tuple(motion.shape)}")
    if motion.dtype != torch.float32:
        raise TypeError(f"motion must be float32, got {motion.dtype}")
    B = motion.shape[0]
    for name, t in (("t_fwd", t_fwd), ("t_bwd", t_bwd)):
        if tuple(t.shape) != (B,) or t.dtype != torch.int32:
            raise ValueError(f"{name} must be ({B},) int32, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != motion.device:
            raise ValueError(f"{name} is on {t.device}, motion on {motion.device}")
    if n_steps < 0:
        raise ValueError(f"negative n_steps {n_steps}")
    if not motion.is_contiguous():
        raise ValueError("motion must be contiguous")


def _launch_phased(motion, positions, valid, t_fwd, t_bwd, n_steps, R):
    B, H, W, _ = motion.shape
    named = dict(motion=motion, t_fwd=t_fwd, t_bwd=t_bwd)
    if positions is not None:
        named.update(positions=positions, valid=valid)
    for name, t in named.items():
        if not t.is_contiguous() or t.data_ptr() % 8:
            raise ValueError(f"{name} must be contiguous and 8-byte aligned")
    alloc = torch.empty if positions is None else torch.zeros
    out_f = alloc((B, H, W, 2), dtype=torch.float32, device=motion.device)
    out_p = alloc((B, H, W, 2), dtype=torch.float32, device=motion.device)
    with torch.cuda.device(motion.device):
        stream = torch.cuda.current_stream().cuda_stream
        kernels.EULER_PHASED.launch(
            motion.data_ptr(), 0 if positions is None else positions.data_ptr(),
            0 if valid is None else valid.data_ptr(), t_fwd.data_ptr(),
            t_bwd.data_ptr(), out_f.data_ptr(), out_p.data_ptr(), B, R, H, W,
            n_steps, stream)
    return out_f, out_p


def euler_integrate_phased(motion: Tensor, t_fwd: Tensor, t_bwd: Tensor,
                           n_steps: int) -> Tuple[Tensor, Tensor]:
    """K7 wrapper, dense: ``euler_integrate_phased_plain``'s result, from
    the CUDA kernel for tensors on the card and from the plain version for
    tensors on the CPU."""
    _check_phased(motion, t_fwd, t_bwd, n_steps)
    if motion.device.type == "cpu":
        return euler_integrate_phased_plain(motion, t_fwd, t_bwd, n_steps)
    if motion.device.type != "cuda":
        raise ValueError(f"unsupported device {motion.device}")
    B, H, W, _ = motion.shape
    return _launch_phased(motion, None, None, t_fwd, t_bwd, n_steps, H * W)


def euler_integrate_phased_compact(motion: Tensor, positions: Tensor,
                                   valid: Tensor, t_fwd: Tensor, t_bwd: Tensor,
                                   n_steps: int) -> Tuple[Tensor, Tensor]:
    """K7 wrapper, compact: ``euler_integrate_phased_compact_plain``'s
    result, from the kernel on the card and the plain version on the CPU."""
    _check_phased(motion, t_fwd, t_bwd, n_steps)
    B = motion.shape[0]
    if positions.ndim != 3 or positions.shape[0] != B or positions.shape[-1] != 2 \
            or positions.dtype != torch.int32:
        raise ValueError(f"positions must be (B, P, 2) int32, got "
                         f"{tuple(positions.shape)} {positions.dtype}")
    if tuple(valid.shape) != tuple(positions.shape[:2]) \
            or valid.dtype != torch.float32:
        raise ValueError(f"valid must be {tuple(positions.shape[:2])} float32")
    for name, t in (("positions", positions), ("valid", valid)):
        if t.device != motion.device:
            raise ValueError(f"{name} is on {t.device}, motion on {motion.device}")
    if motion.device.type == "cpu":
        return euler_integrate_phased_compact_plain(motion, positions, valid,
                                                    t_fwd, t_bwd, n_steps)
    if motion.device.type != "cuda":
        raise ValueError(f"unsupported device {motion.device}")
    return _launch_phased(motion, positions, valid, t_fwd, t_bwd, n_steps,
                          positions.shape[1])


def euler_integrate_all_dual(motion: Tensor, n_fwd: int, n_bwd: int
                             ) -> Tuple[Tensor, Tensor]:
    """Dense form: every pixel's trajectory, both directions (plain).

    Returns (disp_fwd (n_fwd+1, H, W, 2), disp_bwd (n_bwd+1, H, W, 2)),
    element for element the JAX ``euler_integrate_all_dual``."""
    H, W, _ = motion.shape
    ys, xs = torch.meshgrid(torch.arange(H, device=motion.device),
                            torch.arange(W, device=motion.device),
                            indexing="ij")
    grid = torch.stack([xs, ys], dim=-1).reshape(H * W, 2)
    disp_f, disp_b = euler_compact_dual_plain(motion, grid, n_fwd, n_bwd)
    return (disp_f.reshape(n_fwd + 1, H, W, 2),
            disp_b.reshape(n_bwd + 1, H, W, 2))
