"""Euler integration of a constant-in-time motion field (PyTorch port of
``slrsfs_tpu/ops/euler.py``).

Starting from each pixel's own coordinate, the destination is advected by
the motion gathered at its half-to-even rounded position; a trajectory that
leaves the frame becomes invalid for good, is pinned back to its source and
reports a displacement of ``max(H, W) + 1`` so downstream splats drop it.

``euler_compact_dual`` is the main path's kernel wrapper (K1,
``csrc/euler.cu``); ``euler_compact_dual_plain`` is its plain PyTorch
version, a loop over steps on tensors. ``euler_integrate_all_dual`` is the
dense form, used only by the plain dense rollout.
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
