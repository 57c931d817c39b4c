"""Inference rollouts of the baseline model (PyTorch port of
``slrsfs_tpu/engine/rollout.py``, baseline path without crop decode).

Frame math follows reference ``forward_flow`` with the standard inference
indexing ``[0, t, N-1]``: forward displacement = t steps of M, backward =
N-t steps of -M, α = 1 - t/N, and the start features feed both splat ends.

``baseline_rollout_sparse`` is the main path: it splats only the moving
pixels (static pixels splat onto themselves, an identity added densely) with
kernels K1 and K2 and decodes in frame batches. ``baseline_rollout`` is the
dense form on plain ops, kept to check the sparse path.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Optional

import numpy as np
import torch

from slrsfs_tpu_torch.models.baseline import (
    BaselineModel,
    pack_splat_input,
    splat_blend,
    z_for_splat,
    z_normalize,
)
from slrsfs_tpu_torch.ops.euler import (
    euler_compact_dual,
    euler_compact_dual_plain,
    euler_integrate_all_dual,
)
from slrsfs_tpu_torch.ops.splat import (
    splat_dual_normalize,
    splat_dual_normalize_plain,
)

Tensor = torch.Tensor


def _auto_decode_batch(n_frames: int, decode_batch: Optional[int]) -> int:
    """Largest divisor of n_frames ≤ 20 unless explicitly given."""
    if decode_batch is not None:
        if n_frames % decode_batch:
            raise ValueError(f"decode_batch {decode_batch} does not divide "
                             f"{n_frames} frames")
        return decode_batch
    db = min(n_frames, 20)
    while n_frames % db:
        db -= 1
    return db


def _alphas(t: int, n: int):
    """(α, 1-α) of frame t in float32 arithmetic, as the JAX rollout forms
    them (1 - t/N)."""
    a = np.float32(1.0) - np.float32(t) / np.float32(n)
    return a, np.float32(1.0) - a


@contextlib.contextmanager
def _fp32_convs(dtype: torch.dtype):
    """Keep float32 convolutions in float32: cuDNN runs them in TF32 by
    default, which keeps about three decimal digits."""
    if dtype != torch.float32:
        yield
        return
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


@torch.no_grad()
def baseline_rollout(model: BaselineModel, img: Tensor, flow: Tensor,
                     n_frames: int, decode_batch: Optional[int] = None) -> Tensor:
    """Dense rollout on plain ops, float32. img (1, H, W, 3) normalised as
    trained; flow (H, W, 2) in output pixels. Returns (N, H, W, 3) in [-1, 1]."""
    opt = model.opt
    N = n_frames
    with _fp32_convs(torch.float32):
        fs, z = model.encode(img)
        z = z_for_splat(opt, fs, z)
        disp_f, disp_p = euler_integrate_all_dual(flow, N - 1, N)
        u = pack_splat_input(fs, z_normalize(opt, z))
        gen = []
        for t in range(N):
            a, _ = _alphas(t, N)
            alpha = torch.tensor(a, dtype=torch.float32, device=flow.device)
            gen.append(splat_blend(u, disp_f[t][None], alpha, u,
                                   disp_p[N - t][None])[0])
        gen_all = torch.stack(gen)
        db = _auto_decode_batch(N, decode_batch)
        return torch.cat([model.decode(gen_all[i:i + db])
                          for i in range(0, N, db)])


def cast_for_compute(model: BaselineModel, dtype: torch.dtype) -> BaselineModel:
    """The model with float parameters and buffers in ``dtype`` (a cast copy
    unless it already is), as the JAX ``_cast_for_compute`` casts variables."""
    if next(model.parameters()).dtype == dtype:
        return model
    return copy.deepcopy(model).to(dtype)


def prepare_scene_sparse(flow_np, pad_multiple: int = 1024,
                         bucket_ratio: float = None):
    """Host-side: indices of moving pixels, padded to a multiple of
    ``pad_multiple`` (or onto the geometric series of ``geometric_bucket``).

    flow_np (H, W, 2). Returns (positions (P, 2) int32 [x, y], valid (P,)
    float32)."""
    flow_np = np.asarray(flow_np)
    moving = np.any(flow_np != 0.0, axis=-1)
    ys, xs = np.nonzero(moving)
    n = len(xs)
    P = max(pad_multiple, -(-n // pad_multiple) * pad_multiple)
    if bucket_ratio is not None and bucket_ratio > 1.0:
        P = geometric_bucket(n, pad_multiple, bucket_ratio, moving.size)
    positions = np.zeros((P, 2), np.int32)
    positions[:n, 0] = xs
    positions[:n, 1] = ys
    valid = np.zeros((P,), np.float32)
    valid[:n] = 1.0
    return positions, valid


def geometric_bucket(n: int, pad_multiple: int, bucket_ratio: float,
                     cap: int) -> int:
    """Round ``n`` up onto the series {pad_multiple·⌈ratio^k⌉} capped at
    ``cap``, so a sweep sees a bounded set of moving-set sizes."""
    target = max(pad_multiple, -(-n // pad_multiple) * pad_multiple)
    cap = max(pad_multiple, -(-cap // pad_multiple) * pad_multiple)
    b = pad_multiple
    while b < min(target, cap):
        # max(..., b + pad_multiple) forces progress for ratios close to 1
        b = min(cap, max(b + pad_multiple,
                         -(-int(b * bucket_ratio) // pad_multiple)
                         * pad_multiple))
    return b


@torch.no_grad()
def baseline_rollout_sparse(model: BaselineModel, img: Tensor, flow: Tensor,
                            n_frames: int, positions: Tensor, valid: Tensor,
                            decode_batch: int = 6,
                            compute_dtype: torch.dtype = torch.float32,
                            plain: bool = False) -> Tensor:
    """Sparse-splat, frame-batched-decode rollout; equal to
    ``baseline_rollout`` when the static pixels have exactly zero motion.

    img (1, H, W, 3); flow (H, W, 2) f32; positions (P, 2) int32 / valid (P,)
    f32 from ``prepare_scene_sparse``, on the model's device.
    ``compute_dtype`` bfloat16 runs encoder and decoder in bf16 while the
    splat accumulates in f32. ``plain`` runs K1 and K2's plain PyTorch
    versions instead of the kernels (to check the kernels on the card).
    Returns (N, H, W, 3) float32 in [-1, 1].
    """
    opt = model.opt
    N = n_frames
    if N % decode_batch:
        raise ValueError(f"decode_batch {decode_batch} does not divide {N} frames")
    H, W = flow.shape[0], flow.shape[1]
    dev = flow.device
    f32 = torch.float32

    with _fp32_convs(compute_dtype):
        model = cast_for_compute(model, compute_dtype)
        fs, z = model.encode(img.to(compute_dtype))
        z = z_for_splat(opt, fs, z)

        px, py = positions[:, 0].long(), positions[:, 1].long()
        moving = torch.zeros(H * W, dtype=f32, device=dev).scatter_reduce_(
            0, py * W + px, valid, reduce="amax")
        static_mask = 1.0 - moving.reshape(H, W)

        # non-v2 Z-norm: the packed rows are frame-constant. The static
        # identity is α·U + (1-α)·U = U on static pixels.
        u = pack_splat_input(fs, z_normalize(opt, z))[0]  # (H, W, C+1)
        u_static = (u * static_mask[..., None]).to(f32).contiguous()
        u_mov = (u[py, px] * valid[:, None]).to(f32).contiguous()
        C = u.shape[-1] - 1

        integrate = euler_compact_dual_plain if plain else euler_compact_dual
        disp_f, disp_p = integrate(flow, positions, N - 1, N)

        frames = torch.empty((N, H, W, 3), dtype=f32, device=dev)
        chunk = torch.empty((decode_batch, H, W, C), dtype=compute_dtype,
                            device=dev)
        acc = torch.empty((H * W * (C + 1),), dtype=f32, device=dev)
        for c0 in range(0, N, decode_batch):
            for j in range(decode_batch):
                t = c0 + j
                a, b = _alphas(t, N)
                if plain:
                    chunk[j] = splat_dual_normalize_plain(
                        u_mov, positions, valid, disp_f[t], disp_p[N - t],
                        float(a), float(b), u_static, compute_dtype)
                else:
                    splat_dual_normalize(u_mov, positions, valid, disp_f[t],
                                         disp_p[N - t], float(a), float(b),
                                         u_static, out=chunk[j], acc=acc)
            frames[c0:c0 + decode_batch] = model.decode(chunk)
        return frames
