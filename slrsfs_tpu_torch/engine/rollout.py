"""Inference rollouts of the baseline and SLR models (PyTorch port of
``slrsfs_tpu/engine/rollout.py`` without crop decode).

Frame math follows reference ``forward_flow`` with the standard inference
indexing ``[0, t, N-1]``: forward displacement = t steps of M, backward =
N-t steps of -M, α = 1 - t/N (clamped to [1/600, 599/600] for SLR), and the
start features feed both splat ends. The v2 Z-norm is recomputed per frame
from the forward displacement and feeds both ends.

``baseline_rollout_sparse`` and ``slr_rollout_sparse`` are the main paths:
they splat only the moving pixels (static pixels splat onto themselves, an
identity added densely) with kernels K1 and K2 (K5 for v2), accumulating
in float32 or, with ``splat_dtype`` bfloat16, in bf16, and decode in frame
batches. ``baseline_rollout`` (the repository's ``entry()`` path) and
``slr_rollout_dense`` are the dense forms, every pixel splatted: K4
integrates, K3's forward splats (K6 for v2), and they check the sparse
paths. Every rollout's ``plain`` runs the kernels' plain versions instead.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from slrsfs_tpu_torch.engine.init_utils import no_tf32
from slrsfs_tpu_torch.models.baseline import (
    BaselineModel,
    pack_splat_input,
    splat_blend,
    z_for_splat,
    z_normalize,
)
from slrsfs_tpu_torch.models.slr import (
    ALPHA_MAX,
    ALPHA_MIN,
    SLRModel,
    slr_composite,
    slr_pack_splat_input,
    slr_unpack_splatted,
)
from slrsfs_tpu_torch.ops.euler import (
    euler_compact_dual,
    euler_compact_dual_plain,
    euler_integrate_all_dual,
    euler_integrate_all_dual_plain,
)
from slrsfs_tpu_torch.ops.maxwarp import (
    maximum_warp_norm_sparse,
    maximum_warp_norm_sparse_plain,
)
from slrsfs_tpu_torch.ops.splat import (
    softsplat_sum,
    softsplat_sum_plain,
    splat_dual_normalize,
    splat_dual_normalize_plain,
    splat_dual_normalize_slr,
    splat_dual_normalize_slr_plain,
    splat_scratch,
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


def _alphas(t: int, n: int, slr: bool = False):
    """(α, 1-α) of frame t in float32 arithmetic, as the JAX rollouts form
    them (1 - t/N, clamped to [1/600, 599/600] for SLR)."""
    a = np.float32(1.0) - np.float32(t) / np.float32(n)
    if slr:
        a = np.clip(a, np.float32(ALPHA_MIN), np.float32(ALPHA_MAX))
    return a, np.float32(1.0) - a


def _fp32_convs(dtype: torch.dtype):
    """Keep float32 convolutions in float32 (``no_tf32``) when computing in
    float32."""
    return no_tf32() if dtype == torch.float32 else contextlib.nullcontext()


@torch.no_grad()
def baseline_rollout(model: BaselineModel, img: Tensor, flow: Tensor,
                     n_frames: int, decode_batch: Optional[int] = None,
                     plain: bool = False) -> Tensor:
    """Dense rollout, float32: K4 integrates every pixel, two K3 forwards
    splat each frame. img (1, H, W, 3) normalised as trained; flow (H, W,
    2) f32 in output pixels. ``plain`` runs their plain versions. Returns
    (N, H, W, 3) in [-1, 1]."""
    opt = model.opt
    N = n_frames
    integrate = euler_integrate_all_dual_plain if plain else euler_integrate_all_dual
    with _fp32_convs(torch.float32):
        fs, z = model.encode(img)
        z = z_for_splat(opt, fs, z)
        disp_f, disp_p = integrate(flow, N - 1, N)
        if not opt.use_softmax_splatter_v2:
            u = pack_splat_input(fs, z_normalize(opt, z))
        gen = []
        for t in range(N):
            a, _ = _alphas(t, N)
            alpha = torch.tensor(a, dtype=torch.float32, device=flow.device)
            if opt.use_softmax_splatter_v2:
                # one Z-norm, from the forward displacement, for both ends
                u = pack_splat_input(fs, z_normalize(opt, z, disp_f[t][None]))
            gen.append(splat_blend(u, disp_f[t][None], alpha, u,
                                   disp_p[N - t][None], plain=plain)[0])
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


def _static_mask(positions: Tensor, valid: Tensor, height: int,
                 width: int) -> Tensor:
    """(H, W) f32, 1 where no moving row sits."""
    px, py = positions[:, 0].long(), positions[:, 1].long()
    moving = torch.zeros(height * width, dtype=torch.float32,
                         device=valid.device).scatter_reduce_(
        0, py * width + px, valid, reduce="amax")
    return 1.0 - moving.reshape(height, width)


def _v2_z(z: Tensor, positions: Tensor):
    """(z2d (H, W) f32, z_mov (P,) f32) for the sparse maximum-warp norm."""
    z2d = z[0, ..., 0].to(torch.float32).contiguous()
    return z2d, z2d[positions[:, 1].long(), positions[:, 0].long()].contiguous()


def _v2_zn(opt, z2d, z_mov, static_mask, positions, valid, t_disp, plain):
    """Per-frame sparse v2 Z-norm → (zn_dense (H, W), zn_mov (P,))."""
    maxwarp = maximum_warp_norm_sparse_plain if plain else maximum_warp_norm_sparse
    zmax_d, zmax_m = maxwarp(z2d, static_mask, z_mov, positions, valid,
                             t_disp)
    zn_d = z2d - zmax_d
    zn_m = z_mov - zmax_m
    if not opt.no_clamp_Z:
        zn_d = zn_d.clamp(-20.0, 20.0)
        zn_m = zn_m.clamp(-20.0, 20.0)
    return zn_d, zn_m


def _baseline_pack_fn(opt, fs, z, positions, valid, static_mask, plain,
                      splat_dtype=torch.float32):
    """``pack(t_disp) -> (u_static (H, W, C+1), u_mov (P, C+1))`` in
    ``splat_dtype``, contiguous. Frame-constant without v2; with v2 the
    per-frame sparse maximum-warp norm (K5, or its plain version) rescales
    cached rows (JAX ``_baseline_pack_fn``)."""
    px, py = positions[:, 0].long(), positions[:, 1].long()
    f32 = torch.float32
    if not opt.use_softmax_splatter_v2:
        # the static identity is α·U + (1-α)·U = U on static pixels
        u = pack_splat_input(fs, z_normalize(opt, z))[0]  # (H, W, C+1)
        u_static = (u * static_mask[..., None]).to(splat_dtype).contiguous()
        u_mov = (u[py, px] * valid[:, None]).to(splat_dtype).contiguous()
        return lambda t_disp: (u_static, u_mov)

    z2d, z_mov = _v2_z(z, positions)
    fs_static = fs[0].to(f32) * static_mask[..., None]
    fs_mov = fs[0][py, px].to(f32) * valid[:, None]

    def pack(t_disp):
        zn_d, zn_m = _v2_zn(opt, z2d, z_mov, static_mask, positions, valid,
                            t_disp, plain)
        e_d = (torch.exp(zn_d) * static_mask)[..., None]
        e_m = (torch.exp(zn_m) * valid)[:, None]
        return (torch.cat([fs_static * e_d, e_d], dim=-1).to(splat_dtype),
                torch.cat([fs_mov * e_m, e_m], dim=-1).to(splat_dtype))

    return pack


@torch.no_grad()
def baseline_rollout_sparse(model: BaselineModel, img: Tensor, flow: Tensor,
                            n_frames: int, positions: Tensor, valid: Tensor,
                            decode_batch: int = 6,
                            compute_dtype: torch.dtype = torch.float32,
                            plain: bool = False,
                            splat_dtype: torch.dtype = torch.float32) -> Tensor:
    """Sparse-splat, frame-batched-decode rollout; equal to
    ``baseline_rollout`` when the static pixels have exactly zero motion.

    img (1, H, W, 3); flow (H, W, 2) f32; positions (P, 2) int32 / valid (P,)
    f32 from ``prepare_scene_sparse``, on the model's device.
    ``compute_dtype`` bfloat16 runs encoder and decoder in bf16.
    ``splat_dtype`` is the splat's accumulation dtype: float32, or bfloat16
    (the render's ``bfloat16-fast`` mode, JAX ``rollout.py:523-529``: the
    packed rows and the scatter in bf16, the bilinear weights and the
    normalisation in f32; frames agree with float32 to ~1e-2). ``plain``
    runs K1, K2 and K5's plain PyTorch versions instead of the kernels (to
    check the kernels on the card). Returns (N, H, W, 3) float32 in [-1, 1].
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
        pack = _baseline_pack_fn(opt, fs, z, positions, valid,
                                 _static_mask(positions, valid, H, W), plain,
                                 splat_dtype)
        C = fs.shape[-1]

        integrate = euler_compact_dual_plain if plain else euler_compact_dual
        disp_f, disp_p = integrate(flow, positions, N - 1, N)

        frames = torch.empty((N, H, W, 3), dtype=f32, device=dev)
        chunk = torch.empty((decode_batch, H, W, C), dtype=compute_dtype,
                            device=dev)
        acc = splat_scratch(H, W, C + 1, splat_dtype, dev)
        for c0 in range(0, N, decode_batch):
            for j in range(decode_batch):
                t = c0 + j
                a, b = _alphas(t, N)
                u_static, u_mov = pack(disp_f[t])
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


# ---------------------------------------------------------------------------
# SLR two-layer rollouts
# ---------------------------------------------------------------------------

def gaussian_blur_region(mask: Tensor, W: int) -> Tensor:
    """Edit-region soft mask (reference 2layers forward_flow :867-906):
    gaussian blur with kernel W//20 (made odd), sigma W//50, replicate pad.
    mask (B, H, W, 1)."""
    k = W // 20
    if k % 2 == 0:
        k += 1
    sigma = max(W // 50, 1)
    xs = torch.arange(k, dtype=torch.float32, device=mask.device)
    g2 = torch.exp(-((xs[:, None] - (k - 1) / 2.0) ** 2
                     + (xs[None, :] - (k - 1) / 2.0) ** 2) / (2.0 * sigma ** 2))
    g2 = g2 / g2.sum()
    p = k // 2
    padded = F.pad(mask.permute(0, 3, 1, 2), (p, p, p, p), mode="replicate")
    return F.conv2d(padded, g2[None, None]).permute(0, 2, 3, 1)


def _alpha_extras(opt, img, flow, bg_img_raw, mask_rock):
    """kwargs for ``SLRModel.alpha_encode`` per the use_*_as_alpha_input
    flags (reference forward_flow :930-936); a missing rock mask is zeros."""
    kw = {}
    if opt.use_motion_as_alpha_input:
        kw["motion"] = flow[None].to(img.dtype)
    if opt.use_mask_as_alpha_input:
        m = (mask_rock if mask_rock is not None
             else torch.zeros(flow.shape[:2] + (1,), device=flow.device))
        if m.ndim == 3:
            m = m[None]
        kw["mask_rock"] = m.to(img.dtype)
    if opt.use_bg_as_alpha_input:
        kw["bg_raw"] = bg_img_raw.to(img.dtype)
    return kw


def _slr_pack_fn(opt, fs, z, a_fl_logits, a_bg_sig, positions, valid,
                 static_mask, plain, splat_dtype=torch.float32):
    """``(pack(t_disp) -> (u_static, u_mov), use_alpha0)`` for the sparse
    SLR rollout, rows in ``splat_dtype`` and contiguous. v2 rescales the
    Z-scaled channels
    (``[fs·e^Z, af·e^C, e^C, e^Z]``: all but af and e^C) of cached zn = 0
    rows by the per-frame e^zn (JAX ``_slr_pack_fn``)."""
    px, py = positions[:, 0].long(), positions[:, 1].long()
    f32 = torch.float32
    fs32, af32 = fs.to(f32), a_fl_logits.to(f32)
    if not opt.use_softmax_splatter_v2:
        u, use_alpha0 = slr_pack_splat_input(
            opt, fs32, z_normalize(opt, z).to(f32), af32, a_bg_sig)
        u = u[0]
        u_static = (u * static_mask[..., None]).to(splat_dtype).contiguous()
        u_mov = (u[py, px] * valid[:, None]).to(splat_dtype).contiguous()
        return (lambda t_disp: (u_static, u_mov)), use_alpha0

    base, use_alpha0 = slr_pack_splat_input(
        opt, fs32, torch.zeros_like(z, dtype=f32), af32, a_bg_sig)
    base = base[0]
    C = base.shape[-1]
    nfs = C - 3 if use_alpha0 else C - 2
    sel = torch.ones((C,), dtype=f32, device=base.device)
    if use_alpha0:
        sel[nfs:nfs + 2] = 0.0
    base_static = base * static_mask[..., None]
    base_mov = base[py, px] * valid[:, None]
    z2d, z_mov = _v2_z(z, positions)

    def pack(t_disp):
        zn_d, zn_m = _v2_zn(opt, z2d, z_mov, static_mask, positions, valid,
                            t_disp, plain)
        e_d = torch.exp(zn_d)[..., None] * sel + (1.0 - sel)
        e_m = torch.exp(zn_m)[:, None] * sel + (1.0 - sel)
        return (base_static * e_d).to(splat_dtype), (base_mov * e_m).to(splat_dtype)

    return pack, use_alpha0


def _slr_decode_chunk(model: SLRModel, packed: Tensor, img_b: Tensor,
                      a_bg_sig: Tensor, a_bg_logits: Tensor, bg_tanh: Tensor,
                      region, opt):
    """Fluid and alpha decode and composite of one chunk. packed (db, H, W,
    C+1) is ``[gen_fs, af_warped]``, K2's SLR output → (PredImg, FluidImg,
    CompositeFluidAlpha), f32."""
    fluid = model.decode_fluid(packed[..., :-1]).to(torch.float32)
    ga_logits = model.decode_alpha_packed(packed, img=img_b).to(torch.float32)
    gen, comp = slr_composite(fluid, torch.sigmoid(ga_logits), a_bg_sig,
                              bg_tanh, alpha_region=region, opt=opt,
                              ga_raw=ga_logits, a_bg_raw=a_bg_logits)
    return gen, fluid, comp


def _slr_heads(model: SLRModel, img, flow, mask_rock):
    """Per-scene SLR work: (fs, z for the splat, bg_tanh, a_bg_logits f32,
    a_bg_sig, a_fl_logits)."""
    opt = model.opt
    fs, z = model.encode(img)
    z = z_for_splat(opt, fs, z)
    bg_img_raw = model.bg(img)
    a_bg_logits, a_fl_logits = model.alpha_encode(
        img, **_alpha_extras(opt, img, flow, bg_img_raw, mask_rock))
    a_bg_logits = a_bg_logits.to(torch.float32)
    return (fs, z, torch.tanh(bg_img_raw.to(torch.float32)), a_bg_logits,
            torch.sigmoid(a_bg_logits), a_fl_logits)


def _slr_outputs(N, H, W, dev):
    f32 = torch.float32
    return {"PredImg": torch.empty((N, H, W, 3), dtype=f32, device=dev),
            "FluidImg": torch.empty((N, H, W, 3), dtype=f32, device=dev),
            "CompositeFluidAlpha": torch.empty((N, H, W, 1), dtype=f32,
                                               device=dev)}


@torch.no_grad()
def slr_rollout_sparse(model: SLRModel, img: Tensor, flow: Tensor,
                       n_frames: int, positions: Tensor, valid: Tensor,
                       alpha_region: Tensor = None, decode_batch: int = 20,
                       compute_dtype: torch.dtype = torch.float32,
                       mask_rock: Tensor = None, plain: bool = False,
                       splat_dtype: torch.dtype = torch.float32):
    """Two-layer SLR rollout (reference test_v1_4eval*.py semantics):
    encode, background and alpha head once; per frame the dual-ended sparse
    splat of ``[features, fluid alpha]`` (K2 with the SLR epilogue under
    ``use_alpha0_as_blending_weight``); per chunk the fluid and alpha
    decoders and the composite over the background.

    Arguments as ``baseline_rollout_sparse``; ``alpha_region`` (1, H, W, 1)
    in [0, 1] keeps the composite inside the (blurred) region and the fluid
    layer outside it. bf16 casts the five sub-networks; the splat
    accumulates in ``splat_dtype``; the composite stays f32. Returns a dict of f32 tensors: PredImg, FluidImg (N, H, W, 3),
    CompositeFluidAlpha (N, H, W, 1) and BGImg (H, W, 3).
    """
    opt = model.opt
    N = n_frames
    if N % decode_batch:
        raise ValueError(f"decode_batch {decode_batch} does not divide {N} frames")
    H, W = flow.shape[0], flow.shape[1]
    dev = flow.device

    with _fp32_convs(compute_dtype):
        model = cast_for_compute(model, compute_dtype)
        img = img.to(compute_dtype)
        fs, z, bg_tanh, a_bg_logits, a_bg_sig, a_fl_logits = _slr_heads(
            model, img, flow, mask_rock)
        pack, use_alpha0 = _slr_pack_fn(
            opt, fs, z, a_fl_logits, a_bg_sig, positions, valid,
            _static_mask(positions, valid, H, W), plain, splat_dtype)
        if use_alpha0:
            splat = splat_dual_normalize_slr_plain if plain else splat_dual_normalize_slr
        else:  # [fs·e^Z, af·e^Z, e^Z]: the baseline epilogue
            splat = splat_dual_normalize_plain if plain else splat_dual_normalize

        integrate = euler_compact_dual_plain if plain else euler_compact_dual
        disp_f, disp_p = integrate(flow, positions, N - 1, N)
        region = (None if alpha_region is None
                  else gaussian_blur_region(alpha_region.to(torch.float32), W))

        C1 = fs.shape[-1] + (3 if use_alpha0 else 2)
        chunk = torch.empty((decode_batch, H, W, fs.shape[-1] + 1),
                            dtype=compute_dtype, device=dev)
        acc = splat_scratch(H, W, C1, splat_dtype, dev)
        img_b = img.expand(decode_batch, -1, -1, -1)
        outs = _slr_outputs(N, H, W, dev)
        for c0 in range(0, N, decode_batch):
            for j in range(decode_batch):
                t = c0 + j
                a, b = _alphas(t, N, slr=True)
                # v2: one Z-norm, from the forward displacement, for both ends
                u_static, u_mov = pack(disp_f[t])
                args = (u_mov, positions, valid, disp_f[t], disp_p[N - t],
                        float(a), float(b), u_static)
                if plain:
                    chunk[j] = splat(*args, compute_dtype)
                else:
                    splat(*args, out=chunk[j], acc=acc)
            res = _slr_decode_chunk(model, chunk, img_b, a_bg_sig,
                                    a_bg_logits, bg_tanh, region, opt)
            for key, v in zip(outs, res):
                outs[key][c0:c0 + decode_batch] = v
        outs["BGImg"] = bg_tanh[0]
        return outs


@torch.no_grad()
def slr_rollout_dense(model: SLRModel, img: Tensor, flow: Tensor,
                      n_frames: int, alpha_region: Tensor = None,
                      mask_rock: Tensor = None,
                      decode_batch: Optional[int] = None, plain: bool = False):
    """Dense SLR rollout, f32, every pixel splatted: K4 integrates, two K3
    forwards splat each frame and the v2 Z-norm runs over the full grid
    through K6 (``plain``: the plain versions of K4 and K3). It renders
    what ``slr_rollout_sparse`` renders and is its check. Returns the same
    dict.
    """
    opt = model.opt
    N = n_frames
    H, W = flow.shape[0], flow.shape[1]
    v2 = opt.use_softmax_splatter_v2
    integrate = euler_integrate_all_dual_plain if plain else euler_integrate_all_dual
    splat = softsplat_sum_plain if plain else softsplat_sum
    with _fp32_convs(torch.float32):
        fs, z, bg_tanh, a_bg_logits, a_bg_sig, a_fl_logits = _slr_heads(
            model, img, flow, mask_rock)
        disp_f, disp_p = integrate(flow, N - 1, N)
        if not v2:
            u, use_alpha0 = slr_pack_splat_input(
                opt, fs, z_normalize(opt, z), a_fl_logits, a_bg_sig)
        region = (None if alpha_region is None
                  else gaussian_blur_region(alpha_region.to(torch.float32), W))
        packed = []
        for t in range(N):
            a, b = _alphas(t, N, slr=True)
            ff, fp = disp_f[t][None], disp_p[N - t][None]
            if v2:  # one Z-norm, from the forward displacement, for both ends
                u, use_alpha0 = slr_pack_splat_input(
                    opt, fs, z_normalize(opt, z, ff), a_fl_logits, a_bg_sig)
            g = (splat(u, ff) * torch.tensor(a, device=flow.device)
                 + splat(u, fp) * torch.tensor(b, device=flow.device))
            packed.append(torch.cat(slr_unpack_splatted(g, use_alpha0), -1)[0])
        return _slr_decode_stack(model, torch.stack(packed), img, a_bg_sig,
                                 a_bg_logits, bg_tanh, region, opt,
                                 _auto_decode_batch(N, decode_batch))


def _slr_decode_stack(model: SLRModel, packed_all: Tensor, img: Tensor,
                      a_bg_sig, a_bg_logits, bg_tanh, region, opt,
                      decode_batch: int):
    """Batched decode and composite of a stacked (N, H, W, C+1) ``[gen_fs,
    af_warped]`` rollout (dense SLR path)."""
    N, H, W = packed_all.shape[:3]
    img_b = img.expand(decode_batch, -1, -1, -1)
    outs = _slr_outputs(N, H, W, packed_all.device)
    for c0 in range(0, N, decode_batch):
        res = _slr_decode_chunk(model, packed_all[c0:c0 + decode_batch], img_b,
                                a_bg_sig, a_bg_logits, bg_tanh, region, opt)
        for key, v in zip(outs, res):
            outs[key][c0:c0 + decode_batch] = v
    outs["BGImg"] = bg_tanh[0]
    return outs
