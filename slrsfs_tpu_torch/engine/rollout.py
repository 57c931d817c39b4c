"""Inference rollouts of the baseline and SLR models (PyTorch port of
``slrsfs_tpu/engine/rollout.py``).

Frame math follows reference ``forward_flow`` with the standard inference
indexing ``[0, t, N-1]``: forward displacement = t steps of M, backward =
N-t steps of -M, α = 1 - t/N (clamped to [1/600, 599/600] for SLR), and the
start features feed both splat ends. The v2 Z-norm is recomputed per frame
from the forward displacement and feeds both ends.

``baseline_rollout_sparse`` and ``slr_rollout_sparse`` are the main paths:
they splat only the moving pixels (static pixels splat onto themselves, an
identity added densely) with kernels K1 and K2 (K5 for v2), accumulating
in float32 or, with ``splat_dtype`` bfloat16, in bf16, and decode in frame
batches. Given a ``CropSpec`` (``prepare_crop``), they splat and decode
only the moving region's window and paste it onto one full-frame static
decode (the crop decode section below). ``baseline_rollout`` (the
repository's ``entry()`` path) and ``slr_rollout_dense`` are the dense
forms, every pixel splatted: K4 integrates, K3's forward splats (K6 for
v2), and they check the sparse paths. Every rollout's ``plain`` runs the
kernels' plain versions instead.
"""

from __future__ import annotations

import contextlib
import copy
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from slrsfs_tpu_torch.engine.init_utils import no_tf32
from slrsfs_tpu_torch.engine.profiler import count, span
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
    NORM_EPS,
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


def _frame_range(n_frames: int, frame_range: Optional[range],
                 decode_batch: int) -> range:
    """The frames a sparse rollout renders: all N, or ``frame_range``, a
    contiguous block of them; ``decode_batch`` must divide its length."""
    ts = range(n_frames) if frame_range is None else frame_range
    if ts.step != 1 or ts.start < 0 or ts.stop > n_frames or not len(ts):
        raise ValueError(f"frame_range {frame_range} is not a block of the "
                         f"{n_frames} frames")
    if len(ts) % decode_batch:
        raise ValueError(f"decode_batch {decode_batch} does not divide {len(ts)} frames")
    return ts


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
    """(H, W) f32, 1 where no moving row sits. A row outside the grid adds
    nothing: a crop window's padding rows (valid 0, at minus the window's
    offset) land there."""
    px, py = positions[:, 0].long(), positions[:, 1].long()
    inside = (px >= 0) & (px < width) & (py >= 0) & (py < height)
    moving = torch.zeros(height * width, dtype=torch.float32,
                         device=valid.device).scatter_reduce_(
        0, torch.where(inside, py * width + px, 0),
        torch.where(inside, valid, 0.0), reduce="amax")
    return 1.0 - moving.reshape(height, width)


# ---------------------------------------------------------------------------
# Moving-region crop decode (exact, receptive-field haloed)
# ---------------------------------------------------------------------------
#
# The splat field is normalised pointwise, so wherever no moving source
# lands it equals the encoder features (numerator and denominator share
# e^Z). The decoders are local (two 3x3 convs a block, 3x3/s2 pools,
# bilinear 2x ups), so frames differ from one frame-independent static
# decode only within the splat targets' bounding box dilated by the
# receptive radius. The crop rollouts decode the full frame once, then per
# frame splat and decode the box plus a two-radius halo and paste the box
# plus one radius: the same math on the same operands as the full rollout,
# at a cost that scales with the moving region.


class CropSpec(NamedTuple):
    """A scene's crop plan: (y0, x0, hc, wc) the splat and decode window,
    (py0, px0, ph, pw) the pasted interior, both in frame coordinates, the
    paste inside the window."""

    y0: int
    x0: int
    hc: int
    wc: int
    py0: int
    px0: int
    ph: int
    pw: int


def decoder_receptive_radius(arch) -> int:
    """Upper bound, in full-resolution pixels, on a ResNet decoder's
    receptive radius: two 3x3 convs a block at the block's input scale, +1
    for a Down block's 3x3/s2 pool or an Up block's bilinear read, +2 for
    pooled-edge rounding."""
    scale, r = 1, 0
    for mode in arch["upsample"]:
        r += 2 * scale
        if mode == "Down":
            r += scale
            scale *= 2
        elif mode == "Up":
            r += scale
            scale = max(1, scale // 2)
    return r + 2


def crop_alignment(arch) -> int:
    """The deepest cumulative downsampling factor: window offsets and sizes
    are multiples of it, so the cropped pooling and upsampling grids
    coincide with the full frame's."""
    cur = peak = 1
    for mode in arch["upsample"]:
        if mode == "Down":
            cur *= 2
        elif mode == "Up":
            cur = max(1, cur // 2)
        peak = max(peak, cur)
    return peak


def model_crop_params(opt, slr: bool):
    """(receptive radius, alignment) over every decoder the rollout runs."""
    from slrsfs_tpu_torch.nn.archs import get_resnet_arch

    keys = [opt.refine_model_type]
    if slr:
        keys.append(opt.alpha_refine_model_type)
    archs = [get_resnet_arch(k, opt) for k in keys]
    return (max(decoder_receptive_radius(a) for a in archs),
            max(crop_alignment(a) for a in archs))


def _target_bounds(positions: Tensor, valid: Tensor, disp_f: Tensor,
                   disp_p: Tensor, height: int, width: int) -> Tensor:
    """[xlo, xhi, ylo, yhi] f32 on the rows' device: the inclusive bounding
    box of every bilinear tap of every valid row over all frames, targets
    clipped to the grid. A target that reaches no cell (t outside (-1,
    size)), such as the leaving trajectories' max(H, W)+1 marker, adds
    nothing, as it adds nothing to the splat."""
    ok = (valid > 0.5)[None]
    posf = positions.to(torch.float32)

    def ax(axis, size):
        t = (torch.cat([disp_f[..., axis], disp_p[..., axis]], dim=0)
             + posf[:, axis][None])
        m = ok & (t > -1.0) & (t < size)
        t = t.clamp(0.0, size - 1.0)
        lo = torch.floor(torch.where(m, t, size - 1.0).min())
        hi = torch.floor(torch.where(m, t, 0.0).max()) + 1.0
        return lo, torch.clamp(hi, max=size - 1.0)

    xlo, xhi = ax(0, width)
    ylo, yhi = ax(1, height)
    return torch.stack([xlo, xhi, ylo, yhi])


def _axis_window(lo_t, hi_t, size, radius, align):
    p_lo = max(0, lo_t - radius)
    p_hi = min(size - 1, hi_t + radius)
    c_lo = max(0, p_lo - radius)
    c_lo -= c_lo % align
    c_hi = min(size, p_hi + radius + 1)
    c_hi = -(-c_hi // align) * align  # size % align == 0, so c_hi <= size
    return c_lo, c_hi - c_lo, p_lo, p_hi - p_lo + 1


def plan_crop(bounds, height, width, radius, align,
              max_area_frac: float = 0.85, bucket: int = 32):
    """CropSpec from ``_target_bounds``' four values, or None when the frame
    is not aligned, no tap reaches the grid (inverted bounds: every frame is
    the static decode), or the window would cover ``max_area_frac`` of the
    frame or more. ``bucket`` widens the box outward to multiples of it, so
    nearby scenes share a window size; a larger window is still exact."""
    if height % align or width % align:
        return None
    xlo, xhi, ylo, yhi = [int(v) for v in bounds]
    if xhi < xlo or yhi < ylo:
        return None
    if bucket > 1:
        xlo, ylo = xlo - xlo % bucket, ylo - ylo % bucket
        xhi = min(width - 1, xhi + (-xhi - 1) % bucket)
        yhi = min(height - 1, yhi + (-yhi - 1) % bucket)
    x0, wc, px0, pw = _axis_window(xlo, xhi, width, radius, align)
    y0, hc, py0, ph = _axis_window(ylo, yhi, height, radius, align)
    if min(hc, wc, ph, pw) <= 0:
        return None
    if hc * wc >= max_area_frac * height * width:
        return None
    return CropSpec(y0, x0, hc, wc, py0, px0, ph, pw)


def prepare_crop(opt, slr: bool, flow: Tensor, positions: Tensor,
                 valid: Tensor, n_frames: int, max_area_frac: float = 0.85,
                 bucket: int = 32, plain: bool = False):
    """Integrate the scene once (K1, or with ``plain`` its plain version)
    and plan its crop → ``((disp_f, disp_p), crop)``: the displacements to
    pass to the sparse rollouts as ``disp`` and a CropSpec or None. Copies
    four floats to the host."""
    N = n_frames
    H, W = flow.shape[0], flow.shape[1]
    with span("rollout.crop_plan"):
        integrate = euler_compact_dual_plain if plain else euler_compact_dual
        disp_f, disp_p = integrate(flow, positions, N - 1, N)
        radius, align = model_crop_params(opt, slr)
        bounds = _target_bounds(positions, valid, disp_f, disp_p, H, W).tolist()
        crop = plan_crop(bounds, H, W, radius, align,
                         max_area_frac=max_area_frac, bucket=bucket)
    return (disp_f, disp_p), crop


def _crop_slice(a: Tensor, crop: Optional[CropSpec]) -> Tensor:
    """The window of a tensor whose leading dims are (H, W). The offsets are
    the CropSpec's ints: JAX passes them traced (``crop_offsets``,
    ``_crop_scalars``) so that XLA shares one compiled program across window
    positions; eager PyTorch compiles nothing, so the port has neither."""
    if crop is None:
        return a
    return a[crop.y0:crop.y0 + crop.hc, crop.x0:crop.x0 + crop.wc]


def _crop_window(crop: Optional[CropSpec], positions: Tensor, height: int,
                 width: int):
    """(hc, wc, positions_c): the grid the splat runs on and the moving
    positions in its coordinates (contiguous int32)."""
    if crop is None:
        return height, width, positions
    shift = torch.tensor([crop.x0, crop.y0], dtype=positions.dtype,
                         device=positions.device)
    return crop.hc, crop.wc, (positions - shift).contiguous()


def _paste(out: Tensor, patch: Tensor, crop: CropSpec) -> None:
    """Write the paste interior of window-grid outputs ``patch`` (B, hc,
    wc, ch) into frame-grid ``out`` (B, H, W, ch)."""
    oy, ox = crop.py0 - crop.y0, crop.px0 - crop.x0
    out[:, crop.py0:crop.py0 + crop.ph, crop.px0:crop.px0 + crop.pw] = \
        patch[:, oy:oy + crop.ph, ox:ox + crop.pw]


def _stage(stages, name: str):
    """``stages.stage(name)`` (an ``engine.profiler.StageProfiler``), or
    nothing when no profiler is given."""
    return contextlib.nullcontext() if stages is None else stages.stage(name)


def _count_decodes(frames: int, height: int, width: int,
                   crop: Optional[CropSpec]) -> None:
    """The rollout's decode counters for ``frames`` frames: the pixels the
    decodes take in (``rollout.decoded_px``) and those that reach the
    frames (``rollout.kept_px``): a crop window's paste interior a frame
    and the static decode's frame outside it; the whole frame uncropped."""
    if crop is None:
        count("rollout.decoded_px", frames * height * width)
        count("rollout.kept_px", frames * height * width)
        return
    paste = crop.ph * crop.pw
    count("rollout.decoded_px", frames * crop.hc * crop.wc + height * width)
    count("rollout.kept_px", frames * paste + height * width - paste)


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
                      splat_dtype=torch.float32, crop: Optional[CropSpec] = None,
                      positions_c: Optional[Tensor] = None):
    """``pack(t_disp) -> (u_static (h, w, C+1), u_mov (P, C+1))`` in
    ``splat_dtype``, contiguous. Frame-constant without v2; with v2 the
    per-frame sparse maximum-warp norm (K5, or its plain version) rescales
    cached rows (JAX ``_baseline_pack_fn``).

    With ``crop``, ``static_mask`` and ``u_static`` are on the (hc, wc)
    window grid: the moving rows are gathered at their frame ``positions``,
    and K5 runs at ``positions_c``, the window's coordinates. Exact, since
    no moving tap leaves the window (``plan_crop``)."""
    if positions_c is None:
        positions_c = positions
    px, py = positions[:, 0].long(), positions[:, 1].long()
    f32 = torch.float32
    if not opt.use_softmax_splatter_v2:
        # the static identity is α·U + (1-α)·U = U on static pixels
        u = pack_splat_input(fs, z_normalize(opt, z))[0]  # (H, W, C+1)
        u_static = (_crop_slice(u, crop) * static_mask[..., None]
                    ).to(splat_dtype).contiguous()
        u_mov = (u[py, px] * valid[:, None]).to(splat_dtype).contiguous()
        return lambda t_disp: (u_static, u_mov)

    z2d, z_mov = _v2_z(z, positions)
    z2d = _crop_slice(z2d, crop).contiguous()
    fs_static = _crop_slice(fs[0], crop).to(f32) * static_mask[..., None]
    fs_mov = fs[0][py, px].to(f32) * valid[:, None]

    def pack(t_disp):
        zn_d, zn_m = _v2_zn(opt, z2d, z_mov, static_mask, positions_c, valid,
                            t_disp, plain)
        e_d = (torch.exp(zn_d) * static_mask)[..., None]
        e_m = (torch.exp(zn_m) * valid)[:, None]
        return (torch.cat([fs_static * e_d, e_d], dim=-1).to(splat_dtype),
                torch.cat([fs_mov * e_m, e_m], dim=-1).to(splat_dtype))

    return pack


def _static_zn_full(opt, z, positions, valid, plain):
    """(H, W, 1): the frame-constant Z-norm of the static field on the full
    grid. Without v2 the global ``z_normalize``; with v2 the
    maximum-warp norm's static stencil (K5 with every row invalid and no
    displacement), exact outside the targets' box, and inside it the paste
    covers the static decode."""
    if not opt.use_softmax_splatter_v2:
        return z_normalize(opt, z)[0]
    z2d, z_mov = _v2_z(z, positions)
    H, W = z2d.shape
    zeros = torch.zeros_like(valid)
    zn, _ = _v2_zn(opt, z2d, z_mov, _static_mask(positions, valid, H, W),
                   positions, zeros, torch.zeros_like(positions, dtype=torch.float32),
                   plain)
    return zn[..., None]


def _baseline_static_decode_input(opt, fs, z, positions, valid, plain,
                                  splat_dtype=torch.float32) -> Tensor:
    """(1, H, W, C) f32: the crop rollout's static decode input, the
    normalised splat field where no moving tap lands, computed as the
    per-frame rows are: packed (without v2 by ``pack_splat_input``, in
    fs's dtype; with v2 in f32), rounded through ``splat_dtype``, divided
    by the clamped weight. Not ``fs`` itself: where e^zn falls below
    NORM_EPS (zn < ln(1e-8), which the ±20 clamp allows) the field is
    fs·e^zn/NORM_EPS. In float32 it is the JAX
    ``_baseline_static_decode_input`` bit for bit; JAX packs in f32 also for
    bf16 networks, whose per-frame rows are packed in bf16."""
    zn = _static_zn_full(opt, z, positions, valid, plain)
    if opt.use_softmax_splatter_v2:
        e = torch.exp(zn.to(torch.float32))
        u = torch.cat([fs[0].to(torch.float32) * e, e], dim=-1)
    else:
        u = pack_splat_input(fs[0], zn)
    u = u.to(splat_dtype).to(torch.float32)
    return (u[..., :-1] / torch.clamp(u[..., -1:], min=NORM_EPS))[None]


@torch.no_grad()
def baseline_rollout_sparse(model: BaselineModel, img: Tensor, flow: Tensor,
                            n_frames: int, positions: Tensor, valid: Tensor,
                            decode_batch: int = 6,
                            compute_dtype: torch.dtype = torch.float32,
                            plain: bool = False,
                            splat_dtype: torch.dtype = torch.float32,
                            crop: Optional[CropSpec] = None, disp=None,
                            stages=None, frame_range: Optional[range] = None
                            ) -> Tensor:
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
    check the kernels on the card).

    ``crop`` (``prepare_crop``) splats and decodes each frame on the crop
    window only, pasting its interior onto one full-frame static decode;
    ``disp`` = (disp_f, disp_p), ``prepare_crop``'s displacements, skips the
    integration. ``stages`` (``engine.profiler.StageProfiler``) times the
    stages under the reference's names: t_encoder, t_euler_integration
    (without ``disp``), t_softmax_splating (the packing and the N splats),
    t_decoder (the decodes). ``frame_range``, a contiguous block of frames
    of the N (``baseline_rollout_frame_sharded``'s rank block), renders
    those frames alone, decode_batch dividing their count. Returns
    (N, H, W, 3) float32 in [-1, 1], or (len(frame_range), H, W, 3).
    """
    opt = model.opt
    N = n_frames
    ts = _frame_range(N, frame_range, decode_batch)
    H, W = flow.shape[0], flow.shape[1]
    dev = flow.device
    f32 = torch.float32

    _count_decodes(len(ts), H, W, crop)
    with _fp32_convs(compute_dtype):
        with _stage(stages, "t_encoder"):
            model = cast_for_compute(model, compute_dtype)
            fs, z = model.encode(img.to(compute_dtype))
            z = z_for_splat(opt, fs, z)
        if disp is None:
            with _stage(stages, "t_euler_integration"):
                integrate = euler_compact_dual_plain if plain else euler_compact_dual
                disp = integrate(flow, positions, N - 1, N)
        disp_f, disp_p = disp
        C = fs.shape[-1]

        frames = torch.empty((len(ts), H, W, 3), dtype=f32, device=dev)
        if crop is not None:
            # the frame outside the paste window: one full-frame decode
            with span("rollout.static_decode", timed=True, stages=stages):
                frames[:] = model.decode(_baseline_static_decode_input(
                    opt, fs, z, positions, valid, plain, splat_dtype
                ).to(compute_dtype))[0]
        with _stage(stages, "t_softmax_splating"):
            hc, wc, positions_c = _crop_window(crop, positions, H, W)
            pack = _baseline_pack_fn(opt, fs, z, positions, valid,
                                     _static_mask(positions_c, valid, hc, wc),
                                     plain, splat_dtype, crop, positions_c)
            chunk = torch.empty((decode_batch, hc, wc, C), dtype=compute_dtype,
                                device=dev)
            acc = splat_scratch(hc, wc, C + 1, splat_dtype, dev)
        for c0 in range(0, len(ts), decode_batch):
            with _stage(stages, "t_softmax_splating"):
                for j in range(decode_batch):
                    t = ts[c0 + j]
                    a, b = _alphas(t, N)
                    u_static, u_mov = pack(disp_f[t])
                    if plain:
                        chunk[j] = splat_dual_normalize_plain(
                            u_mov, positions_c, valid, disp_f[t], disp_p[N - t],
                            float(a), float(b), u_static, compute_dtype)
                    else:
                        splat_dual_normalize(u_mov, positions_c, valid, disp_f[t],
                                             disp_p[N - t], float(a), float(b),
                                             u_static, out=chunk[j], acc=acc)
            with span("rollout.decode", timed=True, stages=stages):
                out = model.decode(chunk)
                if crop is None:
                    frames[c0:c0 + decode_batch] = out
                else:
                    _paste(frames[c0:c0 + decode_batch], out, crop)
        return frames


@torch.no_grad()
def warp_flow_rollout(img: Tensor, flow: Tensor, n_frames: int, positions: Tensor,
                      valid: Tensor, plain: bool = False) -> Tensor:
    """Warp the image itself with the integrated motion, no network
    (reference ``AnimatingSoftmaxSplating.warp_flow``,
    animating_softmax_splating.py:983-1173; JAX ``warp_flow_rollout``):
    the double-ended splat of u = [RGB, 1] (Z = 1), K1 once and K2 a frame
    (C1 = 4, float32), the static pixels splatting onto themselves.

    img (1, H, W, 3) in [-1, 1]; flow, positions, valid as for
    ``baseline_rollout_sparse``; ``plain`` runs the kernels' plain
    versions. Returns (N, H, W, 3) float32."""
    N = n_frames
    H, W = flow.shape[0], flow.shape[1]
    f32 = torch.float32
    u = torch.cat([img[0].to(f32), torch.ones((H, W, 1), dtype=f32, device=flow.device)],
                  dim=-1)
    u_static = (u * _static_mask(positions, valid, H, W)[..., None]).contiguous()
    u_mov = (u[positions[:, 1].long(), positions[:, 0].long()] * valid[:, None]).contiguous()
    integrate = euler_compact_dual_plain if plain else euler_compact_dual
    disp_f, disp_p = integrate(flow, positions, N - 1, N)
    frames = torch.empty((N, H, W, 3), dtype=f32, device=flow.device)
    acc = splat_scratch(H, W, 4, f32, flow.device)
    for t in range(N):
        a, b = _alphas(t, N)
        args = (u_mov, positions, valid, disp_f[t], disp_p[N - t], float(a), float(b),
                u_static)
        if plain:
            frames[t] = splat_dual_normalize_plain(*args, f32)
        else:
            splat_dual_normalize(*args, out=frames[t], acc=acc)
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


def _z_scaled(C: int, use_alpha0: bool, device) -> Tensor:
    """(C,) f32, 1 on the SLR layout's channels that carry e^Z: all of
    ``[fs·e^Z, af·e^Z, e^Z]``; all but af·e^C and e^C of ``[fs·e^Z, af·e^C,
    e^C, e^Z]`` (use_alpha0)."""
    sel = torch.ones((C,), dtype=torch.float32, device=device)
    if use_alpha0:
        sel[C - 3:C - 1] = 0.0
    return sel


def _slr_pack_fn(opt, fs, z, a_fl_logits, a_bg_sig, positions, valid,
                 static_mask, plain, splat_dtype=torch.float32,
                 crop: Optional[CropSpec] = None,
                 positions_c: Optional[Tensor] = None):
    """``(pack(t_disp) -> (u_static, u_mov), use_alpha0, u_full)`` for the
    sparse SLR rollout, rows in ``splat_dtype`` and contiguous. v2 rescales
    the Z-scaled channels (``_z_scaled``) of cached zn = 0 rows by the
    per-frame e^zn (JAX ``_slr_pack_fn``). ``u_full`` (H, W, C) f32 is the
    frame-independent packed field on the full grid (v2: with zn = 0),
    which the crop rollout decodes once as the static frame. ``crop`` and
    ``positions_c`` as for ``_baseline_pack_fn``."""
    if positions_c is None:
        positions_c = positions
    px, py = positions[:, 0].long(), positions[:, 1].long()
    f32 = torch.float32
    fs32, af32 = fs.to(f32), a_fl_logits.to(f32)
    if not opt.use_softmax_splatter_v2:
        u, use_alpha0 = slr_pack_splat_input(
            opt, fs32, z_normalize(opt, z).to(f32), af32, a_bg_sig)
        u = u[0]
        u_static = (_crop_slice(u, crop) * static_mask[..., None]
                    ).to(splat_dtype).contiguous()
        u_mov = (u[py, px] * valid[:, None]).to(splat_dtype).contiguous()
        return (lambda t_disp: (u_static, u_mov)), use_alpha0, u

    base, use_alpha0 = slr_pack_splat_input(
        opt, fs32, torch.zeros_like(z, dtype=f32), af32, a_bg_sig)
    base = base[0]
    sel = _z_scaled(base.shape[-1], use_alpha0, base.device)
    base_static = _crop_slice(base, crop) * static_mask[..., None]
    base_mov = base[py, px] * valid[:, None]
    z2d, z_mov = _v2_z(z, positions)
    z2d = _crop_slice(z2d, crop).contiguous()

    def pack(t_disp):
        zn_d, zn_m = _v2_zn(opt, z2d, z_mov, static_mask, positions_c, valid,
                            t_disp, plain)
        e_d = torch.exp(zn_d)[..., None] * sel + (1.0 - sel)
        e_m = torch.exp(zn_m)[:, None] * sel + (1.0 - sel)
        return (base_static * e_d).to(splat_dtype), (base_mov * e_m).to(splat_dtype)

    return pack, use_alpha0, base


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


def _slr_heads(model: SLRModel, img, flow, mask_rock, bg_img_raw=None):
    """Per-scene SLR work: (fs, z for the splat, bg_tanh, a_bg_logits f32,
    a_bg_sig, a_fl_logits). ``bg_img_raw``, the background network's raw
    (1, H, W, 3) output, is computed unless it is given."""
    opt = model.opt
    fs, z = model.encode(img)
    z = z_for_splat(opt, fs, z)
    if bg_img_raw is None:
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
                       splat_dtype: torch.dtype = torch.float32,
                       crop: Optional[CropSpec] = None, disp=None,
                       frame_range: Optional[range] = None,
                       bg_img_raw: Tensor = None):
    """Two-layer SLR rollout (reference test_v1_4eval*.py semantics):
    encode, background and alpha head once; per frame the dual-ended sparse
    splat of ``[features, fluid alpha]`` (K2 with the SLR epilogue under
    ``use_alpha0_as_blending_weight``); per chunk the fluid and alpha
    decoders and the composite over the background.

    Arguments as ``baseline_rollout_sparse``; ``alpha_region`` (1, H, W, 1)
    in [0, 1] keeps the composite inside the (blurred) region and the fluid
    layer outside it. bf16 casts the five sub-networks; the splat
    accumulates in ``splat_dtype``; the composite stays f32. With ``crop``
    the image, background, alpha head and region are cropped to the window
    for the chunk decodes, and the static fluid and alpha decode and its
    composite run once at full frame. ``frame_range`` as for
    ``baseline_rollout_sparse``. Returns a dict of f32 tensors: PredImg,
    FluidImg (N, H, W, 3), CompositeFluidAlpha (N, H, W, 1) (with
    ``frame_range``, its frames) and BGImg (H, W, 3). ``bg_img_raw``, a
    precomputed (1, H, W, 3) background before its tanh (a scene's own
    ``model.bg(img)``, or another), takes the place of the background
    network's pass, as in JAX.
    """
    opt = model.opt
    N = n_frames
    ts = _frame_range(N, frame_range, decode_batch)
    H, W = flow.shape[0], flow.shape[1]
    dev = flow.device
    f32 = torch.float32

    _count_decodes(len(ts), H, W, crop)
    with _fp32_convs(compute_dtype):
        model = cast_for_compute(model, compute_dtype)
        img = img.to(compute_dtype)
        fs, z, bg_tanh, a_bg_logits, a_bg_sig, a_fl_logits = _slr_heads(
            model, img, flow, mask_rock, bg_img_raw)
        hc, wc, positions_c = _crop_window(crop, positions, H, W)
        pack, use_alpha0, u_full = _slr_pack_fn(
            opt, fs, z, a_fl_logits, a_bg_sig, positions, valid,
            _static_mask(positions_c, valid, hc, wc), plain, splat_dtype,
            crop, positions_c)
        if use_alpha0:
            splat = splat_dual_normalize_slr_plain if plain else splat_dual_normalize_slr
        else:  # [fs·e^Z, af·e^Z, e^Z]: the baseline epilogue
            splat = splat_dual_normalize_plain if plain else splat_dual_normalize

        if disp is None:
            integrate = euler_compact_dual_plain if plain else euler_compact_dual
            disp = integrate(flow, positions, N - 1, N)
        disp_f, disp_p = disp
        region = (None if alpha_region is None
                  else gaussian_blur_region(alpha_region.to(f32), W))
        outs = _slr_outputs(len(ts), H, W, dev)
        bg_full = bg_tanh[0]
        if crop is not None:
            # the static frame: u_full normalises pointwise to every frame's
            # value outside the paste window. v2 packed it with zn = 0, so
            # the static stencil's e^zn goes back on the Z-scaled channels
            # (the NORM_EPS floor is reachable under the ±20 clamp)
            u_st = u_full
            if opt.use_softmax_splatter_v2:
                sel = _z_scaled(u_full.shape[-1], use_alpha0, dev)
                zn_st = _static_zn_full(opt, z, positions, valid, plain)
                u_st = u_full * (torch.exp(zn_st.to(f32)) * sel + (1.0 - sel))
            u_st = u_st.to(splat_dtype).to(f32)
            packed_st = torch.cat(slr_unpack_splatted(u_st[None], use_alpha0),
                                  dim=-1).to(compute_dtype)
            with span("rollout.static_decode", timed=True):
                res = _slr_decode_chunk(model, packed_st, img, a_bg_sig, a_bg_logits,
                                        bg_tanh, region, opt)
                for key, v in zip(outs, res):
                    outs[key][:] = v[0]

            def cr(a):  # the window of a (1, H, W, ch) tensor
                return a[:, crop.y0:crop.y0 + hc, crop.x0:crop.x0 + wc]

            img, a_bg_sig, a_bg_logits, bg_tanh = (
                cr(img), cr(a_bg_sig), cr(a_bg_logits), cr(bg_tanh))
            region = None if region is None else cr(region)

        C1 = fs.shape[-1] + (3 if use_alpha0 else 2)
        chunk = torch.empty((decode_batch, hc, wc, fs.shape[-1] + 1),
                            dtype=compute_dtype, device=dev)
        acc = splat_scratch(hc, wc, C1, splat_dtype, dev)
        img_b = img.expand(decode_batch, -1, -1, -1)
        for c0 in range(0, len(ts), decode_batch):
            for j in range(decode_batch):
                t = ts[c0 + j]
                a, b = _alphas(t, N, slr=True)
                # v2: one Z-norm, from the forward displacement, for both ends
                u_static, u_mov = pack(disp_f[t])
                args = (u_mov, positions_c, valid, disp_f[t], disp_p[N - t],
                        float(a), float(b), u_static)
                if plain:
                    chunk[j] = splat(*args, compute_dtype)
                else:
                    splat(*args, out=chunk[j], acc=acc)
            with span("rollout.decode", timed=True):
                res = _slr_decode_chunk(model, chunk, img_b, a_bg_sig,
                                        a_bg_logits, bg_tanh, region, opt)
                for key, v in zip(outs, res):
                    if crop is None:
                        outs[key][c0:c0 + decode_batch] = v
                    else:
                        _paste(outs[key][c0:c0 + decode_batch], v, crop)
        outs["BGImg"] = bg_full
        return outs


# ---------------------------------------------------------------------------
# Frame-sharded renders (several GPUs)
# ---------------------------------------------------------------------------
#
# Frames are independent given the integrated displacements, so each rank
# of a ``parallel.mesh.Mesh`` does the per-scene work (encode, Z-norm,
# pack, the K1 integration unless ``disp`` is given; the SLR background,
# alpha heads and crop statics) and renders its contiguous block of N /
# world frames through the sparse rollout, then the blocks are gathered
# onto every rank: JAX's ``P('data')`` over ``arange(N)``.


def baseline_rollout_frame_sharded(model: BaselineModel, img: Tensor, flow: Tensor,
                                   n_frames: int, positions: Tensor, valid: Tensor,
                                   mesh, **kw) -> Tensor:
    """``baseline_rollout_sparse`` with the frame axis sharded over
    ``mesh``'s ranks (JAX ``baseline_rollout_frame_sharded``): this rank
    renders ``parallel.mesh.frame_block`` (N % world != 0 is a
    ``ValueError``), and every rank returns all (N, H, W, 3) frames.
    ``kw``: ``baseline_rollout_sparse``'s decode_batch (which must divide
    the block), compute_dtype, plain, splat_dtype, crop and disp."""
    from slrsfs_tpu_torch.parallel.mesh import all_gather_frames, frame_block

    block = frame_block(n_frames, mesh)
    local = baseline_rollout_sparse(model, img, flow, n_frames, positions, valid,
                                    frame_range=block, **kw)
    return all_gather_frames(local, mesh)


def slr_rollout_frame_sharded(model: SLRModel, img: Tensor, flow: Tensor,
                              n_frames: int, positions: Tensor, valid: Tensor,
                              mesh, **kw):
    """``slr_rollout_sparse`` with the frame axis sharded over ``mesh``'s
    ranks, as ``baseline_rollout_frame_sharded`` (JAX
    ``slr_rollout_frame_sharded``): the same dict on every rank, PredImg,
    FluidImg and CompositeFluidAlpha gathered, BGImg the rank's own (every
    rank computes the same). ``kw``: ``slr_rollout_sparse``'s
    alpha_region, decode_batch (which must divide the block),
    compute_dtype, mask_rock, plain, splat_dtype, crop and disp."""
    from slrsfs_tpu_torch.parallel.mesh import all_gather_frames, frame_block

    block = frame_block(n_frames, mesh)
    outs = slr_rollout_sparse(model, img, flow, n_frames, positions, valid,
                              frame_range=block, **kw)
    return {k: v if k == "BGImg" else all_gather_frames(v, mesh) for k, v in outs.items()}


@torch.no_grad()
def slr_rollout_dense(model: SLRModel, img: Tensor, flow: Tensor,
                      n_frames: int, alpha_region: Tensor = None,
                      mask_rock: Tensor = None,
                      decode_batch: Optional[int] = None, plain: bool = False,
                      bg_img_raw: Tensor = None):
    """Dense SLR rollout, f32, every pixel splatted: K4 integrates, two K3
    forwards splat each frame and the v2 Z-norm runs over the full grid
    through K6 (``plain``: the plain versions of K4 and K3). It renders
    what ``slr_rollout_sparse`` renders and is its check. Returns the same
    dict. ``bg_img_raw`` as for ``slr_rollout_sparse``.
    """
    opt = model.opt
    N = n_frames
    H, W = flow.shape[0], flow.shape[1]
    v2 = opt.use_softmax_splatter_v2
    integrate = euler_integrate_all_dual_plain if plain else euler_integrate_all_dual
    splat = softsplat_sum_plain if plain else softsplat_sum
    with _fp32_convs(torch.float32):
        fs, z, bg_tanh, a_bg_logits, a_bg_sig, a_fl_logits = _slr_heads(
            model, img, flow, mask_rock, bg_img_raw)
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
