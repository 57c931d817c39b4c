"""The baseline's render, plain, frozen for the benchmark's reference: the
sparsifier, the moving set, K1's integration, the crop plan and paste, the
encoder, the Z pack, K2 and its normalisation, the decoder chunks and the
static decode, as ``slrsfs_tpu_torch/cli/render.py:SceneRenderer`` and
``engine/rollout.py:baseline_rollout_sparse`` compute them, written with
the plain versions of the kernels. No v2 Z-norm, no SLR, no sharding.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import numpy as np
import torch

from benchmark.reference.init_utils import no_tf32
from benchmark.reference.models.baseline import (
    BaselineModel,
    pack_splat_input,
    z_for_splat,
    z_normalize,
)
from benchmark.reference.nn.archs import get_resnet_arch
from benchmark.reference.ops import (
    NORM_EPS,
    euler_compact_dual_plain,
    splat_dual_normalize_plain,
)

Tensor = torch.Tensor


def sparsify(flow: np.ndarray, eps: float) -> np.ndarray:
    """Zero the motion slower than ``eps`` pixels a frame
    (``SceneRenderer.scene_flow``'s sparsifier)."""
    if eps <= 0.0:
        return np.asarray(flow, np.float32)
    speed = np.sqrt(flow[..., 0] ** 2 + flow[..., 1] ** 2)
    return np.where((speed < eps)[..., None], 0.0, flow).astype(np.float32)


def to_u8(frames: Tensor) -> np.ndarray:
    """[-1, 1] frames → uint8 [0, 255], rounded (``cli/render.py:to_u8``)."""
    v = frames.to(torch.float32) * 0.5 + 0.5
    return (v.clamp(0.0, 1.0) * 255.0 + 0.5).to(torch.uint8).cpu().numpy()


def _alphas(t: int, n: int):
    a = np.float32(1.0) - np.float32(t) / np.float32(n)
    return a, np.float32(1.0) - a


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


def model_crop_params(opt):
    """(receptive radius, alignment) of the baseline's decoder."""
    arch = get_resnet_arch(opt.refine_model_type, opt)
    return decoder_receptive_radius(arch), crop_alignment(arch)


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


def _static_decode_input(opt, fs: Tensor, z: Tensor) -> Tensor:
    """(1, H, W, C) f32: the normalised splat field where no moving tap
    lands, packed in fs's dtype and divided by the clamped weight."""
    u = pack_splat_input(fs[0], z_normalize(opt, z)[0]).to(torch.float32)
    return (u[..., :-1] / torch.clamp(u[..., -1:], min=NORM_EPS))[None]


@torch.no_grad()
def render_frames(model: BaselineModel, img: np.ndarray, flow: np.ndarray,
                  n_frames: int, eps: float, bucket_ratio: Optional[float],
                  decode_batch_for, compute_dtype: torch.dtype,
                  crop_decode: bool = True, max_area_frac: float = 0.85,
                  bucket: int = 32):
    """The baseline's N frames of one scene, plain: img (W, W, 3) in [-1,
    1], flow (W, W, 2) in output pixels, on the model's device; the model
    already in ``compute_dtype``. ``decode_batch_for(area)`` is the decode
    chunk's frame count for a decode window of ``area`` pixels. Returns
    ((N, W, W, 3) float32 frames in [-1, 1] on the device, the crop plan
    or None)."""
    opt = model.opt
    dev = next(model.parameters()).device
    N = n_frames
    f32 = torch.float32
    flow = sparsify(flow, eps)
    positions, valid = prepare_scene_sparse(flow, bucket_ratio=bucket_ratio)
    img_t = torch.from_numpy(np.asarray(img, np.float32)[None]).to(dev)
    flow_t = torch.from_numpy(np.ascontiguousarray(flow)).to(dev)
    positions = torch.from_numpy(positions).to(dev)
    valid = torch.from_numpy(valid).to(dev)
    H, W = flow.shape[0], flow.shape[1]
    disp_f, disp_p = euler_compact_dual_plain(flow_t, positions, N - 1, N)
    crop = None
    if crop_decode:
        radius, align = model_crop_params(opt)
        bounds = _target_bounds(positions, valid, disp_f, disp_p, H, W).tolist()
        crop = plan_crop(bounds, H, W, radius, align, max_area_frac, bucket)
    convs = no_tf32() if compute_dtype == f32 else contextlib.nullcontext()
    with convs:
        fs, z = model.encode(img_t.to(compute_dtype))
        z = z_for_splat(opt, fs, z)
        C = fs.shape[-1]
        frames = torch.empty((N, H, W, 3), dtype=f32, device=dev)
        if crop is not None:
            frames[:] = model.decode(_static_decode_input(opt, fs, z)
                                     .to(compute_dtype))[0]
        hc, wc, positions_c = _crop_window(crop, positions, H, W)
        static_mask = _static_mask(positions_c, valid, hc, wc)
        px, py = positions[:, 0].long(), positions[:, 1].long()
        u = pack_splat_input(fs, z_normalize(opt, z))[0]
        u_static = (_crop_slice(u, crop) * static_mask[..., None]).to(f32)
        u_mov = (u[py, px] * valid[:, None]).to(f32)
        db = decode_batch_for(hc * wc)
        for c0 in range(0, N, db):
            chunk = torch.empty((db, hc, wc, C), dtype=compute_dtype, device=dev)
            for j in range(db):
                t = c0 + j
                a, b = _alphas(t, N)
                chunk[j] = splat_dual_normalize_plain(
                    u_mov, positions_c, valid, disp_f[t], disp_p[N - t],
                    float(a), float(b), u_static, compute_dtype)
            out = model.decode(chunk)
            if crop is None:
                frames[c0:c0 + db] = out
            else:
                _paste(frames[c0:c0 + db], out, crop)
    return frames, crop
