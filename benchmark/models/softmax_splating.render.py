"""Render cells of ``model_type=softmax_splating``, the single-layer model:
its reference network, its plain render (``benchmark/reference/render.py``)
and the work of a traced scene (K2's bound and the reference's flops at
the reference's own crop plan), and the program's readings of one scene
that only this model type's render gives. ``SceneRenderer`` builds the
program's model from the checkpoint's options.
"""

from __future__ import annotations

import torch

from benchmark import flops
from benchmark.reference import render as ref
from benchmark.reference.models.baseline import BaselineModel
from benchmark.roofline import counts


def build(opt):
    """The reference network, on the CPU, its weights not yet set."""
    return BaselineModel(opt)


def render_frames(model, img, flow, n_frames, eps, bucket_ratio, decode_batch_for, dtype,
                  crop_decode):
    """((N, W, W, 3) float32 frames in [-1, 1] on the model's device, the
    crop plan or None)."""
    return ref.render_frames(model, img, flow, n_frames, eps, bucket_ratio, decode_batch_for,
                             dtype, crop_decode=crop_decode)


def scene_work(opt, mix, flow, splat_channels, device):
    """(K2's bound in seconds by the frozen count, the reference's flops)
    of one scene of ``mix`` whose flow is ``flow``."""
    N, W = mix["n_frames"], mix["W"]
    dtype = torch.bfloat16 if mix["dtype"].startswith("bfloat16") else torch.float32
    elem = 2 if mix["dtype"] == "bfloat16-fast" else 4
    flow = ref.sparsify(flow, mix["sparsify_eps_times_n"] / N)
    pos, val = ref.prepare_scene_sparse(flow, bucket_ratio=mix["p_bucket_ratio"])
    pt, vt = torch.from_numpy(pos).to(device), torch.from_numpy(val).to(device)
    df, dp = ref.euler_compact_dual_plain(torch.from_numpy(flow).to(device), pt, N - 1, N)
    crop = None
    if mix["crop_decode"] == "auto":
        radius, align = ref.model_crop_params(opt)
        crop = ref.plan_crop(ref._target_bounds(pt, vt, df, dp, W, W).tolist(),
                             W, W, radius, align)
    h, w = (W, W) if crop is None else (crop.hc, crop.wc)
    k2 = counts.k2(int(val.sum()), pos.shape[0], h, w, splat_channels, elem)[0] * N
    # a decode's flops scale with its frames: count all N in one chunk
    fl = flops.render_scene(build, opt, dtype, W, N, None if crop is None else (h, w), N)
    return k2, fl


def program_readings(renderer, img, flow, n_frames):
    """{"t_decoder_ms_per_frame"}: the decoder's ms a frame of one scene by
    ``SceneRenderer.profile`` (CUDA events, the fastest of three passes,
    cropped where the scene's plan crops)."""
    prof = renderer.profile(img, flow)
    st = prof["crop"] or prof["full"]
    return {"t_decoder_ms_per_frame": st["t_decoder"] * 1e3 / n_frames}
