"""Per-stage rollout timing (PyTorch port of
``slrsfs_tpu/engine/stage_profile.py``).

The reference's DEBUG_TIME stage meters
(``test_animating/test_baseline_4eval_rawsize.py:187-233``: t_encoder,
t_euler_integration, t_softmax_splating, t_decoder) for the sparse
baseline rollout. JAX times prefixes of its fused program and takes
differences; in eager PyTorch the stages are separable, so the rollout
itself times them (its ``stages`` argument, an
``engine.profiler.StageProfiler``: CUDA events on the card, synchronised at
each stage's end; the host clock on the CPU), in its own order: encode,
integrate (for the crop: ``prepare_crop``), the N splats, the decodes.
Each profile also returns the frames its last pass made. For
``cli.render --profile-stages``.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Union

import torch

from slrsfs_tpu_torch.engine.profiler import StageProfiler
from slrsfs_tpu_torch.engine.rollout import baseline_rollout_sparse, prepare_crop

STAGES = ("t_encoder", "t_euler_integration", "t_softmax_splating", "t_decoder")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _profile(run, device: torch.device, n_frames: int, runs: int):
    """``run(profiler)`` once to warm up (kernel builds, cuDNN's algorithm
    choice: ``compile_s``), then ``runs`` times → (the stages of the fastest
    pass with its ``total`` and ``fps``, the last pass's frames)."""
    _sync(device)
    t0 = time.perf_counter()
    run(StageProfiler(device))
    _sync(device)
    compile_s = time.perf_counter() - t0
    best = None
    for _ in range(runs):
        prof = StageProfiler(device)
        t0 = time.perf_counter()
        frames = run(prof)
        _sync(device)
        total = time.perf_counter() - t0
        if best is None or total < best["total"]:
            best = {**{k: 0.0 for k in STAGES}, **prof.sums(), "total": total}
    best.update(fps=n_frames / best["total"], compile_s=compile_s)
    return best, frames


def profile_baseline_stages(model, img, flow, positions, valid, n_frames: int,
                            decode_batch: int = 5,
                            compute_dtype=torch.float32,
                            splat_dtype=torch.float32, runs: int = 3):
    """Stage breakdown of ``baseline_rollout_sparse`` on a scene (arguments
    as there) → (stages, frames): the reference-named stage seconds
    (t_encoder, t_euler_integration, t_softmax_splating, t_decoder), total
    and fps of the fastest of ``runs`` passes after a warm-up, compile_s the
    warm-up's seconds (eager PyTorch compiles no program; the first pass
    builds the kernels and lets cuDNN choose its algorithms); and the
    (N, H, W, 3) frames of the last pass."""
    def run(prof):
        return baseline_rollout_sparse(
            model, img, flow, n_frames, positions, valid,
            decode_batch=decode_batch, compute_dtype=compute_dtype,
            splat_dtype=splat_dtype, stages=prof)

    return _profile(run, flow.device, n_frames, runs)


def profile_baseline_crop_stages(model, img, flow, positions, valid,
                                 n_frames: int,
                                 decode_batch: Union[int, Callable[[int], int]] = 30,
                                 compute_dtype=torch.float32,
                                 splat_dtype=torch.float32, runs: int = 3,
                                 max_area_frac: float = 0.85):
    """Stage breakdown of the crop rollout (``cli.render --crop-decode
    auto``): t_euler_integration is ``prepare_crop`` (the integration and
    the plan, once a scene) and ``total`` the scene's whole time (prepare
    and rollout). ``decode_batch`` is the frames a decode, or a function
    of the window's area (hc·wc) that gives it (``SceneRenderer.
    decode_batch_for``). Returns (stages with ``crop``, the CropSpec's
    fields, frames), or None when the scene's plan is None (no crop)."""
    opt = model.opt
    crop = prepare_crop(opt, False, flow, positions, valid, n_frames,
                        max_area_frac=max_area_frac)[1]
    if crop is None:
        return None
    if callable(decode_batch):
        decode_batch = decode_batch(crop.hc * crop.wc)

    def run(prof):
        with prof.stage("t_euler_integration"):
            disp, crop_ = prepare_crop(opt, False, flow, positions, valid,
                                       n_frames, max_area_frac=max_area_frac)
        return baseline_rollout_sparse(
            model, img, flow, n_frames, positions, valid,
            decode_batch=decode_batch, compute_dtype=compute_dtype,
            splat_dtype=splat_dtype, crop=crop_, disp=disp, stages=prof)

    st, frames = _profile(run, flow.device, n_frames, runs)
    st["crop"] = tuple(crop)
    return st, frames


def format_stages(st: Dict[str, float]) -> str:
    return (f"t_encoder={st['t_encoder'] * 1000:.0f}ms "
            f"t_euler_integration={st['t_euler_integration'] * 1000:.0f}ms "
            f"t_softmax_splating={st['t_softmax_splating'] * 1000:.0f}ms "
            f"t_decoder={st['t_decoder'] * 1000:.0f}ms "
            f"total={st['total'] * 1000:.0f}ms fps={st['fps']:.1f} "
            f"(warm-up {st['compile_s']:.1f}s)")
