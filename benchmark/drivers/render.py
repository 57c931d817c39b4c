"""Render cells: a closed loop of one client rendering a seeded pool of
scenes back to back through the port's ``SceneRenderer`` (``scene_flow`` →
``frames`` → ``outputs_to_u8``), the frames kept in host memory, no file
written. The window runs whole passes over the pool (each pass a seeded
order of all its scenes) until ``--seconds`` have passed, so that every
run renders the same scenes; its length runs to the end of the last
scene.

Correctness: a sample of the window's scenes, drawn from the seed with the
pool's largest scene in it, is rendered again by the plain reference in
float32 with the same weights, and the port's uint8 frames are held to it
by the worst frame's mean absolute difference in 8-bit levels.

What differs between model types (the reference network, its plain render
and the work a traced scene counts) is in
``benchmark/models/<model_type>.render.py``; the port's ``SceneRenderer``
builds its own model from the checkpoint's options.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import os
from typing import Dict, List

import numpy as np

from benchmark import generate, harness
from benchmark.harness import Readings, now, span

# the reference's decode chunk budget in pixel-frames (f32, ~4 kB each)
REF_DECODE_PX = 4_000_000


def _tuples(d: Dict) -> Dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def options(cfg: Dict, mix: Dict):
    """The reference's ``Options`` of a render cell."""
    from benchmark.reference.config import Options

    return Options(W=mix["W"], bn_noise_misc=True, **_tuples(cfg["options"]))


def part_of(opt):
    """The model part of ``opt``'s model type
    (``benchmark/models/<model_type>.render.py``)."""
    return harness.model_part(opt.model_type, "render")


def make_weights(opt, seed: int, device):
    """(reference model in f32 on ``device``, its state_dict on the host):
    seeded weights and settled statistics (``benchmark/weights.py``)."""
    from benchmark import weights

    model = part_of(opt).build(opt).to(device)
    weights.fill(model, weights.generator(seed, 1, device))
    weights.settle(model, weights.generator(seed, 2, device))
    model.eval()
    return model, weights.state_of(model)


def write_checkpoint(path: str, opt, state: Dict) -> str:
    """A reference-style ``.pth`` (``model.module.`` keys, the options as an
    argparse namespace), the file users render from."""
    import torch

    ns = argparse.Namespace(**{k: list(v) if isinstance(v, tuple) else v
                               for k, v in dataclasses.asdict(opt).items()})
    torch.save({"state_dict": {"model.module." + k: v for k, v in state.items()},
                "opts": ns, "epoch": 0}, path)
    return path


def sample_scenes(pool: Dict, seed: int, k: int) -> List[int]:
    """The scenes whose window answers are checked: the largest, and k - 1
    others drawn from the seed."""
    n = len(pool["flows"])
    rng = generate.rng_for(seed, 3)
    largest = int(np.argmax(pool["areas"]))
    others = [int(i) for i in rng.permutation([i for i in range(n) if i != largest])[:k - 1]]
    return [largest] + others


def frame_mad_max(port_u8: Dict[int, np.ndarray], ref_u8: Dict[int, np.ndarray]) -> float:
    """The largest, over the checked scenes' frames, of a frame's mean
    absolute difference in 8-bit levels."""
    worst = 0.0
    for i, got in port_u8.items():
        d = np.abs(got.astype(np.int16) - ref_u8[i].astype(np.int16))
        worst = max(worst, float(d.reshape(d.shape[0], -1).mean(1).max()))
    return worst


def reference_frames(model, mix: Dict, pool: Dict, scenes, dtype=None,
                     quantize=None) -> Dict[int, np.ndarray]:
    """The reference's uint8 frames of ``scenes``, in float32 (or
    ``dtype``, with ``quantize`` applied to the model: the control)."""
    import torch

    from benchmark.reference import render as ref

    part = part_of(model.opt)
    dtype = dtype or torch.float32
    model = model.to(dtype)
    N = mix["n_frames"]

    def decode_batch_for(area: int) -> int:
        db = max(1, min(N, REF_DECODE_PX // max(1, area)))
        while N % db:
            db -= 1
        return db

    out = {}
    with quantize(model) if quantize else contextlib.nullcontext():
        for i in scenes:
            frames, _ = part.render_frames(
                model, pool["images"][i], pool["flows"][i], N,
                mix["sparsify_eps_times_n"] / N, mix["p_bucket_ratio"], decode_batch_for,
                dtype, mix["crop_decode"] == "auto")
            out[i] = ref.to_u8(frames)
            del frames
    return out


def trace_bounds(opt, mix: Dict, cfg: Dict, pool: Dict, scenes: List[int], device) -> Dict:
    """The traced scenes' K2 bound (seconds, by the frozen count) and
    reference flops, each scene at the reference's own crop plan."""
    part = part_of(opt)
    k2 = fl = 0.0
    for i in scenes:
        k, f = part.scene_work(opt, mix, pool["flows"][i], cfg["splat_channels"], device)
        k2, fl = k2 + k, fl + f
    return {"k2_s": k2, "flops": fl}


def run(args, cell: Dict, mix: Dict, cfg: Dict, limits: Dict, t_start: float,
        device="cuda") -> Dict:
    import torch

    from slrsfs_tpu_torch import kernels
    from slrsfs_tpu_torch.cli.render import SceneRenderer, outputs_to_u8

    dev = torch.device(device)
    r = Readings(cell=cell, traffic=mix, config=cfg, dtype=mix["dtype"])
    tmp = harness.scratch_dir()
    opt = options(cfg, mix)
    ref_model, state = make_weights(opt, args.seed, dev)
    ref_model.cpu()
    ckpt = write_checkpoint(os.path.join(tmp, "weights.pth"), opt, state)
    pool = generate.scene_pool(mix, args.seed)
    N = mix["n_frames"]
    renderer = SceneRenderer(ckpt=ckpt, W=mix["W"], n_frames=N, dtype=mix["dtype"],
                             sparsify_eps=mix["sparsify_eps_times_n"] / N,
                             crop_decode=mix["crop_decode"],
                             p_bucket_ratio=mix["p_bucket_ratio"], device=device)
    os.remove(ckpt)

    def scene(i: int):
        with span("scene_flow"):
            flow = renderer.scene_flow(pool["images"][i], pool["flows"][i], f"scene{i:02d}")
        with span("frames"):
            out = renderer.frames(pool["images"][i], flow)
        with span("to_u8"):
            u8 = outputs_to_u8(out)["PredImg"]
        return u8

    for i in sorted(set(pool["order"])):  # every shape of the pool, once
        scene(i)
    checked = sample_scenes(pool, args.seed, mix["check_scenes"])
    kept: Dict[int, np.ndarray] = {}
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    shapes_before = len(renderer.shapes)
    order = pool["order"]
    r.setup_s = now() - t_start
    t0 = now()
    k = 0
    n = len(pool["flows"])
    # whole passes over the pool: every run renders the same scenes
    while now() - t0 < args.seconds or k % n:
        i = order[k % len(order)]
        ts = now()
        u8 = scene(i)
        r.scene_s.append(now() - ts)
        r.frames += u8.shape[0]
        if i in checked and i not in kept:
            kept[i] = u8
        k += 1
    r.window_s = now() - t0
    if dev.type == "cuda":
        r.peak_bytes = torch.cuda.max_memory_allocated()
    print(f"window: {len(r.scene_s)} scenes, {r.frames} frames in {r.window_s:.3f} s; "
          f"launches {({n: c for n, c in kernels.counts().items() if c})}; "
          f"new (P, window) shapes in the window: {len(renderer.shapes) - shapes_before} "
          f"of {len(renderer.shapes)}; moving shares {[round(a, 3) for a in pool['areas']]}",
          flush=True)

    breakdown = None
    if args.trace:
        sl = [order[(k + j) % len(order)] for j in range(mix["trace_scenes"])]
        r.trace = harness.traced(lambda: [scene(i) for i in sl], tmp)
        b = trace_bounds(opt, mix, cfg, pool, sl, dev)
        r.bounds["k2"], r.flops = b["k2_s"], b["flops"]
        i = sl[0]
        flow = renderer.scene_flow(pool["images"][i], pool["flows"][i], f"scene{i:02d}")
        r.extra.update(part_of(opt).program_readings(renderer, pool["images"][i], flow, N))
        breakdown = {"device_ops": r.trace["device_ops"], "idle_gaps": r.trace["idle_gaps"]}
    renderer.close()
    del renderer
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    ref_model = ref_model.to(dev)
    ref = reference_frames(ref_model, mix, pool, list(kept))
    mad = frame_mad_max(kept, ref)
    checks = {"frame_mad_max": {"value": mad, "limit": limits["frame_mad_max"]}}
    os.rmdir(tmp)
    return {"readings": r, "checks": checks, "attempted": len(r.scene_s), "failed": 0,
            "breakdown": breakdown}
