#!/usr/bin/env python3
"""Smoke test of the PyTorch port (slrsfs_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/, holds each against its plain
PyTorch version at the main path's shapes, renders a synthetic 256^2 scene
(60 frames, half the rows moving, full-width baseline with random weights
from a seed) through SceneRenderer in float32 and bfloat16, times the
kernels and the render with CUDA events, and prints:

* one line per phase (and ptxas's register/spill report per kernel);
* the card's name and power limit as nvidia-smi reports them;
* one JSON line {"kernels": [...]} with each kernel's launches on the main
  path, error against its plain version, times and bound;
* last, {"ok": true, "device": {...}}.

Any failed check raises and the script exits non-zero without the last
line. It also fails when no CUDA device is present. The rendered PNGs go
to build/chip_smoke/ (git-ignored).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

H = W = 256
N_FRAMES = 60
SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "build", "chip_smoke")


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def synthetic_scene(seed: int):
    """uint8 image and a smooth flow whose bottom half of rows moves (exact
    zeros elsewhere), both from a numpy seed."""
    rng = np.random.default_rng(seed)
    coarse = rng.uniform(0, 255, (H // 16, W // 16, 3))
    img = np.kron(coarse, np.ones((16, 16, 1))) + rng.normal(0, 8, (H, W, 3))
    img_u8 = np.clip(img, 0, 255).astype(np.uint8)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    flow = np.stack([1.5 * np.sin(yy / 17.0) + 0.6 * np.cos(xx / 23.0),
                     0.8 * np.cos(xx / 29.0) + 0.3], axis=-1).astype(np.float32)
    flow += rng.normal(0, 0.05, flow.shape).astype(np.float32)
    flow[: H // 2] = 0.0
    return img_u8, flow


def cuda_time(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of ``fn`` over ``reps`` calls (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from slrsfs_tpu_torch import kernels
    from slrsfs_tpu_torch.cli.render import SceneRenderer, to_u8
    from slrsfs_tpu_torch.engine.rollout import prepare_scene_sparse
    from slrsfs_tpu_torch.ops.euler import euler_compact_dual, euler_compact_dual_plain
    from slrsfs_tpu_torch.ops.splat import (
        _corner_taps,
        splat_dual_normalize,
        splat_dual_normalize_plain,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    os.makedirs(OUT_DIR, exist_ok=True)

    # ---- phase 1: card and build -------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"phase 1 device: {kind}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; nvidia-smi: {smi}")
    t0 = time.perf_counter()
    times = kernels.build_all()
    print(f"phase 1 build: {time.perf_counter() - t0:.1f} s wall, "
          + ", ".join(f"{n} {s:.1f} s" for n, s in times.items()))
    for k in kernels.KERNELS:  # ptxas: registers, spills per kernel
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"phase 1 ptxas {k.name}: {line.strip()}")

    img_u8, flow_np = synthetic_scene(SEED)
    img = (img_u8.astype(np.float32) / 255.0 - 0.5) / 0.5  # the CLI's input
    pos_np, val_np = prepare_scene_sparse(flow_np)
    P = pos_np.shape[0]
    flow = torch.from_numpy(flow_np).to(dev)
    positions = torch.from_numpy(pos_np).to(dev)
    valid = torch.from_numpy(val_np).to(dev)
    n_valid = int(val_np.sum())

    # ---- phase 2: K1 against its plain version, bit for bit ----------
    quarter = torch.round(flow * 4.0) / 4.0  # half-integer rounding ties
    k1_err = 0.0
    for label, m in (("scene", flow), ("quarter-pixel", quarter)):
        kf, kb = euler_compact_dual(m, positions, N_FRAMES - 1, N_FRAMES)
        pf, pb = euler_compact_dual_plain(m, positions, N_FRAMES - 1, N_FRAMES)
        torch.cuda.synchronize()
        check(torch.equal(kf, pf) and torch.equal(kb, pb),
              f"K1 {label}: kernel differs from plain")
        k1_err = max(k1_err, (kf - pf).abs().max().item(),
                     (kb - pb).abs().max().item())
        n_oob = int((kb[-1, :, 0] > W).sum())
        print(f"phase 2 K1 {label}: P={P} steps={N_FRAMES - 1}/{N_FRAMES} "
              f"bit-exact; {n_oob} trajectories left the frame")
    disp_f, disp_b = pf, pb

    # ---- phase 3: K2 against its plain version -----------------------
    rng = np.random.default_rng(SEED + 1)
    C1 = 65
    ez = np.exp(-rng.uniform(0, 3, (H, W, 1))).astype(np.float32)
    u_np = np.concatenate([rng.normal(0, 1, (H, W, C1 - 1)).astype(np.float32)
                           * ez, ez], -1)
    u = torch.from_numpy(u_np).to(dev)
    static = (flow.abs().sum(-1) == 0).to(torch.float32)
    u_static = (u * static[..., None]).contiguous()
    px, py = positions[:, 0].long(), positions[:, 1].long()
    u_mov = (u[py, px] * valid[:, None]).contiguous()
    out = torch.empty((H, W, C1 - 1), dtype=torch.float32, device=dev)
    acc = torch.empty((H * W * C1,), dtype=torch.float32, device=dev)
    k2_err = 0.0

    def k2_compare(label, da, db, a, b, out_dtype=torch.float32, rtol=1e-5):
        nonlocal k2_err
        o = torch.empty((H, W, C1 - 1), dtype=out_dtype, device=dev)
        splat_dual_normalize(u_mov, positions, valid, da, db, a, b, u_static,
                             out=o, acc=acc)
        ref = splat_dual_normalize_plain(u_mov, positions, valid, da, db, a, b,
                                         u_static, out_dtype)
        torch.cuda.synchronize()
        err = (o.float() - ref.float()).abs().max().item()
        check(torch.allclose(o.float(), ref.float(), rtol=rtol, atol=1e-5),
              f"K2 {label}: max abs {err}")
        check(torch.equal(o == 0, ref == 0), f"K2 {label}: zero pattern differs")
        if out_dtype == torch.float32:
            k2_err = max(k2_err, err)
        print(f"phase 3 K2 {label}: max abs {err:.3g} (atol 1e-5, rtol "
              f"{rtol:g}); zeros match")

    for t in (0, 1, 30, 59):
        a = np.float32(1.0) - np.float32(t) / np.float32(N_FRAMES)
        k2_compare(f"t={t}", disp_f[t], disp_b[N_FRAMES - t], float(a),
                   float(np.float32(1.0) - a))
    # sentinel, exact integer shifts and fractional border landings
    special = disp_f[30].clone()
    special[0::3] = float(max(H, W) + 1)
    special[1::3] = torch.tensor([3.0, -2.0], device=dev)
    special[2::3] = torch.tensor([-0.75, -127.5], device=dev)
    k2_compare("sentinel/integer/border", special, disp_b[30], 0.5, 0.5)
    k2_compare("t=30 bf16 out", disp_f[30], disp_b[30], 0.5, 0.5,
               out_dtype=torch.bfloat16, rtol=1e-2)

    # ---- phase 4: the main path through SceneRenderer.render ---------
    import cv2
    from PIL import Image

    scene_dir = os.path.join(OUT_DIR, "scene")
    os.makedirs(scene_dir, exist_ok=True)
    img_path = os.path.join(scene_dir, "synthetic.png")
    flow_path = os.path.join(scene_dir, "synthetic_motion.npy")
    Image.fromarray(img_u8).save(img_path)
    np.save(flow_path, flow_np)
    r32 = SceneRenderer(W=W, n_frames=N_FRAMES, dtype="float32", seed=SEED,
                        sparsify_eps=0.0)
    rbf = SceneRenderer(W=W, n_frames=N_FRAMES, dtype="bfloat16", seed=SEED,
                        sparsify_eps=0.0)
    db = r32.decode_batch_for(H * W)

    kernels.reset_counts()
    out_dir = r32.render(img_path, flow_path, scene_dir, name="synthetic",
                         rawsize=True)
    torch.cuda.synchronize()
    launches = kernels.counts()
    check(launches["euler_compact_dual"] == 1,
          f"K1 launches on the render: {launches}")
    check(launches["splat_dual_normalize"] == N_FRAMES,
          f"K2 launches on the render: {launches}")
    pngs = sorted(os.listdir(os.path.join(out_dir, "PredImg")))
    check(len(pngs) == N_FRAMES, f"{len(pngs)} PNGs written")

    frames32 = r32.frames(img, flow_np)
    plain32 = r32.frames(img, flow_np, plain=True)
    framesbf = rbf.frames(img, flow_np)
    torch.cuda.synchronize()
    for label, fr in (("float32", frames32), ("bfloat16", framesbf)):
        check(tuple(fr.shape) == (N_FRAMES, H, W, 3), f"{label} shape {fr.shape}")
        check(bool(torch.isfinite(fr).all()), f"{label} frames not finite")
    path_err = (frames32 - plain32).abs().max().item()
    check(path_err <= 1e-4, f"kernel path vs plain path max abs {path_err}")
    bf_err = (framesbf - frames32).abs().max().item()
    u8 = to_u8(frames32).cpu().numpy()
    for t in (0, N_FRAMES - 1):
        png = cv2.cvtColor(cv2.imread(os.path.join(out_dir, "PredImg", pngs[t])),
                           cv2.COLOR_BGR2RGB)
        check(np.array_equal(png, u8[t]), f"PNG {t} differs from the frame")
    print(f"phase 4 render: {N_FRAMES} PNGs {H}x{W} in {out_dir}, decode "
          f"batch {db}; "
          f"launches {launches}; kernel vs plain path (f32) max abs "
          f"{path_err:.3g} (limit 1e-4); bf16 vs f32 max abs {bf_err:.3g}; "
          f"frame range [{frames32.min().item():.3f}, {frames32.max().item():.3f}], "
          f"std {frames32.std().item():.3f}")

    # ---- phase 5: times, bounds, peak memory -------------------------
    ms_k1 = cuda_time(lambda: euler_compact_dual(flow, positions, N_FRAMES - 1,
                                                 N_FRAMES), reps=20)
    ms_k1_plain = cuda_time(lambda: euler_compact_dual_plain(
        flow, positions, N_FRAMES - 1, N_FRAMES), reps=3, warmup=1)
    a30 = 0.5
    k2_args = (u_mov, positions, valid, disp_f[30], disp_b[30], a30, a30,
               u_static)
    ms_k2 = cuda_time(lambda: splat_dual_normalize(*k2_args, out=out, acc=acc),
                      reps=50)
    ms_k2_plain = cuda_time(lambda: splat_dual_normalize_plain(
        *k2_args, torch.float32), reps=10)
    # yardstick: the same scatter as ONE index_add_ into the flat buffer
    lins, rows = [], []
    for d, w_t in ((disp_f[30], a30), (disp_b[30], a30)):
        for lin, w in _corner_taps(px.float() + d[:, 0], py.float() + d[:, 1],
                                   H, W):
            lins.append(lin)
            rows.append(u_mov * w_t * (w * valid)[:, None])
    lin_all, rows_all = torch.cat(lins), torch.cat(rows)
    flat = u_static.reshape(H * W, C1).clone()
    ms_lib = cuda_time(lambda: flat.index_add_(0, lin_all, rows_all), reps=50)

    steps = (N_FRAMES - 1) + N_FRAMES
    k1_bytes = H * W * 8 + P * 8 + (steps + 2) * P * 8
    k1_ops = steps * P * 12  # round x2, add x2, 4 compares, sub x2, 2 sel
    # moving rows, positions and both displacements of the valid rows; the
    # valid flags of all rows; the static identity in, the field out
    k2_bytes = (n_valid * (C1 * 4 + 8 + 16) + P * 4
                + H * W * C1 * 4 + H * W * (C1 - 1) * 4)
    k2_ops = 2 * n_valid * C1 * (1 + 4 * 2) + H * W * (C1 - 1)
    bounds = {}
    for name, nb, no in (("euler_compact_dual", k1_bytes, k1_ops),
                         ("splat_dual_normalize", k2_bytes, k2_ops)):
        tb, to = nb / HBM_BYTES_PER_S * 1e3, no / FP32_FLOPS * 1e3
        bounds[name] = (max(tb, to), "bytes" if tb >= to else "operations")
    print(f"phase 5 K1: {ms_k1:.4f} ms (plain {ms_k1_plain:.3f} ms, bound "
          f"{bounds['euler_compact_dual'][0]:.4f} ms by "
          f"{bounds['euler_compact_dual'][1]})")
    print(f"phase 5 K2: {ms_k2:.4f} ms/frame (plain {ms_k2_plain:.3f} ms, "
          f"index_add_ {ms_lib:.4f} ms, bound "
          f"{bounds['splat_dual_normalize'][0]:.4f} ms by "
          f"{bounds['splat_dual_normalize'][1]})")

    # stage breakdown of one f32 render at these shapes
    img_t = torch.from_numpy(img[None]).to(dev)
    with torch.no_grad():
        ms_enc = cuda_time(lambda: r32.model.encode(img_t), reps=5)
        chunk = torch.randn((db, H, W, C1 - 1), device=dev)
        ms_dec32 = cuda_time(lambda: r32.model.decode(chunk), reps=2, warmup=1)
        chunk_bf = chunk.to(torch.bfloat16)
        ms_decbf = cuda_time(lambda: rbf.model.decode(chunk_bf), reps=2, warmup=1)
    print(f"phase 5 stages (f32 unless noted): encode {ms_enc:.2f} ms; K1 "
          f"{ms_k1:.3f} ms; K2 x{N_FRAMES} {ms_k2 * N_FRAMES:.2f} ms; decode "
          f"{N_FRAMES} frames {ms_dec32:.1f} ms (bf16 {ms_decbf:.1f} ms)")

    fps = {}
    for label, r in (("float32", r32), ("bfloat16", rbf)):
        r.frames(img, flow_np)
        torch.cuda.synchronize()
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            r.frames(img, flow_np)
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        fps[label] = N_FRAMES / sorted(ts)[1]
        print(f"phase 5 render {label}: median {sorted(ts)[1] * 1e3:.1f} ms "
              f"= {fps[label]:.2f} frames/s (runs {[round(x * 1e3, 1) for x in ts]} ms)")

    total = torch.cuda.get_device_properties(0).total_memory
    for label, r, ch in (("float32", r32, chunk), ("bfloat16", rbf, chunk_bf)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with torch.no_grad():
            r.model.decode(ch)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        per_px = peak / (db * H * W)
        print(f"phase 5 peak memory {label}: decode chunk of {db} frames at "
              f"{H}^2 adds {peak / 2**30:.2f} GiB = {per_px:.0f} B per "
              f"pixel-frame; half of {total / 2**30:.1f} GiB holds "
              f"{int(total / 2 / per_px):,} pixel-frames")

    # ---- phase 6: summary --------------------------------------------
    rows_out = [
        {"name": "euler_compact_dual", "route": "cuda",
         "source": "slrsfs_tpu_torch/csrc/euler.cu",
         "replaces": "slrsfs_tpu/ops/euler.py:145",
         "launches": launches["euler_compact_dual"], "max_abs_err": k1_err,
         "ms": ms_k1, "plain_ms": ms_k1_plain,
         "bound_ms": bounds["euler_compact_dual"][0],
         "bound_by": bounds["euler_compact_dual"][1], "library_ms": None},
        {"name": "splat_dual_normalize", "route": "cuda",
         "source": "slrsfs_tpu_torch/csrc/splat.cu",
         "replaces": "slrsfs_tpu/ops/splat.py:390",
         "launches": launches["splat_dual_normalize"], "max_abs_err": k2_err,
         "ms": ms_k2, "plain_ms": ms_k2_plain,
         "bound_ms": bounds["splat_dual_normalize"][0],
         "bound_by": bounds["splat_dual_normalize"][1], "library_ms": ms_lib},
    ]
    print(f"phase 6 render fps: float32 {fps['float32']:.2f}, bfloat16 "
          f"{fps['bfloat16']:.2f}; all checks passed")
    print(smi)
    print(json.dumps({"kernels": rows_out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
