#!/usr/bin/env python3
"""Smoke test of the PyTorch port (slrsfs_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ (one nvcc per source, all at
once), holds each against its plain PyTorch version at the main paths'
shapes, and renders a synthetic 256^2 scene (60 frames, half the rows
moving, random weights from a seed) through SceneRenderer.render with:

* the full-width baseline (model_type=softmax_splating), float32 and
  bfloat16: kernels K1 (Euler) and K2 (splat + normalise); and float32
  with the v2 Z-norm, which adds K5 (its dense check path runs K6);
* the full-width SLR two-layer model (use_alpha0_as_blending_weight),
  float32 and bfloat16 with the default Z-norm, and float32 with the v2 Z-norm:
  K1, K2's SLR epilogue and, for v2, K5 (sparse maximum-warp norm); its
  dense check path runs K6 (dense maximum-warp norm).

Each path runs with the launch counts set to 0 just before it and read just
after. The script times the kernels and the renders with CUDA events and
prints:

* one line per phase (and ptxas's register/spill report per kernel);
* the card's name and power limit as nvidia-smi reports them;
* one JSON line {"kernels": [...]} with each kernel's launches on its path,
  error against its plain version, times and bound;
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
T_MID = N_FRAMES // 2
T_CHECK = (0, 1, T_MID, N_FRAMES - 1)  # frames the kernels are checked at
SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
SLR_OPTS = dict(model_type="softmax_splating_2layers_alpha_seperate",
                use_alpha0_as_blending_weight=True)
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


def bound(n_bytes: float, n_ops: float):
    """(least ms, 'bytes' or 'operations') on the card's peak rates."""
    tb, to = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / FP32_FLOPS * 1e3
    return max(tb, to), "bytes" if tb >= to else "operations"


def render_median(r, img, flow, reps: int = 3):
    """Median seconds of ``r.frames`` over ``reps`` runs after one warm-up."""
    import torch

    r.frames(img, flow)
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        r.frames(img, flow)
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2], ts


def render_capture(r, *args, **kw):
    """``r.render(*args, **kw)`` and the outputs that render computed and
    wrote: (out_dir, frames or dict of outputs)."""
    got = {}
    frames = r.frames

    def spy(*a, **k):
        got["out"] = frames(*a, **k)
        return got["out"]

    r.frames = spy
    try:
        out_dir = r.render(*args, **kw)
    finally:
        del r.frames
    return out_dir, got["out"]


def read_png(path):
    import cv2

    return cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from slrsfs_tpu_torch import kernels
    from slrsfs_tpu_torch.cli.render import SceneRenderer, outputs_to_u8, to_u8
    from slrsfs_tpu_torch.engine import rollout
    from slrsfs_tpu_torch.engine.rollout import prepare_scene_sparse
    from slrsfs_tpu_torch.ops import maxwarp
    from slrsfs_tpu_torch.ops.euler import (
        euler_compact_dual,
        euler_compact_dual_plain,
        euler_integrate_all_dual,
    )
    from slrsfs_tpu_torch.ops.splat import (
        _corner_taps,
        corners,
        splat_dual_normalize,
        splat_dual_normalize_plain,
        splat_dual_normalize_slr,
        splat_dual_normalize_slr_plain,
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
    rng = np.random.default_rng(SEED + 1)

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
    special = disp_f[T_MID].clone()  # sentinel, integer shifts, border landings
    special[0::3] = float(max(H, W) + 1)
    special[1::3] = torch.tensor([3.0, -2.0], device=dev)
    special[2::3] = torch.tensor([-0.75, -127.5], device=dev)

    # ---- phase 3: K2, both epilogues, against the plain versions -----
    static = (flow.abs().sum(-1) == 0).to(torch.float32)
    px, py = positions[:, 0].long(), positions[:, 1].long()
    ez = np.exp(-rng.uniform(0, 3, (H, W, 1))).astype(np.float32)
    ec = np.exp(rng.uniform(0, 1, (H, W, 1))).astype(np.float32)
    feats = rng.normal(0, 1, (H, W, 64)).astype(np.float32)
    layouts = {  # baseline [fs·e^Z, e^Z]; SLR [fs·e^Z, af·e^C, e^C, e^Z]
        "K2": np.concatenate([feats * ez, ez], -1),
        "K2-SLR": np.concatenate([feats * ez, feats[..., :1] * ec, ec, ez], -1)}
    k2 = {}
    for name, u_np in layouts.items():
        u = torch.from_numpy(u_np).to(dev)
        slr = name == "K2-SLR"
        n_norm = 2 if slr else 1
        wrapper = splat_dual_normalize_slr if slr else splat_dual_normalize
        plain = splat_dual_normalize_slr_plain if slr else splat_dual_normalize_plain
        C1 = u.shape[-1]
        st = dict(u_static=(u * static[..., None]).contiguous(),
                  u_mov=(u[py, px] * valid[:, None]).contiguous(), C1=C1,
                  wrapper=wrapper, plain=plain, n_norm=n_norm, err=0.0,
                  acc=torch.empty((H * W * C1,), dtype=torch.float32, device=dev),
                  out=torch.empty((H, W, C1 - n_norm), dtype=torch.float32,
                                  device=dev))
        k2[name] = st

        def compare(label, da, db, a, b, out_dtype=torch.float32, rtol=1e-5):
            o = torch.empty((H, W, C1 - n_norm), dtype=out_dtype, device=dev)
            wrapper(st["u_mov"], positions, valid, da, db, a, b, st["u_static"],
                    out=o, acc=st["acc"])
            ref = plain(st["u_mov"], positions, valid, da, db, a, b,
                        st["u_static"], out_dtype)
            torch.cuda.synchronize()
            err = (o.float() - ref.float()).abs().max().item()
            check(torch.allclose(o.float(), ref.float(), rtol=rtol, atol=1e-5),
                  f"{name} {label}: max abs {err}")
            check(torch.equal(o == 0, ref == 0),
                  f"{name} {label}: zero pattern differs")
            if out_dtype == torch.float32:
                st["err"] = max(st["err"], err)
            print(f"phase 3 {name} {label}: max abs {err:.3g} (atol 1e-5, "
                  f"rtol {rtol:g}); zeros match")

        for t in T_CHECK:
            a = np.float32(1.0) - np.float32(t) / np.float32(N_FRAMES)
            compare(f"t={t}", disp_f[t], disp_b[N_FRAMES - t], float(a),
                    float(np.float32(1.0) - a))
        compare("sentinel/integer/border", special, disp_b[T_MID], 0.5, 0.5)
        compare(f"t={T_MID} bf16 out", disp_f[T_MID], disp_b[T_MID], 0.5, 0.5,
                out_dtype=torch.bfloat16, rtol=1e-2)

    # ---- phase 4: K5 and K6 against the plain versions, bit for bit ---
    z2d = torch.from_numpy((rng.standard_normal((H, W)) * 3.0)
                           .astype(np.float32)).to(dev)
    z_mov = z2d[py, px].contiguous()
    k5_err = k6_err = 0.0
    for label, d in [(f"t={t}", disp_f[t]) for t in T_CHECK] + [
            ("sentinel/integer/border", special)]:
        kd, km = maxwarp.maximum_warp_norm_sparse(z2d, static, z_mov, positions,
                                                  valid, d)
        pd, pm = maxwarp.maximum_warp_norm_sparse_plain(z2d, static, z_mov,
                                                        positions, valid, d)
        torch.cuda.synchronize()
        check(torch.equal(kd, pd) and torch.equal(km, pm),
              f"K5 {label}: kernel differs from plain")
        k5_err = max(k5_err, (kd - pd).abs().max().item(),
                     (km - pm).abs().max().item())
        print(f"phase 4 K5 {label}: bit-exact (P={P}, {int((pm > z_mov).sum())} "
              f"moving rows raised by a neighbour)")
    dense_f, _ = euler_integrate_all_dual(flow, N_FRAMES - 1, 1)
    special_dense = dense_f[T_MID].reshape(-1, 2).clone()
    special_dense[0::3] = float(max(H, W) + 1)
    special_dense[1::3] = torch.tensor([3.0, -2.0], device=dev)
    special_dense[2::3] = torch.tensor([-0.75, -127.5], device=dev)
    z4 = z2d[None, ..., None].contiguous()
    for label, fl in [(f"t={t}", dense_f[t]) for t in T_CHECK] + [
            ("sentinel/integer/border", special_dense.reshape(H, W, 2))]:
        fl = fl[None].contiguous()
        got = maxwarp.maximum_warp_norm_splat(z4, fl)
        want = maxwarp.maximum_warp_norm_splat_plain(z4, fl)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"K6 {label}: kernel differs from plain")
        k6_err = max(k6_err, (got - want).abs().max().item())
        print(f"phase 4 K6 {label}: bit-exact ({int((want > z4).sum())} pixels "
              f"raised by a neighbour)")

    # ---- phase 5: the baseline path through SceneRenderer.render -----
    from PIL import Image

    scene_dir = os.path.join(OUT_DIR, "scene")
    os.makedirs(scene_dir, exist_ok=True)
    img_path = os.path.join(scene_dir, "synthetic.png")
    flow_path = os.path.join(scene_dir, "synthetic_motion.npy")
    region_path = os.path.join(scene_dir, "region.png")
    Image.fromarray(img_u8).save(img_path)
    np.save(flow_path, flow_np)
    region_u8 = np.zeros((H, W), np.uint8)
    region_u8[H // 4:, W // 8: 7 * W // 8] = 255
    Image.fromarray(region_u8).save(region_path)
    region = np.asarray(Image.open(region_path).convert("L").resize((W, W)),
                        np.float32) / 255.0  # as render() reads it

    r32 = SceneRenderer(W=W, n_frames=N_FRAMES, dtype="float32", seed=SEED,
                        sparsify_eps=0.0)
    rbf = SceneRenderer(W=W, n_frames=N_FRAMES, dtype="bfloat16", seed=SEED,
                        sparsify_eps=0.0)
    db = r32.decode_batch_for(H * W)

    kernels.reset_counts()
    out_dir, frames32 = render_capture(
        r32, img_path, flow_path, os.path.join(scene_dir, "baseline"),
        name="synthetic", rawsize=True)
    torch.cuda.synchronize()
    launches = kernels.counts()
    check(launches == {**{k.name: 0 for k in kernels.KERNELS},
                       "euler_compact_dual": 1, "splat_dual_normalize": N_FRAMES},
          f"baseline render launches: {launches}")
    pngs = sorted(os.listdir(os.path.join(out_dir, "PredImg")))
    check(len(pngs) == N_FRAMES, f"{len(pngs)} PNGs written")

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
        png = read_png(os.path.join(out_dir, "PredImg", pngs[t]))
        check(np.array_equal(png, u8[t]), f"PNG {t} differs from the frame")
    print(f"phase 5 baseline render: {N_FRAMES} PNGs {H}x{W} in {out_dir}, "
          f"decode batch {db}; launches {launches}; kernel vs plain path (f32) "
          f"max abs {path_err:.3g} (limit 1e-4); bf16 vs f32 max abs "
          f"{bf_err:.3g}; frame range [{frames32.min().item():.3f}, "
          f"{frames32.max().item():.3f}], std {frames32.std().item():.3f}")

    # the baseline with the v2 Z-norm: K5 per frame; its dense form runs K6
    r32v2 = SceneRenderer(W=W, n_frames=N_FRAMES, dtype="float32", seed=SEED,
                          sparsify_eps=0.0,
                          opt_overrides=dict(use_softmax_splatter_v2=True))
    kernels.reset_counts()
    out_dir, v2_frames = render_capture(
        r32v2, img_path, flow_path, os.path.join(scene_dir, "baseline v2"),
        name="synthetic", rawsize=True)
    torch.cuda.synchronize()
    v2_launches = kernels.counts()
    check(v2_launches == {**{k.name: 0 for k in kernels.KERNELS},
                          "euler_compact_dual": 1,
                          "splat_dual_normalize": N_FRAMES,
                          "maximum_warp_norm_sparse": N_FRAMES},
          f"baseline v2 render launches: {v2_launches}")
    v2_plain = r32v2.frames(img, flow_np, plain=True)
    kernels.reset_counts()
    v2_dense = rollout.baseline_rollout(r32v2.model, torch.from_numpy(img[None]).to(dev),
                                        flow, N_FRAMES)
    torch.cuda.synchronize()
    v2_dense_launches = kernels.counts()["maximum_warp_norm_splat"]
    check(v2_dense_launches == N_FRAMES,
          f"baseline dense v2 K6 launches: {v2_dense_launches}")
    v2_path_err = (v2_frames - v2_plain).abs().max().item()
    v2_dense_err = (v2_frames - v2_dense).abs().max().item()
    check(v2_path_err <= 1e-4, f"baseline v2 kernel vs plain path {v2_path_err}")
    check(v2_dense_err <= 1e-4, f"baseline sparse v2 vs dense v2 {v2_dense_err}")
    png = read_png(os.path.join(out_dir, "PredImg", f"{N_FRAMES - 1:06d}.png"))
    check(np.array_equal(png, to_u8(v2_frames[-1]).cpu().numpy()),
          "baseline v2 PNG differs from the frame")
    print(f"phase 5 baseline v2 render: launches {v2_launches}; kernel vs "
          f"plain path max abs {v2_path_err:.3g}, sparse v2 (K5) vs dense v2 "
          f"(K6, launches {v2_dense_launches}) max abs {v2_dense_err:.3g} "
          f"(limits 1e-4)")

    # ---- phase 6: the SLR paths through SceneRenderer.render ---------
    slr = {
        "float32": SceneRenderer(W=W, n_frames=N_FRAMES, dtype="float32",
                                 seed=SEED, sparsify_eps=0.0,
                                 opt_overrides=SLR_OPTS),
        "bfloat16": SceneRenderer(W=W, n_frames=N_FRAMES, dtype="bfloat16",
                                  seed=SEED, sparsify_eps=0.0,
                                  opt_overrides=SLR_OPTS),
        "float32 v2": SceneRenderer(W=W, n_frames=N_FRAMES, dtype="float32",
                                    seed=SEED, sparsify_eps=0.0,
                                    opt_overrides=dict(
                                        SLR_OPTS, use_softmax_splatter_v2=True)),
    }
    slr_db = slr["float32"].decode_batch_for(H * W)
    slr_launches = {}
    slr_frames = {}
    for label, r in slr.items():
        v2 = label.endswith("v2")  # the v2 render also takes an edit region
        kernels.reset_counts()
        out_dir, outs = render_capture(
            r, img_path, flow_path, os.path.join(scene_dir, "slr " + label),
            name="synthetic", rawsize=True,
            alpha_region_path=region_path if v2 else None)
        torch.cuda.synchronize()
        got = kernels.counts()
        want = {**{k.name: 0 for k in kernels.KERNELS}, "euler_compact_dual": 1,
                "splat_dual_normalize_slr": N_FRAMES,
                "maximum_warp_norm_sparse": N_FRAMES if v2 else 0}
        check(got == want, f"SLR {label} render launches: {got}")
        slr_launches[label] = got
        slr_frames[label] = outs
        shapes = {"PredImg": (N_FRAMES, H, W, 3), "FluidImg": (N_FRAMES, H, W, 3),
                  "CompositeFluidAlpha": (N_FRAMES, H, W, 1), "BGImg": (H, W, 3)}
        check({k: tuple(v.shape) for k, v in outs.items()} == shapes,
              f"SLR {label} outputs {[(k, v.shape) for k, v in outs.items()]}")
        for k, v in outs.items():
            check(bool(torch.isfinite(v).all()), f"SLR {label} {k} not finite")
        # the PNGs are the render's own outputs, quantised (a second render
        # may differ by a u8 level: K2's atomic order)
        q = outputs_to_u8(outs)
        for k in ("PredImg", "FluidImg", "CompositeFluidAlpha", "BGImg"):
            if k == "BGImg":
                pairs = [(read_png(os.path.join(out_dir, "BGImg.png")), q[k])]
            else:
                names = sorted(os.listdir(os.path.join(out_dir, k)))
                check(len(names) == N_FRAMES,
                      f"SLR {label} {k}: {len(names)} PNGs")
                check(os.path.exists(os.path.join(out_dir, f"{k}_synthetic.mp4")),
                      f"SLR {label} {k}: no mp4")
                pairs = [(read_png(os.path.join(out_dir, k, names[t])),
                          np.repeat(q[k][t], 3, -1) if k == "CompositeFluidAlpha"
                          else q[k][t]) for t in (0, N_FRAMES - 1)]
            for png, frame in pairs:
                check(np.array_equal(png, frame),
                      f"SLR {label} {k} PNG differs from the frame")
        print(f"phase 6 SLR {label} render: 3 x {N_FRAMES} PNGs + BGImg.png in "
              f"{out_dir}, decode batch {slr_db}; launches {got}; PredImg range "
              f"[{outs['PredImg'].min().item():.3f}, "
              f"{outs['PredImg'].max().item():.3f}], alpha range "
              f"[{outs['CompositeFluidAlpha'].min().item():.3f}, "
              f"{outs['CompositeFluidAlpha'].max().item():.3f}]")

    def max_diff(a, b):
        return max((a[k].float() - b[k].float()).abs().max().item() for k in a)

    slr_path_err = {}
    for label in ("float32", "float32 v2"):
        rg = region if label.endswith("v2") else None
        plain = slr[label].frames(img, flow_np, plain=True, alpha_region=rg)
        slr_path_err[label] = max_diff(slr_frames[label], plain)
        check(slr_path_err[label] <= 1e-4,
              f"SLR {label} kernel path vs plain path max abs "
              f"{slr_path_err[label]}")
    slr_bf_err = max_diff(slr_frames["bfloat16"], slr_frames["float32"])
    img_t = torch.from_numpy(img[None]).to(dev)
    kernels.reset_counts()
    dense_v2 = rollout.slr_rollout_dense(
        slr["float32 v2"].model, img_t, flow, N_FRAMES,
        alpha_region=torch.from_numpy(region[None, ..., None]).to(dev))
    torch.cuda.synchronize()
    dense_launches = kernels.counts()
    check(dense_launches["maximum_warp_norm_splat"] == N_FRAMES,
          f"dense v2 render launches: {dense_launches}")
    sparse_dense_err = max_diff(slr_frames["float32 v2"], dense_v2)
    check(sparse_dense_err <= 1e-4,
          f"SLR sparse v2 (K5) vs dense v2 (K6) max abs {sparse_dense_err}")
    print(f"phase 6 SLR checks: kernel vs plain path max abs "
          f"{slr_path_err['float32']:.3g} (v2 {slr_path_err['float32 v2']:.3g}; "
          f"limit 1e-4); sparse v2 (K5) vs dense v2 (K6, launches "
          f"{dense_launches['maximum_warp_norm_splat']}) max abs "
          f"{sparse_dense_err:.3g} (limit 1e-4); bf16 vs f32 max abs "
          f"{slr_bf_err:.3g}")

    # ---- phase 7: times, bounds, peak memory -------------------------
    f32 = torch.float32
    ms_k1 = cuda_time(lambda: euler_compact_dual(flow, positions, N_FRAMES - 1,
                                                 N_FRAMES), reps=20)
    ms_k1_plain = cuda_time(lambda: euler_compact_dual_plain(
        flow, positions, N_FRAMES - 1, N_FRAMES), reps=3, warmup=1)
    a_mid = 0.5
    for name, st in k2.items():
        args = (st["u_mov"], positions, valid, disp_f[T_MID], disp_b[T_MID], a_mid, a_mid,
                st["u_static"])
        st["ms"] = cuda_time(lambda: st["wrapper"](*args, out=st["out"],
                                                   acc=st["acc"]), reps=50)
        st["plain_ms"] = cuda_time(lambda: st["plain"](*args, f32), reps=10)
        # yardstick: the same scatter as ONE index_add_ into the flat buffer
        lins, rows = [], []
        for d, w_t in ((disp_f[T_MID], a_mid), (disp_b[T_MID], a_mid)):
            for lin, w in _corner_taps(px.float() + d[:, 0], py.float() + d[:, 1],
                                       H, W):
                lins.append(lin)
                rows.append(st["u_mov"] * w_t * (w * valid)[:, None])
        lin_all, rows_all = torch.cat(lins), torch.cat(rows)
        flat = st["u_static"].reshape(H * W, st["C1"]).clone()
        st["lib_ms"] = cuda_time(lambda: flat.index_add_(0, lin_all, rows_all),
                                 reps=50)
        C1, C = st["C1"], st["C1"] - st["n_norm"]
        # moving rows, positions and both displacements of the valid rows;
        # the valid flags of all rows; the static identity in, the field out
        st["bound"] = bound(n_valid * (C1 * 4 + 8 + 16) + P * 4
                            + H * W * C1 * 4 + H * W * C * 4,
                            2 * n_valid * C1 * (1 + 4 * 2) + H * W * C)

    # K5 and K6 at t = T_MID; yardstick: one scatter_reduce_(amax) of the
    # same corner rows
    d_mid = disp_f[T_MID]
    ms_k5 = cuda_time(lambda: maxwarp.maximum_warp_norm_sparse(
        z2d, static, z_mov, positions, valid, d_mid), reps=50)
    ms_k5_plain = cuda_time(lambda: maxwarp.maximum_warp_norm_sparse_plain(
        z2d, static, z_mov, positions, valid, d_mid), reps=10)
    fl_mid = dense_f[T_MID][None].contiguous()
    ms_k6 = cuda_time(lambda: maxwarp.maximum_warp_norm_splat(z4, fl_mid), reps=50)
    ms_k6_plain = cuda_time(lambda: maxwarp.maximum_warp_norm_splat_plain(
        z4, fl_mid), reps=10)
    lib = {}
    for name, (ox, oy, zv, keep) in {
            "K5": (px.float() + d_mid[:, 0], py.float() + d_mid[:, 1], z_mov,
                   valid > 0.5),
            "K6": ((torch.arange(W, device=dev)[None, :] + fl_mid[0, ..., 0]).reshape(-1),
                   (torch.arange(H, device=dev)[:, None] + fl_mid[0, ..., 1]).reshape(-1),
                   z2d.reshape(-1), torch.ones(H * W, dtype=torch.bool, device=dev))
    }.items():
        taps = corners(ox, oy, H, W)
        lin_all = torch.cat([lin for lin, _, _ in taps])
        val_all = torch.cat([torch.where(inside & keep, zv * w, float("-inf"))
                             for _, w, inside in taps])
        mx = torch.full((H * W,), -1000.0, device=dev)
        lib[name] = cuda_time(lambda: mx.scatter_reduce_(0, lin_all, val_all,
                                                         reduce="amax"), reps=50)
    # K5: z and the static mask in, the moving rows (z_mov, positions,
    # valid, disp) in, zmax_dense and zmax_mov out; per valid row ~16 ops
    # for the corners and weights and 4 maxes scattering, 4 gathering; per
    # cell 3 adds and 2 maxes for the stencil, 4 maxes for zmax_dense
    k5_bound = bound(H * W * 4 * 2 + P * (4 + 8 + 4 + 8) + H * W * 4 + P * 4,
                     n_valid * 20 + P * 20 + H * W * 9)
    # K6: z and the flow in, the output out; per pixel ~16 ops for the
    # corners and weights, 4 maxes scattering and 4 gathering
    k6_bound = bound(H * W * (4 + 8 + 4), H * W * 24)

    steps = (N_FRAMES - 1) + N_FRAMES
    k1_bound = bound(H * W * 8 + P * 8 + (steps + 2) * P * 8,
                     steps * P * 12)  # round x2, add x2, 4 compares, sub x2, 2 sel
    print(f"phase 7 K1: {ms_k1:.4f} ms (plain {ms_k1_plain:.3f} ms, bound "
          f"{k1_bound[0]:.4f} ms by {k1_bound[1]})")
    for name, st in k2.items():
        print(f"phase 7 {name}: {st['ms']:.4f} ms/frame (plain "
              f"{st['plain_ms']:.3f} ms, index_add_ {st['lib_ms']:.4f} ms, bound "
              f"{st['bound'][0]:.4f} ms by {st['bound'][1]})")
    print(f"phase 7 K5: {ms_k5:.4f} ms/frame (plain {ms_k5_plain:.3f} ms, "
          f"scatter_reduce_ {lib['K5']:.4f} ms, bound {k5_bound[0]:.5f} ms by "
          f"{k5_bound[1]})")
    print(f"phase 7 K6: {ms_k6:.4f} ms/frame (plain {ms_k6_plain:.3f} ms, "
          f"scatter_reduce_ {lib['K6']:.4f} ms, bound {k6_bound[0]:.5f} ms by "
          f"{k6_bound[1]})")

    # stage breakdown of one f32 baseline render and one f32 SLR render
    with torch.no_grad():
        ms_enc = cuda_time(lambda: r32.model.encode(img_t), reps=5)
        chunk = torch.randn((db, H, W, 64), device=dev)
        ms_dec32 = cuda_time(lambda: r32.model.decode(chunk), reps=2, warmup=1)
        chunk_bf = chunk.to(torch.bfloat16)
        ms_decbf = cuda_time(lambda: rbf.model.decode(chunk_bf), reps=2, warmup=1)
    print(f"phase 7 baseline stages (f32 unless noted): encode {ms_enc:.2f} ms; "
          f"K1 {ms_k1:.3f} ms; K2 x{N_FRAMES} {k2['K2']['ms'] * N_FRAMES:.2f} ms; "
          f"decode {N_FRAMES} frames {ms_dec32:.1f} ms (bf16 {ms_decbf:.1f} ms)")
    with torch.no_grad():
        m = slr["float32"].model
        ms_s = {"encode": cuda_time(lambda: m.encode(img_t), reps=5),
                "bg": cuda_time(lambda: m.bg(img_t), reps=5),
                "alpha encode": cuda_time(lambda: m.alpha_encode(img_t), reps=5)}
        mv2 = slr["float32 v2"].model
        fs, z = mv2.encode(img_t)
        a_bg, a_fl = mv2.alpha_encode(img_t)
        pack, _ = rollout._slr_pack_fn(
            mv2.opt, fs, z, a_fl, torch.sigmoid(a_bg), positions, valid, static,
            plain=False)
        ms_s["v2 pack (incl. K5) per frame"] = cuda_time(lambda: pack(d_mid), reps=20)
        chunk65 = torch.randn((slr_db, H, W, 65), device=dev)
        ms_s[f"fluid decode {slr_db} frames"] = cuda_time(
            lambda: m.decode_fluid(chunk65[..., :-1]), reps=2, warmup=1)
        ms_s[f"alpha decode {slr_db} frames"] = cuda_time(
            lambda: m.decode_alpha_packed(chunk65), reps=2, warmup=1)
        mbf = slr["bfloat16"].model
        chunk65_bf = chunk65.to(torch.bfloat16)
        ms_s[f"bf16 fluid decode {slr_db} frames"] = cuda_time(
            lambda: mbf.decode_fluid(chunk65_bf[..., :-1]), reps=2, warmup=1)
        ms_s[f"bf16 alpha decode {slr_db} frames"] = cuda_time(
            lambda: mbf.decode_alpha_packed(chunk65_bf), reps=2, warmup=1)
    ms_s["K1"] = ms_k1
    ms_s[f"K2-SLR x{N_FRAMES}"] = k2["K2-SLR"]["ms"] * N_FRAMES
    ms_s[f"K5 x{N_FRAMES}"] = ms_k5 * N_FRAMES
    print("phase 7 SLR stages (f32 unless noted): "
          + "; ".join(f"{k} {v:.3f} ms" for k, v in ms_s.items()))

    fps = {}
    for label, r in (("baseline float32", r32), ("baseline bfloat16", rbf),
                     ("SLR float32", slr["float32"]),
                     ("SLR bfloat16", slr["bfloat16"]),
                     ("SLR float32 v2", slr["float32 v2"])):
        med, ts = render_median(r, img, flow_np)
        fps[label] = N_FRAMES / med
        print(f"phase 7 render {label}: median {med * 1e3:.1f} ms = "
              f"{fps[label]:.2f} frames/s (runs {[round(x * 1e3, 1) for x in ts]} ms)")

    total = torch.cuda.get_device_properties(0).total_memory
    peaks = {}
    for label, r, ch in (("baseline float32", r32, chunk),
                         ("baseline bfloat16", rbf, chunk_bf)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with torch.no_grad():
            r.model.decode(ch)
        torch.cuda.synchronize()
        peaks[label] = (torch.cuda.max_memory_allocated() - base, db)
    for label in ("float32", "bfloat16"):
        # the whole SLR render: splat field chunk, accumulator, both
        # decoders' activations and the outputs
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        outs = slr[label].frames(img, flow_np)
        torch.cuda.synchronize()
        peaks["SLR render " + label] = (torch.cuda.max_memory_allocated() - base,
                                        slr_db)
        del outs
    for label, (peak, n) in peaks.items():
        per_px = peak / (n * H * W)
        print(f"phase 7 peak memory {label}: decode chunk of {n} frames at "
              f"{H}^2 adds {peak / 2**30:.2f} GiB = {per_px:.0f} B per "
              f"pixel-frame; half of {total / 2**30:.1f} GiB holds "
              f"{int(total / 2 / per_px):,} pixel-frames")

    # ---- phase 8: summary --------------------------------------------
    def row(name, source, replaces, launches_, err, ms, plain_ms, bnd, lib_ms):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches_, "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0],
                "bound_by": bnd[1], "library_ms": lib_ms}

    rows_out = [
        row("euler_compact_dual", "slrsfs_tpu_torch/csrc/euler.cu",
            "slrsfs_tpu/ops/euler.py:145", launches["euler_compact_dual"],
            k1_err, ms_k1, ms_k1_plain, k1_bound, None),
        row("splat_dual_normalize", "slrsfs_tpu_torch/csrc/splat.cu",
            "slrsfs_tpu/ops/splat.py:390", launches["splat_dual_normalize"],
            k2["K2"]["err"], k2["K2"]["ms"], k2["K2"]["plain_ms"],
            k2["K2"]["bound"], k2["K2"]["lib_ms"]),
        row("splat_dual_normalize_slr", "slrsfs_tpu_torch/csrc/splat.cu",
            "slrsfs_tpu/ops/splat.py:390",
            slr_launches["float32"]["splat_dual_normalize_slr"],
            k2["K2-SLR"]["err"], k2["K2-SLR"]["ms"], k2["K2-SLR"]["plain_ms"],
            k2["K2-SLR"]["bound"], k2["K2-SLR"]["lib_ms"]),
        row("maximum_warp_norm_sparse", "slrsfs_tpu_torch/csrc/maxwarp_sparse.cu",
            "slrsfs_tpu/ops/splat.py:492",
            slr_launches["float32 v2"]["maximum_warp_norm_sparse"], k5_err,
            ms_k5, ms_k5_plain, k5_bound, lib["K5"]),
        row("maximum_warp_norm_splat", "slrsfs_tpu_torch/csrc/maxwarp.cu",
            "slrsfs_tpu/ops/splat.py:240",
            dense_launches["maximum_warp_norm_splat"], k6_err, ms_k6,
            ms_k6_plain, k6_bound, lib["K6"]),
    ]
    print("phase 8 render fps: " + ", ".join(f"{k} {v:.2f}" for k, v in fps.items())
          + "; all checks passed")
    print(smi)
    print(json.dumps({"kernels": rows_out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
