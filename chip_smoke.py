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
  dense check path runs K4, K3's forward and K6 (dense maximum-warp norm);
* both models with dtype='bfloat16-fast' (K2 accumulating in bf16), held
  against the bfloat16 renders: at most twice as far from them as the
  plain paths of the two modes are from each other.

The dense baseline render (K4, the dense integrator, and K3's forward) runs
on the scene, held at 1e-4 against the sparse render, and in the
configuration of __graft_entry__.py:entry() (256², N = 12), held at 1e-4
against its plain path. K4 is checked bit for bit in every form; K8 (the
exported single- and two-ended raw splats) and K2's bf16 mode against their
plain versions in f32 (1e-5) and bf16 (1e-2 of the largest value). K9, the
fused bf16 conv3x3 -> ReLU -> conv3x3 (wgmma over a ring of packed weight
taps), runs through the port's prototype bench
(slrsfs_tpu_torch/tools/conv_prototype.py: the prototype's slice and, at
B = 60, 256 x 480, C = F = 128, the kernel, cuDNN and the plain chain
timed, with the kernel's issued/useful work, shared memory and registers)
and at a ragged shape: within 2^-7 of max |plain| with at most 0.1 % of
the elements more than one bf16 ulp apart; the kernel's, the plain
chain's and cuDNN's share beyond one ulp of a float64 chain is printed. A v2 render comparison above 1e-5 (the usual value is ~1e-6; the
limit is 1e-4) reruns both sides and prints each stage's largest
difference: packed rows, splat field, decoded frames.

Then the stage-1 training path (Options() defaults at full width, batch 16,
W = 256, T = 60, float32; a smaller batch only if 16 does not fit, said so):
K7 (phased Euler integration, dense and compact) bit for bit and K3 (the
dense splat's scatter forward and gather backward) at 1e-5 against their
plain versions; one warm-up and 3 timed G+D steps of Trainer.train_step on
a synthetic batch, dense and with 50 % moving rows (compact K7), with their
launch counts, CUDA-event stage times and peak memory; a kernel-path step
against a plain-path step from one snapshot; and the train CLI for 2 steps
on a synthetic dataset, whose checkpoint SceneRenderer then renders.

Each path runs with the launch counts set to 0 just before it and read just
after. The script times the kernels, the renders and the steps with CUDA
events and prints:

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
BF16_FLOPS = 989e12  # H100 SXM, bf16 dense tensor cores
SLR_OPTS = dict(model_type="softmax_splating_2layers_alpha_seperate",
                use_alpha0_as_blending_weight=True)
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "build", "chip_smoke")


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def check_zeros(got, want, msg) -> int:
    """Fail unless the empty cells (every channel exactly 0) of two splat
    outputs (..., C) agree; return how many single elements are exactly 0 on
    one side only. Both sides sum by atomics in an order that varies from
    run to run, so where signed contributions cancel, an element of a cell
    that was reached can round to exactly 0 in one order and not in another
    (the allclose beside this check bounds it); a whole cell cannot."""
    check(bool(((got == 0).all(-1) == (want == 0).all(-1)).all()),
          f"{msg}: empty cells differ")
    return int(((got == 0) != (want == 0)).sum())


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


def bound(n_bytes: float, n_ops: float, peak: float = FP32_FLOPS):
    """(least ms, 'bytes' or 'operations') on the card's peak rates."""
    tb, to = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / peak * 1e3
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


_SPLAT_ENTRIES = ("splat_dual_normalize", "splat_dual_normalize_plain",
                  "splat_dual_normalize_slr", "splat_dual_normalize_slr_plain",
                  "splat_blend", "softsplat_sum", "softsplat_sum_plain")


def v2_stages(run, model, positions, valid):
    """``run()`` with each frame's packed rows (the splat's input rows; from
    a dense path, its packed grid at the moving pixels, times valid) and
    splat field (the decoder's input) recorded: (rows, fields, outputs)."""
    from slrsfs_tpu_torch.engine import rollout

    rows, fields, last = [], [], [None]
    px, py = positions[:, 0].long(), positions[:, 1].long()
    saved = {n: getattr(rollout, n) for n in _SPLAT_ENTRIES + ("_slr_decode_chunk",)}

    def splat_spy(fn):
        def spy(u, *a, **k):
            if u is not last[0]:  # the dense SLR path splats one u twice
                last[0] = u
                rows.append(u.float().clone() if u.dim() == 2
                            else u[0][py, px].float() * valid[:, None])
            return fn(u, *a, **k)
        return spy

    def decode_chunk_spy(model_, packed, *a, **k):
        fields.extend(packed.float().clone())
        return saved["_slr_decode_chunk"](model_, packed, *a, **k)

    decode = getattr(model, "decode", None)  # the baseline's decoder

    def decode_spy(x, *a, **k):
        fields.extend(x.float().clone())
        return decode(x, *a, **k)

    for n in _SPLAT_ENTRIES:
        setattr(rollout, n, splat_spy(saved[n]))
    rollout._slr_decode_chunk = decode_chunk_spy
    if decode is not None:
        model.decode = decode_spy
    try:
        out = run()
    finally:
        for n, fn in saved.items():
            setattr(rollout, n, fn)
        if decode is not None:
            del model.decode
    return rows, fields, out


def v2_diagnostic(label, err, model, positions, valid, run_a, run_b):
    """When a v2 comparison lands above 1e-5 (the usual value is ~1e-6),
    run both sides again and print each stage's largest difference: packed
    rows, splat field, decoded frames."""
    if err <= 1e-5:
        return
    a, b = (v2_stages(r, model, positions, valid) for r in (run_a, run_b))

    def diff(x, y):
        if isinstance(x, dict):
            return max(diff(x[k], y[k]) for k in x)
        if isinstance(x, (list, tuple)):
            if len(x) != len(y):
                return float("nan")
            return max((diff(p, q) for p, q in zip(x, y)), default=0.0)
        return (x.float() - y.float()).abs().max().item()

    print(f"phase 5-6 v2 diagnostic {label} ({err:.3g} > 1e-5): max abs of the "
          f"packed rows {diff(a[0], b[0]):.3g} ({len(a[0])}/{len(b[0])} frames), "
          f"splat field {diff(a[1], b[1]):.3g}, decoded frames {diff(a[2], b[2]):.3g}")


def read_png(path):
    import cv2

    return cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)


# ---- K4, K8, the dense render entry, bf16-fast renders, K9 -------------


def k4_phase(dev, flow):
    """K4 against its plain versions, bit for bit, at 256²: the dense dual
    form with (N - 1, N) steps on the scene's flow and on a random flow that
    sends many trajectories out of the frame; the dense and compact
    single-direction forms with visibility, the last-step form and
    n_steps = 0 on both."""
    import torch

    from slrsfs_tpu_torch.engine.rollout import prepare_scene_sparse
    from slrsfs_tpu_torch.ops import euler as E

    rng = np.random.default_rng(SEED + 4)
    rand = torch.from_numpy((rng.standard_normal((H, W, 2)) * 2.0)
                            .astype(np.float32)).to(dev)
    pos = torch.from_numpy(prepare_scene_sparse(flow.cpu().numpy())[0]).to(dev)
    n_f, n_b = N_FRAMES - 1, N_FRAMES
    err = 0.0
    for label, m in (("scene", flow), ("random", rand)):
        pairs = {"dense dual": (E.euler_integrate_all_dual(m, n_f, n_b),
                                E.euler_integrate_all_dual_plain(m, n_f, n_b)),
                 "dense": (E.euler_integrate_all(m, N_FRAMES),
                           E.euler_integrate_all_plain(m, N_FRAMES)),
                 "last step": (E.euler_integrate(m, N_FRAMES),
                               E.euler_integrate_plain(m, N_FRAMES)),
                 "compact": (E.euler_integrate_compact(m, pos, N_FRAMES),
                             E.euler_integrate_compact_plain(m, pos, N_FRAMES)),
                 "n_steps=0": (E.euler_integrate_all(m, 0),
                               E.euler_integrate_all_plain(m, 0))}
        torch.cuda.synchronize()
        for name, (got, want) in pairs.items():
            check(all(torch.equal(g, w) for g, w in zip(got, want)),
                  f"K4 {label} {name}: kernel differs from plain")
            err = max(err, *((g - w).abs().max().item() for g, w in zip(got, want)))
        want_b = pairs["dense dual"][1][1]
        n_oob = int((want_b[-1, ..., 0] == max(H, W) + 1).sum())
        n_hidden = int((pairs["dense"][1][1][-1] == 0).sum())
        print(f"phase 2 K4 {label}: {H}x{W} dense dual ({n_f}, {n_b}) steps, "
              f"dense and last step with visibility, compact P={pos.shape[0]}, "
              f"n_steps=0: bit-exact; {n_oob} backward trajectories and "
              f"{n_hidden} forward ones left the frame")
    ms = cuda_time(lambda: E.euler_integrate_all_dual(flow, n_f, n_b), reps=20)
    plain_ms = cuda_time(lambda: E.euler_integrate_all_dual_plain(flow, n_f, n_b),
                         reps=3, warmup=1)
    R, steps = H * W, n_f + n_b
    # bytes: the motion in, both displacement stacks (steps + 2 entries) out;
    # per trajectory step ~12 operations (round x2, add x2, 4 compares,
    # subtract x2, 2 selects)
    bnd = bound(R * 8 + (steps + 2) * R * 8, steps * R * 12)
    print(f"phase 2 K4 dense dual: {ms:.4f} ms (plain {plain_ms:.2f} ms, bound "
          f"{bnd[0]:.4f} ms by {bnd[1]})")
    return {"err": err, "ms": ms, "plain_ms": plain_ms, "bound": bnd}


def k8_phase(dev, u_mov, positions, disp_a, disp_b):
    """K8 at the render's shapes (P = 32768, C = 65, 256²): its path is the
    four exported functions, f32 then bf16, with the counts read after each
    dtype; each result against its plain version (f32: atol/rtol 1e-5 and
    the same empty cells; bf16: both sum in bf16 in other orders, so each is
    held against the f32 sums of the same rows, the kernel at most twice as
    far as the plain version; 1e-2 of max |out| is reported beside it);
    times, bounds and one index_add_ of the 4P weighted rows in the same
    dtype."""
    import torch

    from slrsfs_tpu_torch import kernels
    from slrsfs_tpu_torch.ops import splat as S

    P, C = u_mov.shape
    px, py = positions[:, 0].float(), positions[:, 1].float()
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        u = u_mov.to(dtype)
        kernels.reset_counts()
        one = {name: getattr(S, name)(u, positions, disp_a, H, W)
               for name in ("softsplat_sum_at", "softsplat_sum_at_paired",
                            "softsplat_sum_at_quad")}
        two = S.softsplat_sum_at_quad_dual(u, positions, disp_a, disp_b, 0.5, 0.5, H, W)
        torch.cuda.synchronize()
        launches = kernels.counts()
        check(launches["splat_sum_at"] == 4 and sum(launches.values()) == 4,
              f"K8 {dtype} launches {launches}")
        want_one = S.softsplat_sum_at_plain(u, positions, disp_a, H, W)
        want_two = S.softsplat_sum_at_quad_dual_plain(u, positions, disp_a, disp_b,
                                                      0.5, 0.5, H, W)
        if dtype == torch.bfloat16:
            u32 = u.float()
            ref_one = S.softsplat_sum_at_plain(u32, positions, disp_a, H, W)
            ref_two = S.softsplat_sum_at_quad_dual_plain(u32, positions, disp_a,
                                                         disp_b, 0.5, 0.5, H, W)
        err, far, n_cancel = 0.0, [], 0
        for name, got, want in [(n, g, want_one) for n, g in one.items()] + [
                ("softsplat_sum_at_quad_dual", two, want_two)]:
            e = (got.float() - want.float()).abs().max().item()
            if dtype == torch.float32:
                check(torch.allclose(got, want, rtol=1e-5, atol=1e-5),
                      f"K8 f32 {name}: max abs {e}")
                n_cancel += check_zeros(got, want, f"K8 f32 {name}")
            else:
                ref = ref_two if got is two else ref_one
                d_k = (got.float() - ref).abs().max().item()
                d_p = (want.float() - ref).abs().max().item()
                check(d_k <= 2.0 * d_p, f"K8 bf16 {name}: kernel {d_k} from the f32 "
                      f"sums, over twice the plain version's {d_p}")
                far.append((d_k, d_p, e / want.float().abs().max().item()))
            err = max(err, e)
        ms = cuda_time(lambda: S.softsplat_sum_at(u, positions, disp_a, H, W), reps=50)
        ms_dual = cuda_time(lambda: S.softsplat_sum_at_quad_dual(
            u, positions, disp_a, disp_b, 0.5, 0.5, H, W), reps=50)
        plain_ms = cuda_time(lambda: S.softsplat_sum_at_plain(u, positions, disp_a,
                                                              H, W), reps=10)
        lins, rows = [], []
        for lin, w in S._corner_taps(px + disp_a[:, 0], py + disp_a[:, 1], H, W):
            lins.append(lin)
            rows.append((u.float() * w[:, None]).to(dtype))
        lin_all, rows_all = torch.cat(lins), torch.cat(rows)
        acc = torch.zeros((H * W, C), dtype=dtype, device=dev)
        lib_ms = cuda_time(lambda: acc.index_add_(0, lin_all, rows_all), reps=50)
        e_b = u.element_size()
        # the rows, positions and displacements in, the grid out; per row
        # ~20 operations of corner math, per channel a scale and 4
        # multiply-adds
        bnd = bound(P * (C * e_b + 16) + H * W * C * e_b, P * (20 + 9 * C))
        label = "f32" if dtype == torch.float32 else "bf16"
        limit = (f"atol/rtol 1e-5, empty cells match; {n_cancel} elements of "
                 f"reached cells exactly 0 on one side") if label == "f32" else (
            f"from the f32 sums: kernel up to {max(f[0] for f in far):.3g}, plain "
            f"up to {max(f[1] for f in far):.3g}, limit 2x the plain's; kernel vs "
            f"plain up to {max(f[2] for f in far):.3g} of max |out|")
        print(f"phase 3 K8 {label}: softsplat_sum_at, _paired, _quad and _quad_dual "
              f"(launches {launches['splat_sum_at']}) max abs {err:.3g} vs plain "
              f"({limit}); one end {ms:.4f} ms, two ends {ms_dual:.4f} ms (plain "
              f"{plain_ms:.3f} ms, index_add_ of the 4P rows {lib_ms:.4f} ms, bound "
              f"{bnd[0]:.4f} ms by {bnd[1]})")
        res[label] = {"launches": launches["splat_sum_at"], "err": err, "ms": ms,
                      "ms_dual": ms_dual, "plain_ms": plain_ms, "lib_ms": lib_ms,
                      "bound": bnd}
        del lin_all, rows_all, acc
    return res


def dense_entry_phase(dev, model, img, flow, frames32):
    """The dense render through K4 and K3's forward: (a) the scene at N = 60
    against the sparse main-path render; (b) the configuration of
    __graft_entry__.py:entry() (256², N = 12, img = normal x 0.25, flow =
    standard normal, numpy seed 0) against its plain path (K4 and K3's
    plain versions). Both with settled random full-width weights."""
    import torch

    from slrsfs_tpu_torch import kernels
    from slrsfs_tpu_torch.engine import rollout

    rng = np.random.default_rng(0)
    img_e = torch.from_numpy((rng.standard_normal((1, H, W, 3)) * 0.25)
                             .astype(np.float32)).to(dev)
    flow_e = torch.from_numpy(rng.standard_normal((H, W, 2)).astype(np.float32)).to(dev)
    img_t = torch.from_numpy(img[None]).to(dev)
    res = {}
    for label, (im, fl, n) in {"scene": (img_t, flow, N_FRAMES),
                               "entry()": (img_e, flow_e, 12)}.items():
        kernels.reset_counts()
        got = rollout.baseline_rollout(model, im, fl, n)
        torch.cuda.synchronize()
        launches = kernels.counts()
        check(launches == {**{k.name: 0 for k in kernels.KERNELS}, "euler_all": 1,
                           "splat_dense_fwd": 2 * n},
              f"dense render {label} launches: {launches}")
        check(tuple(got.shape) == (n, H, W, 3) and bool(torch.isfinite(got).all()),
              f"dense render {label}: shape {tuple(got.shape)} or not finite")
        if label == "scene":
            ref, against = frames32, "the sparse main-path render"
        else:
            ref = rollout.baseline_rollout(model, im, fl, n, plain=True)
            against = "its plain path (K4 and K3 plain)"
        err = (got - ref).abs().max().item()
        check(err <= 1e-4, f"dense render {label} vs {against}: max abs {err}")
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            rollout.baseline_rollout(model, im, fl, n)
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        med = sorted(ts)[1]
        print(f"phase 5 dense render {label}: {H}x{W} N={n} launches "
              f"{ {k: v for k, v in launches.items() if v} }; vs {against} max abs "
              f"{err:.3g} (limit 1e-4); median {med * 1e3:.1f} ms = "
              f"{n / med:.2f} frames/s (runs {[round(x * 1e3, 1) for x in ts]} ms); "
              f"frame range [{got.min().item():.3f}, {got.max().item():.3f}]")
        res[label] = {"launches": launches, "err": err, "fps": n / med}
    return res


def bf16_fast_phase(img_path, flow_path, scene_dir, bf16, img, flow_np):
    """The baseline and the SLR model through SceneRenderer.render with
    dtype='bfloat16-fast' (bf16 networks, bf16 splat accumulation): launch
    counts, PNGs equal to the quantised outputs of the render that wrote
    them, and the frames' distance from the 'bfloat16' render (``bf16``:
    label -> (renderer, its kernel-path outputs)), which differs only in the
    splat's accumulation. The plain paths of the two modes show how far
    bf16 accumulation alone moves the frames (JAX's 2e-2 bound holds for
    f32 networks at 32², not here); the kernel path may be at most twice as
    far."""
    import torch

    from slrsfs_tpu_torch import kernels
    from slrsfs_tpu_torch.cli.render import SceneRenderer, outputs_to_u8

    def as_dict(o):
        return o if isinstance(o, dict) else {"PredImg": o}

    def dist(a, b):
        a, b = as_dict(a), as_dict(b)
        return max((a[k].float() - b[k].float()).abs().max().item() for k in a)

    res = {}
    for label, overrides in (("baseline", None), ("SLR", SLR_OPTS)):
        r = SceneRenderer(W=W, n_frames=N_FRAMES, dtype="bfloat16-fast", seed=SEED,
                          sparsify_eps=0.0, opt_overrides=overrides)
        kernels.reset_counts()
        out_dir, outs = render_capture(
            r, img_path, flow_path, os.path.join(scene_dir, f"{label} bf16-fast"),
            name="synthetic", rawsize=True)
        torch.cuda.synchronize()
        launches = kernels.counts()
        k2 = "splat_dual_normalize_slr" if overrides else "splat_dual_normalize"
        check(launches == {**{k.name: 0 for k in kernels.KERNELS},
                           "euler_compact_dual": 1, k2: N_FRAMES},
              f"{label} bf16-fast render launches: {launches}")
        for k, v in as_dict(outs).items():
            check(bool(torch.isfinite(v).all()), f"{label} bf16-fast {k} not finite")
        r16, outs16 = bf16[label]
        err = dist(outs, outs16)
        plain_err = dist(r.frames(img, flow_np, plain=True),
                         r16.frames(img, flow_np, plain=True))
        check(err <= 2.0 * plain_err, f"{label} bf16-fast vs bfloat16 render: max "
              f"abs {err}, over twice the plain paths' {plain_err}")
        q = outputs_to_u8(outs)
        for k in ("PredImg",) + (("FluidImg", "CompositeFluidAlpha") if overrides else ()):
            for t in (0, N_FRAMES - 1):
                png = read_png(os.path.join(out_dir, k, f"{t:06d}.png"))
                frame = q[k][t]
                if frame.shape[-1] == 1:
                    frame = np.repeat(frame, 3, -1)
                check(np.array_equal(png, frame), f"{label} bf16-fast {k} PNG {t} "
                      f"differs from the frame")
        med, ts = render_median(r, img, flow_np)
        print(f"phase 6 {label} bf16-fast render: launches "
              f"{ {k: v for k, v in launches.items() if v} }; vs the bfloat16 render "
              f"max abs {err:.3g} (plain paths {plain_err:.3g}; limit twice that); "
              f"PNGs equal the frames; median {med * 1e3:.1f} ms = "
              f"{N_FRAMES / med:.2f} frames/s (runs {[round(x * 1e3, 1) for x in ts]} ms)")
        res[label] = {"launches": launches[k2], "err": err, "plain_err": plain_err,
                      "fps": N_FRAMES / med}
        del r, outs
    return res


def k9_phase(dev):
    """K9 through the port's prototype bench (its path: the check on the
    prototype's x[:2, :32] and the timed calls at B = 60, 256 x 480,
    C = F = 128), a ragged shape against the plain version, and peak
    memory."""
    import torch

    from slrsfs_tpu_torch import kernels
    from slrsfs_tpu_torch.ops import fused_conv as fc
    from slrsfs_tpu_torch.tools import conv_prototype as cp

    kernels.reset_counts()
    res = cp.bench(reps=3)
    torch.cuda.synchronize()
    launches = kernels.counts()
    check(launches["fused_conv3x3_relu_conv3x3"] == sum(launches.values()) > 0,
          f"K9 bench launches {launches}")
    c = res["check"]
    check(cp.within_limits(c), f"K9 on x[:2, :32]: {c}")
    print(f"phase 7 K9 on the prototype's x[:2, :32]: max abs "
          f"{c['max_abs_err']:.3g} (limit 2^-7 x {c['scale']:.3g}), "
          f"{c['beyond_ulp_share']:.2e} of elements beyond one bf16 ulp (limit 1e-3)")
    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    shape = (2, 101, 91, 128, 128)  # H, W divided by neither side of the tile
    B, Hr, Wr, C, F = shape
    xr = (torch.randn((B, Hr, Wr, C), generator=g, device=dev) * 0.5).to(torch.bfloat16)
    wa = (torch.randn((3, 3, C, F), generator=g, device=dev) / (9 * C) ** 0.5
          ).to(torch.bfloat16)
    wb = (torch.randn((3, 3, F, F), generator=g, device=dev) / (9 * F) ** 0.5
          ).to(torch.bfloat16)
    ref = fc.conv_chain_plain(xr, wa, wb)
    got = fc.fused_conv3x3_relu_conv3x3(xr, wa, wb)
    c = cp.compare(got, ref)
    check(cp.within_limits(c), f"K9 ragged {shape}: {c}")
    ragged_err = c["max_abs_err"]
    print(f"phase 7 K9 ragged {shape} (random inputs): max abs "
          f"{c['max_abs_err']:.3g} (limit 2^-7 x {c['scale']:.3g}), "
          f"{c['beyond_ulp_share']:.2e} beyond one ulp (limit 1e-3)")
    # precision against the same chain in float64 (h rounded to bf16 too)
    with torch.no_grad():
        h64 = torch.nn.functional.conv2d(
            xr.permute(0, 3, 1, 2).double(), wa.permute(3, 2, 0, 1).double(), padding=1)
        h64 = torch.relu(h64).float().to(torch.bfloat16).double()
        ref64 = torch.nn.functional.conv2d(h64, wb.permute(3, 2, 0, 1).double(),
                                           padding=1).float().to(torch.bfloat16)
        ref64 = ref64.permute(0, 2, 3, 1)
    shares = {name: cp.compare(out, ref64)["beyond_ulp_share"] for name, out in (
        ("kernel", got), ("plain f32", ref),
        ("cuDNN bf16", fc.conv_chain_library(xr, wa, wb)))}
    print(f"phase 7 K9 ragged {shape} against the float64 chain: share of elements "
          f"beyond one bf16 ulp: " + ", ".join(f"{k} {v:.2e}" for k, v in shares.items()))
    x, waa, wab = res["inputs"]
    peaks = {}
    for name, fn in (("kernel", lambda: fc.fused_conv3x3_relu_conv3x3(x, waa, wab)),
                     ("library", lambda: fc.conv_chain_library(x, waa, wab))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = fn()
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated() - base
        del out
    n_bytes = 2 * (x.numel() + waa.numel() + wab.numel()
                   + x.numel() // x.shape[-1] * waa.shape[-1])
    bnd = bound(n_bytes, res["flop"], BF16_FLOPS)
    s = res["shape"]
    print(f"phase 7 K9 at B={s['B']} {s['H']}x{s['W']} C=F={s['C']} bf16 "
          f"({res['flop'] / 1e12:.3f} TFLOP useful): "
          + ", ".join(f"{k} {v:.3f} ms ({res['tflops'][k]:.1f} TFLOP/s)"
                      for k, v in res["ms"].items())
          + f"; bound {bnd[0]:.3f} ms by {bnd[1]}; launches {launches['fused_conv3x3_relu_conv3x3']}; "
          f"peak above inputs: kernel {peaks['kernel'] / 2**30:.2f} GiB, library "
          f"{peaks['library'] / 2**30:.2f} GiB")
    blk = res["block"]
    regs = (f"{blk['registers']} registers per thread at launch (ptxas), "
            f"{blk['spill_bytes']} bytes of spills"
            if "registers" in blk else "registers not in the build log")
    print(f"phase 7 K9 {fc.TILE[0]}x{fc.TILE[1]} tiles: {res['ms']['kernel']:.3f} ms "
          f"({res['tflops']['kernel']:.1f} TFLOP/s) beside cuDNN's "
          f"{res['ms']['library']:.3f} ms ({res['tflops']['library']:.1f} TFLOP/s), "
          f"{res['ms']['kernel'] / res['ms']['library']:.2f}x; issued/useful work "
          f"{blk['work_ratio']:.3f}; per block {blk['smem_bytes']} bytes of "
          f"shared memory, {regs}")
    out = {"launches": launches["fused_conv3x3_relu_conv3x3"],
           "err": max(ragged_err, res["check"]["max_abs_err"]),
           "ms": res["ms"]["kernel"], "plain_ms": res["ms"]["plain"],
           "lib_ms": res["ms"]["library"], "bound": bnd}
    del x, waa, wab, res
    torch.cuda.empty_cache()
    return out



# ---- training: kernels K7 and K3, the G+D step, the train CLI -----------
#
# The shipped stage-1 training shape (tools/train_bench.py:1-6,
# train_baseline2_pconv.sh): Options() defaults at full width, batch 16,
# W = 256, T = train_max_steps = 60, float32.
TRAIN_B = 16
TRAIN_T = 60
TRAIN_C = 65  # the packed splat channels: 64 features + e^Z


def make_train_batch(rng, B: int, W_: int, moving_frac: float = 1.0):
    """The synthetic batch of tools/train_bench.py:make_batch, as numpy."""
    imgs = [(rng.standard_normal((B, W_, W_, 3)) * 0.25).astype(np.float32)
            for _ in range(3)]
    idx = np.zeros((B, 3), np.int32)
    idx[:, 1] = rng.integers(1, 59, size=B)
    idx[:, 2] = 59
    motions = rng.standard_normal((B, W_, W_, 2)).astype(np.float32) * 2.0
    if moving_frac < 1.0:
        motions[:, : int(W_ * (1.0 - moving_frac))] = 0.0
    return {"images": imgs, "index": idx, "motions": motions}


def phased_counts(idx: np.ndarray, T: int):
    """(t_f, t_p) of each sample as BaselineTrainable.forward_train clips
    them."""
    t_f = np.clip(idx[:, 1] - idx[:, 0], 0, T).astype(np.int32)
    t_p = np.minimum(np.clip(idx[:, 2] + 1 - idx[:, 1], 0, None),
                     T - t_f).astype(np.int32)
    return t_f, t_p


def k7_phase(dev, scene_flow: np.ndarray):
    """K7 against its plain versions, bit for bit, dense and compact, at
    the training shape: the scene's motion (static top half, a moving pixel
    at (0, 0)) and random motion that leaves the grid, with t_p = 0,
    t_f = 0, t_f + t_p = T and random counts."""
    import torch

    from slrsfs_tpu_torch import kernels
    from slrsfs_tpu_torch.cli.train import attach_moving_sets
    from slrsfs_tpu_torch.ops.euler import (
        euler_integrate_phased,
        euler_integrate_phased_compact,
        euler_integrate_phased_compact_plain,
        euler_integrate_phased_plain,
    )

    B, T = TRAIN_B, TRAIN_T
    rng = np.random.default_rng(SEED + 7)
    scene = np.repeat(scene_flow[None], B, axis=0).copy()
    scene[:, 0, 0] = [0.5, 0.5]
    t_f = rng.integers(0, T + 1, size=B).astype(np.int32)
    t_p = (rng.integers(0, T + 1, size=B) % (T - t_f + 1)).astype(np.int32)
    t_f[:3], t_p[:3] = [T, 0, 30], [0, T, 30]  # t_p = 0, t_f = 0, sum = T
    tf_d, tp_d = torch.from_numpy(t_f).to(dev), torch.from_numpy(t_p).to(dev)
    err = 0.0
    for label, m_np in (("scene", scene),
                        ("random", rng.standard_normal(scene.shape)
                         .astype(np.float32) * 2.0)):
        m = torch.from_numpy(m_np).to(dev)
        got = euler_integrate_phased(m, tf_d, tp_d, T)
        want = euler_integrate_phased_plain(m, tf_d, tp_d, T)
        torch.cuda.synchronize()
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"K7 dense {label}: kernel differs from plain")
        err = max(err, *((g - w).abs().max().item() for g, w in zip(got, want)))
        n_oob = int((want[1][..., 0] == max(H, W) + 1).sum())
        print(f"phase 8 K7 dense {label}: B={B} {H}x{W} T={T} bit-exact; "
              f"{n_oob} backward trajectories left the grid")
    sets = attach_moving_sets({"motions": scene}, max_frac=1.0)
    pos = torch.from_numpy(sets["mov_pos"]).to(dev)
    val = torch.from_numpy(sets["mov_valid"]).to(dev)
    m = torch.from_numpy(scene).to(dev)
    got = euler_integrate_phased_compact(m, pos, val, tf_d, tp_d, T)
    want = euler_integrate_phased_compact_plain(m, pos, val, tf_d, tp_d, T)
    dense = euler_integrate_phased_plain(m, tf_d, tp_d, T)
    torch.cuda.synchronize()
    check(all(torch.equal(g, w) for g, w in zip(got, want)),
          "K7 compact: kernel differs from plain")
    check(all(torch.equal(g, d) for g, d in zip(got, dense)),
          "K7 compact differs from K7 dense")
    check(bool((got[0][:, 0, 0] != 0).any()), "the moving pixel at (0, 0) lost")
    err = max(err, *((g - w).abs().max().item() for g, w in zip(got, want)))
    P = pos.shape[1]
    n_pad = int((val == 0).sum())
    print(f"phase 8 K7 compact: P={P} ({n_pad} padded rows at (0, 0)) "
          f"bit-exact and equal to the dense form")
    # timing inputs: the training batch's counts on the scene's motion
    idx = make_train_batch(np.random.default_rng(SEED), B, W)["index"]
    tf_b, tp_b = (torch.from_numpy(a).to(dev) for a in phased_counts(idx, T))
    ms = cuda_time(lambda: euler_integrate_phased(m, tf_b, tp_b, T), reps=20)
    plain_ms = cuda_time(lambda: euler_integrate_phased_plain(m, tf_b, tp_b, T),
                         reps=3, warmup=1)
    ms_c = cuda_time(lambda: euler_integrate_phased_compact(m, pos, val, tf_b,
                                                            tp_b, T), reps=20)
    # per trajectory and step ~20 operations (round x2, clamp x4, index,
    # gather, sign, add x2, 4 compares, pin, subtract x2, 2 latches); the
    # loop runs to the last latching step; bytes: motion and counts in, both
    # displacement fields out
    steps = int(np.where(tp_b.cpu().numpy() > 0,
                         (tf_b + tp_b).cpu().numpy(), tf_b.cpu().numpy()).sum())
    bnd = bound(B * H * W * 8 + B * 8 + 2 * B * H * W * 8, steps * H * W * 20)
    print(f"phase 8 K7: dense {ms:.4f} ms (plain {plain_ms:.2f} ms, bound "
          f"{bnd[0]:.4f} ms by {bnd[1]}); compact P={P} {ms_c:.4f} ms")
    kernels.reset_counts()
    return {"err": err, "ms": ms, "plain_ms": plain_ms, "bound": bnd,
            "ms_compact": ms_c}


def k3_phase(dev, scene_flow: np.ndarray):
    """K3's forward and backward against their plain versions at the
    training shape (B = 16, 256², C = 65): random inputs with a random flow,
    and with the scene's flow integrated by K7 (sentinels included)."""
    import torch

    from slrsfs_tpu_torch.ops.euler import euler_integrate_phased
    from slrsfs_tpu_torch.ops.splat import (
        _corner_taps,
        softsplat_sum_bwd_kernel,
        softsplat_sum_fwd_kernel,
        softsplat_sum_grad_plain,
        softsplat_sum_plain,
    )

    B, C = TRAIN_B, TRAIN_C
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    inp = torch.randn((B, H, W, C), generator=gen, device=dev)
    g = torch.randn((B, H, W, C), generator=gen, device=dev)
    idx = make_train_batch(np.random.default_rng(SEED), B, W)["index"]
    tf_b, tp_b = (torch.from_numpy(a).to(dev) for a in phased_counts(idx, TRAIN_T))
    m = torch.from_numpy(np.repeat(scene_flow[None], B, axis=0)).to(dev)
    flows = {"random flow": torch.randn((B, H, W, 2), generator=gen,
                                        device=dev) * 3.0,
             "scene flow (K7)": euler_integrate_phased(m, tf_b, tp_b,
                                                       TRAIN_T)[1]}
    res = {"fwd_err": 0.0, "bwd_err": 0.0}
    for label, flow in flows.items():
        out = softsplat_sum_fwd_kernel(inp, flow)
        ref = softsplat_sum_plain(inp, flow)
        torch.cuda.synchronize()
        e = (out - ref).abs().max().item()
        check(torch.allclose(out, ref, rtol=1e-5, atol=1e-5),
              f"K3 forward {label}: max abs {e}")
        n_cancel = check_zeros(out, ref, f"K3 forward {label}")
        gi, gf = softsplat_sum_bwd_kernel(inp, flow, g)
        wi, wf = softsplat_sum_grad_plain(inp, flow, g)
        torch.cuda.synchronize()
        eb = []
        for name, a, b in (("grad_inp", gi, wi), ("grad_flow", gf, wf)):
            scale = b.abs().max().item()
            d = (a - b).abs().max().item()
            check(d <= 1e-5 * scale, f"K3 backward {label} {name}: max abs "
                  f"{d} vs 1e-5 x {scale}")
            eb.append(d)
        res["fwd_err"] = max(res["fwd_err"], e)
        res["bwd_err"] = max(res["bwd_err"], *eb)
        print(f"phase 9 K3 {label}: forward max abs {e:.3g} (atol/rtol 1e-5), "
              f"empty cells match ({int((ref == 0).all(-1).sum())}; "
              f"{n_cancel} elements of reached cells exactly 0 on one side); "
              f"backward max abs grad_inp {eb[0]:.3g}, grad_flow {eb[1]:.3g} "
              f"(limit 1e-5 of each output's max)")
    flow = flows["scene flow (K7)"]
    res["ms_fwd"] = cuda_time(lambda: softsplat_sum_fwd_kernel(inp, flow), reps=20)
    res["plain_fwd"] = cuda_time(lambda: softsplat_sum_plain(inp, flow), reps=3,
                                 warmup=1)
    res["ms_bwd"] = cuda_time(lambda: softsplat_sum_bwd_kernel(inp, flow, g),
                              reps=20)
    res["plain_bwd"] = cuda_time(lambda: softsplat_sum_grad_plain(inp, flow, g),
                                 reps=3, warmup=1)
    # yardstick for the forward: ONE index_add_ of the 4·B·HW weighted rows
    xs = torch.arange(W, device=dev, dtype=torch.float32)[None, :]
    ys = torch.arange(H, device=dev, dtype=torch.float32)[:, None]
    lins, rows = [], []
    for b in range(B):
        for lin, w in _corner_taps((xs + flow[b, ..., 0]).reshape(-1),
                                   (ys + flow[b, ..., 1]).reshape(-1), H, W):
            lins.append(lin + b * H * W)
            rows.append(inp[b].reshape(H * W, C) * w[:, None])
    lin_all, rows_all = torch.cat(lins), torch.cat(rows)
    del lins, rows
    acc = torch.zeros((B * H * W, C), device=dev)
    res["lib_fwd"] = cuda_time(lambda: acc.index_add_(0, lin_all, rows_all), reps=20)
    del lin_all, rows_all, acc
    n = B * H * W
    # forward: inp and flow in, out out; per pixel ~20 ops of corner math
    # and per channel 4 multiplies and 4 adds
    res["bound_fwd"] = bound(n * C * 4 * 2 + n * 8, n * (8 * C + 20))
    # backward: inp, flow and g in, grad_inp and grad_flow out; per channel
    # and corner 2 multiply-adds (g·w, inp·g)
    res["bound_bwd"] = bound(n * C * 4 * 3 + n * 8 * 2, n * (16 * C + 40))
    print(f"phase 9 K3 forward: {res['ms_fwd']:.4f} ms (plain "
          f"{res['plain_fwd']:.2f} ms, index_add_ {res['lib_fwd']:.4f} ms, bound "
          f"{res['bound_fwd'][0]:.4f} ms by {res['bound_fwd'][1]}); backward: "
          f"{res['ms_bwd']:.4f} ms (plain {res['plain_bwd']:.2f} ms, bound "
          f"{res['bound_bwd'][0]:.4f} ms by {res['bound_bwd'][1]})")
    return res


def _step_times(tr, batch, n_steps: int):
    """n timed G+D steps: (host ms per step list, mean CUDA-event stage ms,
    logs of the last step)."""
    import torch

    stages = {}
    host = []
    logs = None
    for _ in range(n_steps):
        events = [("start", torch.cuda.Event(enable_timing=True))]
        events[0][1].record()

        def mark(name):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            events.append((name, e))

        t0 = time.perf_counter()
        logs = tr.train_step(batch, timer=mark)
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        for (_, a), (name, b) in zip(events, events[1:]):
            stages.setdefault(name, []).append(a.elapsed_time(b))
    return host, {k: float(np.mean(v)) for k, v in stages.items()}, logs


def _max_grad_diff(a, b):
    scale = max(x.abs().max().item() for x in b)
    return max((x - y).abs().max().item() for x, y in zip(a, b)), scale


def training_phase(dev):
    """The full-width G+D step through Trainer.train_step: dense batch
    (K7 dense) and a batch with 50 % moving rows through
    attach_moving_sets (K7 compact). One warm-up and 3 timed steps each;
    launches counted over the dense timed steps; kernel path against plain
    path from one snapshot."""
    import torch

    from slrsfs_tpu_torch import kernels
    from slrsfs_tpu_torch.cli.train import (
        attach_moving_sets,
        build,
        to_device_batch,
    )
    from slrsfs_tpu_torch.config import Options

    B = TRAIN_B
    while True:
        opt = Options(W=W, batch_size=B)  # full width: ngf 64, D ndf 64
        _, tr = build(opt, train_max_steps=TRAIN_T, device=dev, seed=SEED)
        batch = to_device_batch(make_train_batch(np.random.default_rng(SEED), B, W), dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        try:
            tr.train_step(batch)  # warm-up
            torch.cuda.synchronize()
            break
        except torch.cuda.OutOfMemoryError:
            peak = torch.cuda.max_memory_allocated()
            del tr, batch
            torch.cuda.empty_cache()
            print(f"phase 10 batch {B} does not fit the card (peak "
                  f"{peak / 2**30:.1f} GiB at the failure); halving")
            check(B > 1, "batch 1 does not fit")
            B //= 2
    warm_peak = torch.cuda.max_memory_allocated()
    kernels.reset_counts()
    host, stages, logs = _step_times(tr, batch, 3)
    launches = kernels.counts()
    want = {**{k.name: 0 for k in kernels.KERNELS}, "splat_dense_fwd": 6,
            "splat_dense_bwd": 6, "euler_phased": 3}
    check(launches == want, f"training launches over 3 steps: {launches}")
    for k, v in logs.items():
        check(bool(torch.isfinite(v)), f"training loss {k} = {v}")
    step_ms = float(np.median(host))
    print(f"phase 10 training step (dense K7): B={B} {W}^2 ngf={opt.ngf} "
          f"T={TRAIN_T}: {step_ms:.1f} ms/step median = {B / step_ms * 1e3:.2f} "
          f"samples/s (runs {[round(x, 1) for x in host]} ms); stages "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in stages.items())
          + f"; launches over 3 steps {launches}; peak {warm_peak / 2**30:.2f} GiB"
          + "; losses " + ", ".join(f"{k} {v.item():.4f}" for k, v in logs.items()))

    sparse_np = attach_moving_sets(make_train_batch(np.random.default_rng(SEED + 1),
                                                    B, W, moving_frac=0.5))
    check("mov_pos" in sparse_np, "the 50 % batch has no moving sets")
    sparse = to_device_batch(sparse_np, dev)
    tr.train_step(sparse)  # warm-up
    kernels.reset_counts()
    host_s, stages_s, logs_s = _step_times(tr, sparse, 3)
    launches_s = kernels.counts()
    check(launches_s == want, f"compact training launches: {launches_s}")
    for k, v in logs_s.items():
        check(bool(torch.isfinite(v)), f"compact training loss {k} = {v}")
    step_ms_s = float(np.median(host_s))
    print(f"phase 10 training step (50 % moving, compact K7, P="
          f"{sparse_np['mov_pos'].shape[1]}): {step_ms_s:.1f} ms/step median = "
          f"{B / step_ms_s * 1e3:.2f} samples/s (runs "
          f"{[round(x, 1) for x in host_s]} ms); stages "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in stages_s.items()))

    # kernel path against plain path, from one snapshot, both batches
    path = {}
    for label, b in (("dense", batch), ("compact", sparse)):
        snap = tr.snapshot()
        got = tr.train_step(b)
        g_k = [x.clone() for x in tr.last_grads["g"] + tr.last_grads["d"]]
        tr.restore(snap)
        want_l = tr.train_step(b, plain=True)
        g_p = tr.last_grads["g"] + tr.last_grads["d"]
        tr.restore(snap)
        loss_rel = max(abs(got[k].item() - want_l[k].item())
                       / max(abs(want_l[k].item()), 1e-12) for k in want_l)
        g_diff, g_scale = _max_grad_diff(g_k, g_p)
        check(loss_rel <= 1e-4, f"{label} kernel vs plain step: losses differ "
              f"by {loss_rel:.3g} relative")
        check(g_diff <= 1e-3 * g_scale, f"{label} kernel vs plain step: "
              f"gradients differ by {g_diff:.3g} (largest {g_scale:.3g})")
        path[label] = (loss_rel, g_diff / g_scale)
        del g_k, g_p, snap
    print("phase 10 kernel vs plain step: " + "; ".join(
        f"{k}: losses {v[0]:.3g} relative (limit 1e-4), gradients "
        f"{v[1]:.3g} of the largest (limit 1e-3)" for k, v in path.items()))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    tr.train_step(batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    print(f"phase 10 peak memory of a step: {peak / 2**30:.2f} GiB allocated "
          f"({(peak - base) / 2**30:.2f} GiB above the resident "
          f"{base / 2**30:.2f} GiB of weights, optimizer and batch)")
    return {"B": B, "launches": launches, "step_ms": step_ms,
            "step_ms_compact": step_ms_s, "stages": stages, "peak": peak}


def write_train_fixture(root: str, seed: int):
    """Two training scenes and one validation scene in the reference layout
    (<split>/<scene>_gt.mp4 and _motion.npz), as tests/conftest.py makes
    them: 12 frames of 256x144, the bottom half moving."""
    import cv2

    rng = np.random.default_rng(seed)
    h, w, n = 144, 256, 12
    for split, scenes in (("train", ["00001_00000", "00002_00000"]),
                          ("validation", ["00980_00000"])):
        os.makedirs(os.path.join(root, split), exist_ok=True)
        for scene in scenes:
            vw = cv2.VideoWriter(os.path.join(root, split, f"{scene}_gt.mp4"),
                                 cv2.VideoWriter_fourcc(*"mp4v"), 30, (w, h))
            base = rng.integers(0, 255, (h, w, 3), np.uint8)
            for t in range(n):
                vw.write(cv2.cvtColor(np.roll(base, t, axis=1),
                                      cv2.COLOR_RGB2BGR))
            vw.release()
            motion = np.zeros((h, w, 2), np.float32)
            motion[h // 2:, :, 0] = 1.0
            np.savez_compressed(os.path.join(root, split,
                                             f"{scene}_motion.npz"), motion)


def train_cli_phase(scene_dir: str, img_path: str, flow_path: str):
    """``python -m slrsfs_tpu_torch.cli.train`` for 2 steps (full width,
    W = 64, batch 2) on a synthetic dataset, then SceneRenderer renders
    from the checkpoint it saved."""
    import shutil

    import torch

    from slrsfs_tpu_torch.cli.render import SceneRenderer

    root = os.path.join(OUT_DIR, "train_data")
    out = os.path.join(OUT_DIR, "train_run")
    for d in (root, out):
        shutil.rmtree(d, ignore_errors=True)
    write_train_fixture(root, SEED)
    cmd = [sys.executable, "-m", "slrsfs_tpu_torch.cli.train", "--data-root",
           root, "--out", out, "--batch-size", "2", "--W", "64", "--niter", "1",
           "--niter-decay", "0", "--steps-per-epoch", "2", "--val-steps", "1",
           "--seed", str(SEED)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    secs = time.perf_counter() - t0
    check(proc.returncode == 0, f"train CLI failed:\n{proc.stdout}\n{proc.stderr}")
    ckpt = os.path.join(out, "checkpoint.pth")
    check(os.path.exists(ckpt), "train CLI wrote no checkpoint")
    with open(os.path.join(out, "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    steps = [r for r in rows if r["split"] == "train"]
    check(len(steps) == 2, f"train CLI logged {len(steps)} steps")
    for r in rows:
        check(all(np.isfinite(v) for k, v in r.items() if k != "split"),
              f"train CLI log not finite: {r}")
    r = SceneRenderer(ckpt=ckpt, W=64, n_frames=8)
    out_dir, frames = render_capture(r, img_path, flow_path,
                                     os.path.join(scene_dir, "trained"),
                                     name="synthetic")
    torch.cuda.synchronize()
    check(tuple(frames.shape) == (8, 64, 64, 3), f"frames {frames.shape}")
    check(bool(torch.isfinite(frames).all()), "trained render not finite")
    pngs = sorted(os.listdir(os.path.join(out_dir, "PredImg")))
    check(len(pngs) == 8, f"trained render wrote {len(pngs)} PNGs")
    print(f"phase 11 train CLI: 2 steps + validation + checkpoint in "
          f"{secs:.1f} s (subprocess, kernels loaded from the build); last "
          f"step Total Loss {steps[-1]['Total Loss']:.4f}; SceneRenderer "
          f"rendered its checkpoint: 8 PNGs, frame range "
          f"[{frames.min().item():.3f}, {frames.max().item():.3f}]")


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
        euler_integrate_all_dual_plain,
    )
    from slrsfs_tpu_torch.ops.splat import (
        _corner_taps,
        corners,
        softsplat_sum_at_quad_dual_plain,
        splat_dual_normalize,
        splat_dual_normalize_plain,
        splat_dual_normalize_slr,
        splat_dual_normalize_slr_plain,
        splat_scratch,
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
    for source in dict.fromkeys(k.source for k in kernels.KERNELS):
        log = next(k.build_log for k in kernels.KERNELS if k.source == source)
        for line in log.splitlines():  # ptxas: registers, spills, wgmma
            if "registers" in line or "spill" in line or "wgmma" in line:
                print(f"phase 1 ptxas {os.path.basename(source)}: {line.strip()}")

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
    k4 = k4_phase(dev, flow)

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

        st["err_bf16"] = 0.0

        def compare(label, da, db, a, b, out_dtype=torch.float32, rtol=1e-5,
                    acc_dtype=torch.float32):
            o = torch.empty((H, W, C1 - n_norm), dtype=out_dtype, device=dev)
            u_mov, u_static = st["u_mov"].to(acc_dtype), st["u_static"].to(acc_dtype)
            wrapper(u_mov, positions, valid, da, db, a, b, u_static, out=o)
            ref = plain(u_mov, positions, valid, da, db, a, b, u_static, out_dtype)
            torch.cuda.synchronize()
            err = (o.float() - ref.float()).abs().max().item()
            if acc_dtype == torch.float32:
                check(torch.allclose(o.float(), ref.float(), rtol=rtol, atol=1e-5),
                      f"{name} {label}: max abs {err}")
                n_cancel = check_zeros(o, ref, f"{name} {label}")
                limit = (f"atol 1e-5, rtol {rtol:g}; empty cells match, {n_cancel} "
                         f"elements of reached cells exactly 0 on one side")
            else:
                # bf16 sums round at every add, in the atomics' order here
                # and in index order in the plain version; where many taps
                # pile up and signed features cancel, the normalised field
                # moves by percents. Both are held against the f32 sums: the
                # kernel's distance at most twice the plain version's.
                ref32 = plain(st["u_mov"], positions, valid, da, db, a, b,
                              st["u_static"], torch.float32)
                d_k = (o.float() - ref32).abs().max().item()
                d_p = (ref.float() - ref32).abs().max().item()
                check(d_k <= 2.0 * d_p, f"{name} {label}: kernel {d_k} from the "
                      f"f32 sums, over twice the plain version's {d_p}")
                # cells no moving tap reaches keep u_static's exact zeros
                reached = softsplat_sum_at_quad_dual_plain(
                    u_mov.abs(), positions, da, db, a, b, H, W)[..., :o.shape[-1]] != 0
                check(torch.equal((o == 0)[~reached], (ref == 0)[~reached]),
                      f"{name} {label}: zeros of unreached cells differ")
                st["err_bf16"] = max(st["err_bf16"], err)
                limit = (f"from the f32 sums: kernel {d_k:.3g}, plain {d_p:.3g}, "
                         f"limit 2x the plain's; max |out| {ref.float().abs().max().item():.3g}; "
                         f"unreached cells' zeros match")
            if out_dtype == torch.float32 and acc_dtype == torch.float32:
                st["err"] = max(st["err"], err)
            print(f"phase 3 {name} {label}: max abs {err:.3g} ({limit})")

        for t in T_CHECK:
            a = np.float32(1.0) - np.float32(t) / np.float32(N_FRAMES)
            compare(f"t={t}", disp_f[t], disp_b[N_FRAMES - t], float(a),
                    float(np.float32(1.0) - a))
        compare("sentinel/integer/border", special, disp_b[T_MID], 0.5, 0.5)
        compare(f"t={T_MID} bf16 out", disp_f[T_MID], disp_b[T_MID], 0.5, 0.5,
                out_dtype=torch.bfloat16, rtol=1e-2)
        for t in (1, T_MID):
            a = np.float32(1.0) - np.float32(t) / np.float32(N_FRAMES)
            compare(f"t={t} bf16 accumulation", disp_f[t], disp_b[N_FRAMES - t],
                    float(a), float(np.float32(1.0) - a), out_dtype=torch.bfloat16,
                    acc_dtype=torch.bfloat16)
        compare("sentinel/integer/border bf16 accumulation", special,
                disp_b[T_MID], 0.5, 0.5, acc_dtype=torch.bfloat16)
    k8 = k8_phase(dev, k2["K2"]["u_mov"], positions, disp_f[T_MID], disp_b[T_MID])

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
    dense_f, _ = euler_integrate_all_dual_plain(flow, N_FRAMES - 1, 1)
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
    v2_dense_all = kernels.counts()
    check(v2_dense_all == {**{k.name: 0 for k in kernels.KERNELS}, "euler_all": 1,
                           "splat_dense_fwd": 2 * N_FRAMES,
                           "maximum_warp_norm_splat": N_FRAMES},
          f"baseline dense v2 launches: {v2_dense_all}")
    v2_dense_launches = v2_dense_all["maximum_warp_norm_splat"]
    v2_path_err = (v2_frames - v2_plain).abs().max().item()
    v2_dense_err = (v2_frames - v2_dense).abs().max().item()
    img_t = torch.from_numpy(img[None]).to(dev)
    v2_sparse = lambda plain=False: r32v2.frames(img, flow_np, plain=plain)  # noqa: E731
    v2_diagnostic("baseline kernel vs plain path", v2_path_err, r32v2.model,
                  positions, valid, v2_sparse, lambda: v2_sparse(True))
    v2_diagnostic("baseline sparse vs dense", v2_dense_err, r32v2.model,
                  positions, valid, v2_sparse,
                  lambda: rollout.baseline_rollout(r32v2.model, img_t, flow, N_FRAMES))
    check(v2_path_err <= 1e-4, f"baseline v2 kernel vs plain path {v2_path_err}")
    check(v2_dense_err <= 1e-4, f"baseline sparse v2 vs dense v2 {v2_dense_err}")
    png = read_png(os.path.join(out_dir, "PredImg", f"{N_FRAMES - 1:06d}.png"))
    check(np.array_equal(png, to_u8(v2_frames[-1]).cpu().numpy()),
          "baseline v2 PNG differs from the frame")
    print(f"phase 5 baseline v2 render: launches {v2_launches}; kernel vs "
          f"plain path max abs {v2_path_err:.3g}, sparse v2 (K5) vs dense v2 "
          f"(K4, K3 forward and K6, launches {v2_dense_all}) max abs "
          f"{v2_dense_err:.3g} (limits 1e-4)")
    dense = dense_entry_phase(dev, r32.model, img, flow, frames32)

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
        if rg is not None:
            v2_diagnostic("SLR kernel vs plain path", slr_path_err[label],
                          slr[label].model, positions, valid,
                          lambda: slr[label].frames(img, flow_np, alpha_region=rg),
                          lambda: slr[label].frames(img, flow_np, plain=True,
                                                    alpha_region=rg))
        check(slr_path_err[label] <= 1e-4,
              f"SLR {label} kernel path vs plain path max abs "
              f"{slr_path_err[label]}")
    slr_bf_err = max_diff(slr_frames["bfloat16"], slr_frames["float32"])
    region_t = torch.from_numpy(region[None, ..., None]).to(dev)
    kernels.reset_counts()
    dense_v2 = rollout.slr_rollout_dense(slr["float32 v2"].model, img_t, flow,
                                         N_FRAMES, alpha_region=region_t)
    torch.cuda.synchronize()
    dense_launches = kernels.counts()
    check(dense_launches == {**{k.name: 0 for k in kernels.KERNELS}, "euler_all": 1,
                             "splat_dense_fwd": 2 * N_FRAMES,
                             "maximum_warp_norm_splat": N_FRAMES},
          f"SLR dense v2 render launches: {dense_launches}")
    sparse_dense_err = max_diff(slr_frames["float32 v2"], dense_v2)
    v2_diagnostic("SLR sparse vs dense", sparse_dense_err, slr["float32 v2"].model,
                  positions, valid,
                  lambda: slr["float32 v2"].frames(img, flow_np, alpha_region=region),
                  lambda: rollout.slr_rollout_dense(slr["float32 v2"].model, img_t,
                                                    flow, N_FRAMES,
                                                    alpha_region=region_t))
    check(sparse_dense_err <= 1e-4,
          f"SLR sparse v2 (K5) vs dense v2 (K6) max abs {sparse_dense_err}")
    print(f"phase 6 SLR checks: kernel vs plain path max abs "
          f"{slr_path_err['float32']:.3g} (v2 {slr_path_err['float32 v2']:.3g}; "
          f"limit 1e-4); sparse v2 (K5) vs dense v2 (K6, launches "
          f"{dense_launches['maximum_warp_norm_splat']}) max abs "
          f"{sparse_dense_err:.3g} (limit 1e-4); bf16 vs f32 max abs "
          f"{slr_bf_err:.3g}")
    fast = bf16_fast_phase(img_path, flow_path, scene_dir,
                           {"baseline": (rbf, framesbf),
                            "SLR": (slr["bfloat16"], slr_frames["bfloat16"])},
                           img, flow_np)

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
        # the bf16 accumulation mode on the same frame: bf16 rows, static
        # identity and accumulator, the f32 field out
        bf = torch.bfloat16
        args_bf = (st["u_mov"].to(bf),) + args[1:-1] + (st["u_static"].to(bf),)
        acc_bf = splat_scratch(H, W, C1, bf, dev)
        st["ms_bf16"] = cuda_time(lambda: st["wrapper"](*args_bf, out=st["out"],
                                                        acc=acc_bf), reps=50)
        st["plain_ms_bf16"] = cuda_time(lambda: st["plain"](*args_bf, f32), reps=10)
        rows_bf, flat_bf = rows_all.to(bf), flat.to(bf)
        st["lib_ms_bf16"] = cuda_time(lambda: flat_bf.index_add_(0, lin_all, rows_bf),
                                      reps=50)
        st["bound_bf16"] = bound(n_valid * (C1 * 2 + 8 + 16) + P * 4
                                 + H * W * C1 * 2 + H * W * C * 4,
                                 2 * n_valid * C1 * (1 + 4 * 2) + H * W * C)
        del lin_all, rows_all, flat, rows_bf, flat_bf, acc_bf

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
              f"{st['bound'][0]:.4f} ms by {st['bound'][1]}); bf16 accumulation "
              f"{st['ms_bf16']:.4f} ms/frame (plain {st['plain_ms_bf16']:.3f} ms, "
              f"bf16 index_add_ {st['lib_ms_bf16']:.4f} ms, bound "
              f"{st['bound_bf16'][0]:.4f} ms by {st['bound_bf16'][1]})")
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
    fps.update({f"{k} bfloat16-fast": v["fps"] for k, v in fast.items()})
    fps.update({f"dense baseline float32 ({k})": v["fps"] for k, v in dense.items()})

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

    del chunk, chunk_bf, chunk65, chunk65_bf
    torch.cuda.empty_cache()
    k9 = k9_phase(dev)

    # ---- phases 8-11: training ---------------------------------------
    k7 = k7_phase(dev, flow_np)
    k3 = k3_phase(dev, flow_np)
    train = training_phase(dev)
    st = train["stages"]
    print(f"phase 10 step stages with the kernels (dense, B={train['B']}): "
          f"G forward {st['G forward']:.1f} ms, of which K7 {k7['ms']:.3f} ms "
          f"and K3 forward x2 {2 * k3['ms_fwd']:.3f} ms; G backward "
          f"{st['G backward']:.1f} ms, of which K3 backward x2 "
          f"{2 * k3['ms_bwd']:.3f} ms; D step {st['D step']:.1f} ms; updates "
          f"{st['updates']:.1f} ms; K3 and K7 together "
          f"{100 * (k7['ms'] + 2 * k3['ms_fwd'] + 2 * k3['ms_bwd']) / train['step_ms']:.2f} "
          f"% of the step")
    train_cli_phase(scene_dir, img_path, flow_path)

    # ---- phase 12: summary -------------------------------------------
    def row(name, source, replaces, launches_, err, ms, plain_ms, bnd, lib_ms):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches_, "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0],
                "bound_by": bnd[1], "library_ms": lib_ms}

    rows_out = [
        row("euler_compact_dual", "slrsfs_tpu_torch/csrc/euler.cu",
            "slrsfs_tpu/ops/euler.py:145", launches["euler_compact_dual"],
            k1_err, ms_k1, ms_k1_plain, k1_bound, None),
        row("euler_all", "slrsfs_tpu_torch/csrc/euler.cu",
            "slrsfs_tpu/ops/euler.py:199", dense["entry()"]["launches"]["euler_all"],
            k4["err"], k4["ms"], k4["plain_ms"], k4["bound"], None),
        row("splat_dual_normalize", "slrsfs_tpu_torch/csrc/splat.cu",
            "slrsfs_tpu/ops/splat.py:390", launches["splat_dual_normalize"],
            k2["K2"]["err"], k2["K2"]["ms"], k2["K2"]["plain_ms"],
            k2["K2"]["bound"], k2["K2"]["lib_ms"]),
        row("splat_dual_normalize_slr", "slrsfs_tpu_torch/csrc/splat.cu",
            "slrsfs_tpu/ops/splat.py:390",
            slr_launches["float32"]["splat_dual_normalize_slr"],
            k2["K2-SLR"]["err"], k2["K2-SLR"]["ms"], k2["K2-SLR"]["plain_ms"],
            k2["K2-SLR"]["bound"], k2["K2-SLR"]["lib_ms"]),
        row("splat_dual_normalize (bf16 accumulation)",
            "slrsfs_tpu_torch/csrc/splat.cu", "slrsfs_tpu/ops/splat.py:390",
            fast["baseline"]["launches"], k2["K2"]["err_bf16"],
            k2["K2"]["ms_bf16"], k2["K2"]["plain_ms_bf16"], k2["K2"]["bound_bf16"],
            k2["K2"]["lib_ms_bf16"]),
        row("splat_dual_normalize_slr (bf16 accumulation)",
            "slrsfs_tpu_torch/csrc/splat.cu", "slrsfs_tpu/ops/splat.py:390",
            fast["SLR"]["launches"], k2["K2-SLR"]["err_bf16"],
            k2["K2-SLR"]["ms_bf16"], k2["K2-SLR"]["plain_ms_bf16"],
            k2["K2-SLR"]["bound_bf16"], k2["K2-SLR"]["lib_ms_bf16"]),
        *[row("splat_sum_at" + ("" if label == "f32" else " (bf16)"),
              "slrsfs_tpu_torch/csrc/splat.cu", "slrsfs_tpu/ops/splat.py:255",
              r8["launches"], r8["err"], r8["ms"], r8["plain_ms"], r8["bound"],
              r8["lib_ms"]) for label, r8 in k8.items()],
        row("maximum_warp_norm_sparse", "slrsfs_tpu_torch/csrc/maxwarp_sparse.cu",
            "slrsfs_tpu/ops/splat.py:492",
            slr_launches["float32 v2"]["maximum_warp_norm_sparse"], k5_err,
            ms_k5, ms_k5_plain, k5_bound, lib["K5"]),
        row("maximum_warp_norm_splat", "slrsfs_tpu_torch/csrc/maxwarp.cu",
            "slrsfs_tpu/ops/splat.py:240",
            dense_launches["maximum_warp_norm_splat"], k6_err, ms_k6,
            ms_k6_plain, k6_bound, lib["K6"]),
        row("splat_dense_fwd", "slrsfs_tpu_torch/csrc/splat_dense.cu",
            "slrsfs_tpu/ops/splat.py:139", train["launches"]["splat_dense_fwd"],
            k3["fwd_err"], k3["ms_fwd"], k3["plain_fwd"], k3["bound_fwd"],
            k3["lib_fwd"]),
        row("splat_dense_bwd", "slrsfs_tpu_torch/csrc/splat_dense.cu",
            "slrsfs_tpu/ops/splat.py:111", train["launches"]["splat_dense_bwd"],
            k3["bwd_err"], k3["ms_bwd"], k3["plain_bwd"], k3["bound_bwd"], None),
        row("euler_phased", "slrsfs_tpu_torch/csrc/euler_phased.cu",
            "slrsfs_tpu/ops/euler.py:249", train["launches"]["euler_phased"],
            k7["err"], k7["ms"], k7["plain_ms"], k7["bound"], None),
        row("fused_conv3x3_relu_conv3x3", "slrsfs_tpu_torch/csrc/fused_conv.cu",
            "tools/pallas_conv_prototype.py:118", k9["launches"], k9["err"],
            k9["ms"], k9["plain_ms"], k9["bound"], k9["lib_ms"]),
    ]
    print("phase 12 render fps: " + ", ".join(f"{k} {v:.2f}" for k, v in fps.items())
          + f"; training step {train['step_ms']:.1f} ms at B={train['B']} "
          f"({train['B'] / train['step_ms'] * 1e3:.2f} samples/s); all checks passed")
    print(smi)
    print(json.dumps({"kernels": rows_out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
