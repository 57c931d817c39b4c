#!/usr/bin/env python3
"""Smoke test of the PyTorch port (slrsfs_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --maxwarp-in TREE   # K5 and K6 of another tree
    python3 chip_smoke.py --k2-in TREE        # K2 and K8 of another tree
    python3 chip_smoke.py --k3-in TREE        # K3 and K7 of another tree

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
against its plain path; K3's forward is also held and timed at the dense
render's own shape, one frame end of (1, 256, 256, 65). K4 is checked bit for bit in every form; K8 (the
exported single- and two-ended raw splats) and K2's bf16 mode against their
plain versions in f32 (1e-5) and bf16 (1e-2 of the largest value). K9, the
fused bf16 conv3x3 -> ReLU -> conv3x3 (wgmma over a ring of packed weight
taps), runs through the port's prototype bench
(slrsfs_tpu_torch/tools/conv_prototype.py: the prototype's slice and, at
B = 60, 256 x 480, C = F = 128, the kernel, cuDNN and the plain chain
timed, with the kernel's issued/useful work, shared memory and registers)
and at a ragged shape: within 2^-7 of max |plain| with at most 0.1 % of
the elements more than one bf16 ulp apart; the kernel's, the plain
chain's and cuDNN's share beyond one ulp of a float64 chain is printed.
K5 and K6 (one cooperative launch each) are held bit for bit in every
case, all rows padded and a batch of 2 included, and torch.profiler
counts the CUDA kernels one call of each runs on the card (one). A v2
render comparison above 1e-5 (the usual value is ~1e-6; the limit is 1e-4)
reruns both sides and prints each stage's largest difference (packed
rows, splat field, decoded frames) and the splat field's elements that
are exactly 0 on one side only, then reruns both sides with
cudnn.deterministic.

Then the stage-1 training path (Options() defaults at full width, batch 16,
W = 256, T = 60, float32; a smaller batch only if 16 does not fit, said so):
K7 (phased Euler integration, dense and compact) bit for bit and K3 (the
dense splat's scatter forward and gather backward) at 1e-5 against their
plain versions, each timed with its split and bound (K3's backward on a
random and the scene flow); one warm-up and 3 timed G+D steps of Trainer.train_step on
a synthetic batch, dense and with 50 % moving rows (compact K7), with their
launch counts, CUDA-event stage times and peak memory; a kernel-path step
against a plain-path step from one snapshot; and the train CLI for 2 steps
on a synthetic dataset, whose checkpoint SceneRenderer then renders.

Each path runs with the launch counts set to 0 just before it and read just
after. The script times the renders and the steps with CUDA events, and
each kernel three ways (kernel_times): as called (events around a loop of
calls: the card's time or the host's, whichever is longer), on the card
alone (device_time: the calls queued behind a sleep of the card, so they
run back to back; the phase fails unless the host enqueued them all
before the sleep ended) and the host's cost per call. It prints:

* one line per phase (and ptxas's register/spill report per kernel);
* the card's name and power limit as nvidia-smi reports them;
* one JSON line {"kernels": [...]} with each kernel's launches on its path,
  error against its plain version, times and bound ("ms" is the card's
  time alone, as is "library_ms" but for K9's cuDNN chain, which its bench
  times as called; "plain_ms" is as called);
* last, {"ok": true, "device": {...}}.

Any failed check raises and the script exits non-zero without the last
line. It also fails when no CUDA device is present. The rendered PNGs go
to build/chip_smoke/ (git-ignored). With --maxwarp-in TREE it only times
K5 and K6 of the package in TREE, another unpacked tree of this
repository, beside their yardstick, and the SLR f32 v2 render that K5
serves; with --k2-in TREE, K2 and K2-SLR in f32 and bf16 accumulation
(with the card's work per call split by torch.profiler into memset,
scatter and epilogue, and the f32 window scatter's misses), K8 and the
float32, bfloat16 and bfloat16-fast renders of both models; with --k3-in
TREE, K3's forward at the dense render's and the training shape (split
into the output's zeroing and the scatter, with the window misses), K3's
backward on the training shape's random and scene flows, K7 dense and
compact (each with its split), the dense float32 render and the stage-1
training step (slrsfs_tpu_torch/tools/compare.sh runs any of them on
several trees in turns).
"""

from __future__ import annotations

import contextlib
import gc
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
# The same cores' rate in lane-instructions: 67e12 counts an FMA as two
# flops, and a round, clamp, compare, select or add is one instruction.
LANE_OPS = 33.5e12
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


def device_time(fn, reps: int, warmup: int = 2):
    """(device ms per call, host us per call) of ``fn``.

    The ``reps`` calls are queued behind ``torch.cuda._sleep``, with the
    start event recorded after the sleep, so the card runs them back to
    back whatever the host's cost per call; the host's enqueue time is read
    with ``time.perf_counter`` while the card sleeps. The phase fails unless
    the enqueue (the sleep's own launch included) was shorter than the
    sleep: else the card waited for the host, and the time would be the
    host's. The sleep is four times a first enqueue of the calls (at least
    1 ms; the sleep's cycles per ms are measured first) and doubles up to
    twice when the host was late."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(warmup):
        fn()
    start.record()
    torch.cuda._sleep(1_000_000)
    end.record()
    torch.cuda.synchronize()
    cycles_per_ms = 1e6 / start.elapsed_time(end)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sleep_ms = max(1.0, 4e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    for _ in range(3):
        t0 = time.perf_counter()
        torch.cuda._sleep(int(sleep_ms * cycles_per_ms))
        start.record()
        t1 = time.perf_counter()
        for _ in range(reps):
            fn()
        t2 = time.perf_counter()
        end.record()
        torch.cuda.synchronize()
        if (t2 - t0) * 1e3 < sleep_ms:
            return start.elapsed_time(end) / reps, (t2 - t1) / reps * 1e6
        sleep_ms *= 2.0
    check(False, f"device_time: enqueueing {reps} calls took {(t2 - t0) * 1e3:.3f} "
          f"ms, not shorter than the {sleep_ms / 2.0:.3f} ms sleep")


def kernel_times(fn, reps: int, warmup: int = 2) -> dict:
    """``fn`` timed as called (``cuda_time``: events around a loop of
    calls, host and card together) and on the card alone
    (``device_time``): {"called": ms, "ms": device ms, "host_us": us}."""
    called = cuda_time(fn, reps, warmup)
    ms, host_us = device_time(fn, reps, warmup)
    return {"called": called, "ms": ms, "host_us": host_us}


def fmt_times(t: dict) -> str:
    return (f"device {t['ms']:.4f} ms (as called {t['called']:.4f} ms, host "
            f"{t['host_us']:.1f} us)")


def launch_split(fn, reps: int = 10) -> dict:
    """The card's work in one call of ``fn``, split by CUDA kernel, memset
    and copy: {name: (launches per call, device us per call)}, from a
    ``torch.profiler`` trace of ``reps`` calls after one warm-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n, us = total.get(e.name, (0, 0.0))
            total[e.name] = (n + 1, us + e.time_range.elapsed_us())
    return {k: (n / reps, us / reps) for k, (n, us) in total.items()}


def kernels_per_call(fn, reps: int = 4):
    """(CUDA kernels the card ran per call of ``fn``, their names), from
    ``launch_split``; copies and memsets are not counted."""
    split = launch_split(fn, reps)
    names = sorted(k for k in split if not k.startswith(("Memcpy", "Memset")))
    return sum(split[k][0] for k in names), names


def fmt_split(split: dict) -> str:
    return "; ".join(f"{k} {us:.2f} us" for k, (_, us) in split.items()) + (
        f" (sum {sum(us for _, us in split.values()):.2f} us)")


def window_misses(kind: str, *args) -> str:
    """The share of the f32 window scatter's in-grid corners that land
    outside their unit's window (each then an entry of its own, reduced
    into its cell alone), counted on the host from the displacements and
    the tiling that the package's kernel library reports
    (``ops/splat.py:rows_window_misses`` for kind "rows", args positions,
    valid, displacements; ``dense_window_misses`` for "dense", args flow).
    Kind "dense bwd", args flow and C: the same count for K3's backward
    (a corner outside the window reads g from device memory), with the
    share of its tiles that hold such a corner (``dense_window_units``).
    A package without the window (an older tree of ``--k2-in`` or
    ``--k3-in``) says so."""
    from slrsfs_tpu_torch import kernels
    from slrsfs_tpu_torch.ops import splat as S

    if kind == "dense bwd":
        if not hasattr(S, "dense_window_units"):
            return "window misses: this package's backward has no window"
        lib = kernels.SPLAT_DENSE_BWD
        tile = (lib.query("splat_dense_bwd_tile_rows"), lib.query("splat_dense_bwd_tile_cols"))
        cap = lib.query("splat_dense_bwd_window_cells", args[1])
        n_in, n_miss = S.dense_window_misses(args[0], tile, cap)
        units, missing = S.dense_window_units(args[0], tile, cap)
        return (f"window misses {n_miss} of {n_in} corners in the grid "
                f"({100.0 * n_miss / max(n_in, 1):.2f} %; {tile[0]}x{tile[1]} tiles, "
                f"windows of {cap} cells; {missing} of {units} tiles "
                f"({100.0 * missing / max(units, 1):.2f} %) hold a miss)")
    if not hasattr(S, "rows_window_misses"):
        return "window misses: this package's scatter has no window"
    if kind == "rows":
        run = kernels.SPLAT.query("splat_rows_run")
        cap = kernels.SPLAT.query("splat_rows_window_cells")
        n_in, n_miss = S.rows_window_misses(*args, H, W, run, cap)
        geometry = f"runs of {run} rows"
    else:
        ty = kernels.SPLAT_DENSE_FWD.query("splat_dense_tile_rows")
        tx = kernels.SPLAT_DENSE_FWD.query("splat_dense_tile_cols")
        cap = kernels.SPLAT_DENSE_FWD.query("splat_dense_window_cells")
        n_in, n_miss = S.dense_window_misses(args[0], (ty, tx), cap)
        geometry = f"{ty}x{tx} tiles"
    return (f"window misses {n_miss} of {n_in} corners in the grid "
            f"({100.0 * n_miss / max(n_in, 1):.2f} %; {geometry}, windows of {cap} cells)")


def bound(n_bytes: float, n_ops: float, peak: float = FP32_FLOPS):
    """(least ms, 'bytes' or 'operations') on the card's peak rates."""
    tb, to = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / peak * 1e3
    return max(tb, to), "bytes" if tb >= to else "operations"


@contextlib.contextmanager
def no_gc():
    """Python's garbage collector run first and then held off, so that a
    collection of the process's many objects (~0.1 s) does not land inside
    a timed render or step."""
    gc.collect()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()


def render_median(r, img, flow, reps: int = 3):
    """Median seconds of ``r.frames`` over ``reps`` runs after one warm-up."""
    import torch

    r.frames(img, flow)
    torch.cuda.synchronize()
    ts = []
    with no_gc():
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


def v2_diagnostic(label, err, model, positions, valid, run_a, run_b, first=None):
    """When a v2 comparison lands above 1e-5 (the usual value is ~1e-6),
    run both sides again and print each stage's largest difference (packed
    rows, splat field, decoded frames) and how many elements of the splat
    field are exactly 0 on one side only (the decoders' hole mask is
    ``x != 0``): for ``first``, the stages recorded in the first call of
    side a (the comparison's own), against side b run again; and for both
    sides run again. Then both sides once more with
    ``torch.backends.cudnn.deterministic``: the frames' largest
    difference."""
    import torch

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

    def stages(x, y):
        zeros = sum(int(((p == 0) != (q == 0)).sum()) for p, q in zip(x[1], y[1]))
        return (f"packed rows {diff(x[0], y[0]):.3g} ({len(x[0])}/{len(y[0])} "
                f"frames), splat field {diff(x[1], y[1]):.3g} ({zeros} elements "
                f"exactly 0 on one side only), decoded frames {diff(x[2], y[2]):.3g}")

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        det = diff(run_a(), run_b())
    finally:
        torch.backends.cudnn.deterministic = deterministic
    head = f"phase 5-6 v2 diagnostic {label} ({err:.3g} > 1e-5)"
    if first is not None:
        print(f"{head}: first call vs the other side again: {stages(first, b)}; "
              f"first call vs its own path again: frames {diff(first[2], a[2]):.3g}")
    print(f"{head}: both sides again: {stages(a, b)}; both sides again with "
          f"cudnn.deterministic: frames {det:.3g}")


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
    t = kernel_times(lambda: E.euler_integrate_all_dual(flow, n_f, n_b), reps=20)
    plain_ms = cuda_time(lambda: E.euler_integrate_all_dual_plain(flow, n_f, n_b),
                         reps=3, warmup=1)
    R, steps = H * W, n_f + n_b
    # bytes: the motion in, both displacement stacks (steps + 2 entries) out;
    # per trajectory step ~12 operations (round x2, add x2, 4 compares,
    # subtract x2, 2 selects)
    bnd = bound(R * 8 + (steps + 2) * R * 8, steps * R * 12)
    print(f"phase 2 K4 dense dual: {fmt_times(t)}; plain {plain_ms:.2f} ms; bound "
          f"{bnd[0]:.4f} ms by {bnd[1]}")
    return {"err": err, "ms": t["ms"], "plain_ms": plain_ms, "bound": bnd}


def k2_inputs(dev, rng, flow, positions, valid) -> dict:
    """K2's and K2-SLR's rows at the render's shapes, drawn from ``rng``:
    {name: state} with the moving rows, the static identity, the wrapper,
    its plain version and an f32 accumulator and output."""
    import torch

    from slrsfs_tpu_torch.ops.splat import (
        splat_dual_normalize,
        splat_dual_normalize_plain,
        splat_dual_normalize_slr,
        splat_dual_normalize_slr_plain,
    )

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
        C1 = u.shape[-1]
        k2[name] = dict(
            u_static=(u * static[..., None]).contiguous(),
            u_mov=(u[py, px] * valid[:, None]).contiguous(), C1=C1,
            wrapper=splat_dual_normalize_slr if slr else splat_dual_normalize,
            plain=splat_dual_normalize_slr_plain if slr else splat_dual_normalize_plain,
            n_norm=n_norm, err=0.0, err_bf16=0.0,
            acc=torch.empty((H * W * C1,), dtype=torch.float32, device=dev),
            out=torch.empty((H, W, C1 - n_norm), dtype=torch.float32, device=dev))
    return k2


def k2_times(dev, name, st, positions, valid, disp_a, disp_b) -> None:
    """K2 or K2-SLR (``st`` from ``k2_inputs``) at one frame of the render,
    f32 and bf16 accumulation: as called, on the card alone and the host's
    cost per call (``kernel_times``), the card's work per call split by
    ``launch_split`` (f32: copy, scatter, epilogue; bf16: memset if any,
    scatter, epilogue), the plain version, one ``index_add_`` of the same
    corner rows and the bound; stored in ``st`` and printed."""
    import torch

    from slrsfs_tpu_torch.ops.splat import _corner_taps, splat_scratch

    f32, bf = torch.float32, torch.bfloat16
    P, n_valid = positions.shape[0], int((valid > 0.5).sum())
    px, py = positions[:, 0].float(), positions[:, 1].float()
    C1, C = st["C1"], st["C1"] - st["n_norm"]
    w = 0.5
    args = (st["u_mov"], positions, valid, disp_a, disp_b, w, w, st["u_static"])
    # the bf16 accumulation mode on the same frame: bf16 rows, static
    # identity and accumulator, the f32 field out
    args_bf = (st["u_mov"].to(bf),) + args[1:-1] + (st["u_static"].to(bf),)
    acc_bf = splat_scratch(H, W, C1, bf, dev)
    calls = {"": (lambda: st["wrapper"](*args, out=st["out"], acc=st["acc"]),
                  args, f32, st["acc"]),
             "_bf16": (lambda: st["wrapper"](*args_bf, out=st["out"], acc=acc_bf),
                       args_bf, bf, acc_bf)}
    # yardstick: the same scatter as ONE index_add_ into the flat buffer
    lins, rows = [], []
    for d in (disp_a, disp_b):
        for lin, wk in _corner_taps(px + d[:, 0], py + d[:, 1], H, W):
            lins.append(lin)
            rows.append(st["u_mov"] * w * (wk * valid)[:, None])
    lin_all, rows_all = torch.cat(lins), torch.cat(rows)
    del lins, rows
    for sfx, (call, a, dtype, acc) in calls.items():
        e_b = 2 if dtype == bf else 4
        st["t" + sfx] = kernel_times(call, reps=50)
        st["ms" + sfx] = st["t" + sfx]["ms"]
        st["split" + sfx] = launch_split(call)
        st["plain_ms" + sfx] = cuda_time(lambda: st["plain"](*a, f32), reps=10)
        flat = a[-1].reshape(H * W, C1).clone()
        rows_d = rows_all.to(dtype)
        st["t_lib" + sfx] = kernel_times(lambda: flat.index_add_(0, lin_all, rows_d),
                                         reps=50)
        st["lib_ms" + sfx] = st["t_lib" + sfx]["ms"]
        # moving rows, positions and both displacements of the valid rows;
        # the valid flags of all rows; the static identity in, the f32
        # field out; per valid row and end a scale and 4 multiply-adds per
        # channel, per output a division
        st["bound" + sfx] = bound(n_valid * (C1 * e_b + 8 + 16) + P * 4
                                  + H * W * C1 * e_b + H * W * C * 4,
                                  2 * n_valid * C1 * (1 + 4 * 2) + H * W * C)
        del flat, rows_d
    del lin_all, rows_all, acc_bf
    st["misses"] = window_misses("rows", positions, valid, (disp_a, disp_b))
    for sfx, label in (("", "f32"), ("_bf16", "bf16 accumulation")):
        print(f"phase 3 {name} {label} per frame: {fmt_times(st['t' + sfx])}; plain "
              f"{st['plain_ms' + sfx]:.3f} ms; index_add_ {fmt_times(st['t_lib' + sfx])}; "
              f"bound {st['bound' + sfx][0]:.4f} ms by {st['bound' + sfx][1]}")
        print(f"phase 3 {name} {label} per call on the card (torch.profiler): "
              f"{fmt_split(st['split' + sfx])}")
    print(f"phase 3 {name} f32 {st['misses']}")
    print(f"phase 3 {name} bf16 accumulation against f32 on the card: "
          f"{st['ms_bf16']:.4f} / {st['ms']:.4f} ms = {st['ms_bf16'] / st['ms']:.2f}x")


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
        t = kernel_times(lambda: S.softsplat_sum_at(u, positions, disp_a, H, W),
                         reps=50)
        t_dual = kernel_times(lambda: S.softsplat_sum_at_quad_dual(
            u, positions, disp_a, disp_b, 0.5, 0.5, H, W), reps=50)
        split = launch_split(lambda: S.softsplat_sum_at(u, positions, disp_a, H, W))
        split_dual = launch_split(lambda: S.softsplat_sum_at_quad_dual(
            u, positions, disp_a, disp_b, 0.5, 0.5, H, W))
        plain_ms = cuda_time(lambda: S.softsplat_sum_at_plain(u, positions, disp_a,
                                                              H, W), reps=10)
        lins, rows = [], []
        for lin, w in S._corner_taps(px + disp_a[:, 0], py + disp_a[:, 1], H, W):
            lins.append(lin)
            rows.append((u.float() * w[:, None]).to(dtype))
        lin_all, rows_all = torch.cat(lins), torch.cat(rows)
        acc = torch.zeros((H * W, C), dtype=dtype, device=dev)
        t_lib = kernel_times(lambda: acc.index_add_(0, lin_all, rows_all), reps=50)
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
              f"({limit}); one end {fmt_times(t)}; two ends {fmt_times(t_dual)}; "
              f"plain {plain_ms:.3f} ms; index_add_ of the 4P rows {fmt_times(t_lib)}; "
              f"bound {bnd[0]:.4f} ms by {bnd[1]}")
        print(f"phase 3 K8 {label} per call on the card (torch.profiler): one end "
              f"{fmt_split(split)}; two ends {fmt_split(split_dual)}")
        if dtype == torch.float32:
            for ends, disps in (("one end", (disp_a,)), ("two ends", (disp_a, disp_b))):
                print(f"phase 3 K8 f32 {ends} "
                      f"{window_misses('rows', positions, None, disps)}")
        res[label] = {"launches": launches["splat_sum_at"], "err": err, "ms": t["ms"],
                      "ms_dual": t_dual["ms"], "plain_ms": plain_ms,
                      "lib_ms": t_lib["ms"], "bound": bnd}
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


def k3_fwd_times(dev, label, inp, flow, reps, plain_reps=10):
    """K3's forward on inp (B, H, W, C) by flow (B, H, W, 2): as called, on
    the card alone and the host's cost per call (``kernel_times``), the
    card's work per call split by ``launch_split`` (the output's zeroing and
    the scatter), the plain version, one ``index_add_`` of the 4·B·HW
    weighted rows, the bound and the window misses; printed after
    ``label``."""
    import torch

    from slrsfs_tpu_torch.ops.splat import (
        _corner_taps,
        softsplat_sum_fwd_kernel,
        softsplat_sum_plain,
    )

    B, H_, W_, C = inp.shape
    t = kernel_times(lambda: softsplat_sum_fwd_kernel(inp, flow), reps=reps)
    split = launch_split(lambda: softsplat_sum_fwd_kernel(inp, flow))
    plain_ms = cuda_time(lambda: softsplat_sum_plain(inp, flow), reps=plain_reps,
                         warmup=1)
    xs = torch.arange(W_, device=dev, dtype=torch.float32)[None, :]
    ys = torch.arange(H_, device=dev, dtype=torch.float32)[:, None]
    lins, rows = [], []
    for b in range(B):
        for lin, w in _corner_taps((xs + flow[b, ..., 0]).reshape(-1),
                                   (ys + flow[b, ..., 1]).reshape(-1), H_, W_):
            lins.append(lin + b * H_ * W_)
            rows.append(inp[b].reshape(H_ * W_, C) * w[:, None])
    lin_all, rows_all = torch.cat(lins), torch.cat(rows)
    del lins, rows
    acc = torch.zeros((B * H_ * W_, C), device=dev)
    t_lib = kernel_times(lambda: acc.index_add_(0, lin_all, rows_all), reps=reps)
    del lin_all, rows_all, acc
    n = B * H_ * W_
    # inp and flow in, out out; per pixel ~20 ops of corner math and per
    # channel 4 multiplies and 4 adds
    bnd = bound(n * C * 4 * 2 + n * 8, n * (8 * C + 20))
    misses = window_misses("dense", flow)
    print(f"{label}: {fmt_times(t)}; plain {plain_ms:.3f} ms; index_add_ "
          f"{fmt_times(t_lib)}; bound {bnd[0]:.4f} ms by {bnd[1]}")
    print(f"{label} per call on the card (torch.profiler): {fmt_split(split)}; {misses}")
    return {"t": t, "ms": t["ms"], "plain_ms": plain_ms, "lib_ms": t_lib["ms"],
            "bound": bnd, "split": split, "misses": misses}


def k3_dense_inputs(dev, flow):
    """K3's forward at the dense render's own shape: one frame end of
    ``baseline_rollout`` splats (1, 256, 256, 65) rows (the packed
    [fs·e^Z, e^Z] width) by the scene's displacement integrated to t =
    T_MID."""
    import torch

    from slrsfs_tpu_torch.ops.euler import euler_integrate_all_dual_plain

    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    inp = torch.randn((1, H, W, 65), generator=gen, device=dev)
    disp = euler_integrate_all_dual_plain(flow, N_FRAMES - 1, N_FRAMES)[0][T_MID]
    return inp, disp[None].contiguous()


def k3_check(label, inp, flow) -> tuple:
    """K3's forward against its plain version (atol/rtol 1e-5, the same
    empty cells): (max abs, elements of reached cells exactly 0 on one side
    only, empty cells)."""
    import torch

    from slrsfs_tpu_torch.ops.splat import softsplat_sum_fwd_kernel, softsplat_sum_plain

    out = softsplat_sum_fwd_kernel(inp, flow)
    ref = softsplat_sum_plain(inp, flow)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    check(torch.allclose(out, ref, rtol=1e-5, atol=1e-5), f"{label}: max abs {err}")
    return err, check_zeros(out, ref, label), int((ref == 0).all(-1).sum())


def k3_dense_render_times(dev, flow):
    """K3's forward at the dense render's own shape (``k3_dense_inputs``),
    held against its plain version and timed (``k3_fwd_times``)."""
    inp, disp = k3_dense_inputs(dev, flow)
    label = f"phase 5 K3 forward at the dense render's shape (1, {H}, {W}, 65), t={T_MID}"
    err, n_cancel, _ = k3_check(label, inp, disp)
    print(f"{label}: max abs {err:.3g} vs plain (atol/rtol 1e-5, empty cells match; "
          f"{n_cancel} elements of reached cells exactly 0 on one side)")
    res = k3_fwd_times(dev, label, inp, disp, reps=50)
    res["err"] = err
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
    t = {"called": res["ms"]["kernel"]}
    t["ms"], t["host_us"] = device_time(
        lambda: fc.fused_conv3x3_relu_conv3x3(x, waa, wab), reps=3, warmup=1)
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
          + f"; kernel {fmt_times(t)}; bound {bnd[0]:.3f} ms by {bnd[1]}; launches "
          f"{launches['fused_conv3x3_relu_conv3x3']}; "
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
           "ms": t["ms"], "plain_ms": res["ms"]["plain"],
           "lib_ms": res["ms"]["library"], "bound": bnd}
    del x, waa, wab, res
    torch.cuda.empty_cache()
    return out


def maxwarp_inputs(dev):
    """K5's and K6's inputs at the v2 render's shapes, from the synthetic
    scene: Z drawn from a seed, the moving set (P = 32768), its K1
    displacement at T_MID and the dense displacement at T_MID, both from
    the plain integrators."""
    import torch

    from slrsfs_tpu_torch.engine.rollout import prepare_scene_sparse
    from slrsfs_tpu_torch.ops.euler import (
        euler_compact_dual_plain,
        euler_integrate_all_dual_plain,
    )

    _, flow_np = synthetic_scene(SEED)
    pos_np, val_np = prepare_scene_sparse(flow_np)
    flow = torch.from_numpy(flow_np).to(dev)
    positions = torch.from_numpy(pos_np).to(dev)
    valid = torch.from_numpy(val_np).to(dev)
    z2d = torch.from_numpy((np.random.default_rng(SEED + 5).standard_normal((H, W))
                            * 3.0).astype(np.float32)).to(dev)
    static = (flow.abs().sum(-1) == 0).to(torch.float32)
    z_mov = z2d[positions[:, 1].long(), positions[:, 0].long()].contiguous()
    d_mid = euler_compact_dual_plain(flow, positions, N_FRAMES - 1, N_FRAMES)[0][T_MID]
    fl_mid = euler_integrate_all_dual_plain(flow, N_FRAMES - 1, 1)[0][T_MID][None]
    return (z2d, static, z_mov, positions, valid, d_mid.contiguous(),
            z2d[None, ..., None].contiguous(), fl_mid.contiguous())


def maxwarp_phase(dev, z2d, static, z_mov, positions, valid, d_mid, z4, fl_mid):
    """K5 and K6 at the v2 render's shapes (t = T_MID): as called, on the
    card alone and the host's cost per call (``kernel_times``), the plain
    versions, the yardstick (one ``scatter_reduce_(amax)`` of the same
    corner rows), the bound, and the CUDA kernels one call runs on the card
    (``torch.profiler``, after the timings)."""
    import torch

    from slrsfs_tpu_torch.ops import maxwarp
    from slrsfs_tpu_torch.ops.splat import corners

    P, n_valid = positions.shape[0], int((valid > 0.5).sum())
    calls = {
        "K5": (lambda: maxwarp.maximum_warp_norm_sparse(
                   z2d, static, z_mov, positions, valid, d_mid),
               lambda: maxwarp.maximum_warp_norm_sparse_plain(
                   z2d, static, z_mov, positions, valid, d_mid)),
        "K6": (lambda: maxwarp.maximum_warp_norm_splat(z4, fl_mid),
               lambda: maxwarp.maximum_warp_norm_splat_plain(z4, fl_mid))}
    px, py = positions[:, 0].float(), positions[:, 1].float()
    taps_of = {
        "K5": (px + d_mid[:, 0], py + d_mid[:, 1], z_mov, valid > 0.5),
        "K6": ((torch.arange(W, device=dev)[None, :] + fl_mid[0, ..., 0]).reshape(-1),
               (torch.arange(H, device=dev)[:, None] + fl_mid[0, ..., 1]).reshape(-1),
               z2d.reshape(-1), torch.ones(H * W, dtype=torch.bool, device=dev))}
    # K5: z and the static mask in, the moving rows (z_mov, positions,
    # valid, disp) in, zmax_dense and zmax_mov out; per valid row ~16 ops
    # for the corners and weights and 4 maxes scattering, 4 gathering; per
    # cell 3 adds and 2 maxes for the stencil, 4 maxes for zmax_dense.
    # K6: z and the flow in, the output out; per pixel ~16 ops for the
    # corners and weights, 4 maxes scattering and 4 gathering
    bounds = {"K5": bound(H * W * 4 * 2 + P * (4 + 8 + 4 + 8) + H * W * 4 + P * 4,
                          n_valid * 20 + P * 20 + H * W * 9),
              "K6": bound(H * W * (4 + 8 + 4), H * W * 24)}
    res = {}
    for name, (kernel, plain) in calls.items():
        r = kernel_times(kernel, reps=50)
        r["plain_ms"] = cuda_time(plain, reps=10)
        ox, oy, zv, keep = taps_of[name]
        taps = corners(ox, oy, H, W)
        lin_all = torch.cat([lin for lin, _, _ in taps])
        val_all = torch.cat([torch.where(inside & keep, zv * w, float("-inf"))
                             for _, w, inside in taps])
        mx = torch.full((H * W,), -1000.0, device=dev)
        r["lib"] = kernel_times(lambda: mx.scatter_reduce_(0, lin_all, val_all,
                                                           reduce="amax"), reps=50)
        r["bound"] = bounds[name]
        res[name] = r
    for name, (kernel, _) in calls.items():
        res[name]["per_call"], res[name]["names"] = kernels_per_call(kernel)
    return res


def print_maxwarp(label, res):
    for name, r in res.items():
        print(f"{label} {name}: {fmt_times(r)}; plain {r['plain_ms']:.3f} ms; "
              f"scatter_reduce_ {fmt_times(r['lib'])}; bound {r['bound'][0]:.5f} ms "
              f"by {r['bound'][1]}; {r['per_call']:g} CUDA kernels per call "
              f"({', '.join(r['names'])})")


def use_tree(tree: str):
    """Import ``slrsfs_tpu_torch`` from ``tree``, another unpacked tree of
    this repository (its kernels build in TREE/build), and return the card
    with TF32 off."""
    import torch

    sys.path.insert(0, os.path.abspath(tree))
    import slrsfs_tpu_torch

    check(os.path.dirname(os.path.dirname(os.path.abspath(slrsfs_tpu_torch.__file__)))
          == os.path.abspath(tree), f"slrsfs_tpu_torch not imported from {tree}")
    check(torch.cuda.is_available(), "no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def maxwarp_in(tree: str) -> int:
    """``python3 chip_smoke.py --maxwarp-in TREE``: ``maxwarp_phase`` and
    the SLR f32 v2 render (median of 5) on the package of another unpacked
    tree of this repository (its kernels built in TREE/build), to compare
    commits on one card (slrsfs_tpu_torch/tools/compare.sh)."""
    dev = use_tree(tree)
    print_maxwarp("maxwarp", maxwarp_phase(dev, *maxwarp_inputs(dev)))
    from slrsfs_tpu_torch.cli.render import SceneRenderer

    # the end-to-end metric K5 moves: the SLR f32 v2 render, as in phase 7
    img_u8, flow_np = synthetic_scene(SEED)
    img = (img_u8.astype(np.float32) / 255.0 - 0.5) / 0.5
    r = SceneRenderer(W=W, n_frames=N_FRAMES, dtype="float32", seed=SEED,
                      sparsify_eps=0.0,
                      opt_overrides=dict(SLR_OPTS, use_softmax_splatter_v2=True))
    med, ts = render_median(r, img, flow_np, reps=5)
    print(f"maxwarp SLR float32 v2 render: median {med * 1e3:.1f} ms = "
          f"{N_FRAMES / med:.2f} frames/s (runs {[round(x * 1e3, 1) for x in ts]} ms)")
    return 0


def k2_in(tree: str) -> int:
    """``python3 chip_smoke.py --k2-in TREE``: on the package of another
    unpacked tree of this repository, K2 and K2-SLR at one frame of the
    render (``k2_times``: f32 and bf16 accumulation, each with its
    per-launch split, and the f32 mode's window misses), K8 (``k8_phase``)
    and the float32, bfloat16 and bfloat16-fast renders of both models
    (median of 5), to compare commits
    on one card (slrsfs_tpu_torch/tools/compare.sh)."""
    import torch

    dev = use_tree(tree)
    from slrsfs_tpu_torch.cli.render import SceneRenderer
    from slrsfs_tpu_torch.engine.rollout import prepare_scene_sparse
    from slrsfs_tpu_torch.ops.euler import euler_compact_dual_plain

    img_u8, flow_np = synthetic_scene(SEED)
    pos_np, val_np = prepare_scene_sparse(flow_np)
    flow = torch.from_numpy(flow_np).to(dev)
    positions = torch.from_numpy(pos_np).to(dev)
    valid = torch.from_numpy(val_np).to(dev)
    disp_f, disp_b = euler_compact_dual_plain(flow, positions, N_FRAMES - 1, N_FRAMES)
    da, db = disp_f[T_MID].contiguous(), disp_b[T_MID].contiguous()
    k2 = k2_inputs(dev, np.random.default_rng(SEED + 1), flow, positions, valid)
    for name, st in k2.items():
        k2_times(dev, name, st, positions, valid, da, db)
    k8_phase(dev, k2["K2"]["u_mov"], positions, da, db)
    del k2
    # the end-to-end metrics K2 moves: the float32 renders (f32 mode), the
    # bfloat16-fast renders (bf16 mode) beside the bfloat16 renders they
    # exist to speed up
    img = (img_u8.astype(np.float32) / 255.0 - 0.5) / 0.5
    for label, overrides in (("baseline", None), ("SLR", SLR_OPTS)):
        for dtype in ("float32", "bfloat16", "bfloat16-fast"):
            r = SceneRenderer(W=W, n_frames=N_FRAMES, dtype=dtype, seed=SEED,
                              sparsify_eps=0.0, opt_overrides=overrides)
            med, ts = render_median(r, img, flow_np, reps=5)
            print(f"k2 {label} {dtype} render: median {med * 1e3:.1f} ms = "
                  f"{N_FRAMES / med:.2f} frames/s (runs "
                  f"{[round(x * 1e3, 1) for x in ts]} ms)")
            del r
    return 0


def k3_in(tree: str) -> int:
    """``python3 chip_smoke.py --k3-in TREE``: on the package of another
    unpacked tree of this repository, the stage-1 training step's kernels
    and the metric they move, to compare commits on one card
    (slrsfs_tpu_torch/tools/compare.sh):

    * K3's forward at the dense render's shape (1, 256, 256, 65) and at the
      training shape (16, 256, 256, 65), each held against its plain
      version and timed (``k3_fwd_times``: as called, on the card alone,
      the host's cost, the per-launch split, ``index_add_``, the bound and
      the window misses);
    * K3's backward on phase 9's two flows, held and timed likewise
      (``k3_bwd_times``);
    * K7 dense and compact on phase 8's timing inputs (``k7_times``);
    * the dense baseline float32 render of the scene (median of 5) and the
      stage-1 training step (median of 3)."""
    import torch

    dev = use_tree(tree)
    from slrsfs_tpu_torch.cli.render import SceneRenderer
    from slrsfs_tpu_torch.engine import rollout

    img_u8, flow_np = synthetic_scene(SEED)
    flow = torch.from_numpy(flow_np).to(dev)
    inp, g, flows = k3_bwd_inputs(dev, flow_np, plain=True)
    shapes = {"dense render": k3_dense_inputs(dev, flow),
              "training": (inp, flows["scene flow (K7)"])}
    for name, (x, disp) in shapes.items():
        label = f"k3 forward, {name} {tuple(x.shape)}"
        err, n_cancel, _ = k3_check(label, x, disp)
        print(f"{label}: max abs {err:.3g} vs plain (atol/rtol 1e-5, empty cells "
              f"match; {n_cancel} elements of reached cells exactly 0 on one side)")
        k3_fwd_times(dev, label, x, disp, reps=50 if x.shape[0] == 1 else 20,
                     plain_reps=10 if x.shape[0] == 1 else 3)
    del shapes
    for name, f in flows.items():
        label = f"k3 backward, training {tuple(inp.shape)} {name}"
        eb = k3_bwd_check(label, inp, f, g)
        print(f"{label}: max abs grad_inp {eb[0]:.3g}, grad_flow {eb[1]:.3g} vs plain "
              f"(limit 1e-5 of each output's max)")
        k3_bwd_times(dev, label, inp, f, g, plain_reps=0)
    del inp, g, flows
    k7_times(dev, "k7", *k7_timing_inputs(dev, flow_np), plain_reps=0)
    # the end-to-end metrics: the dense render (K3's forward) and the
    # training step (K3 both ways, K7)
    img = (img_u8.astype(np.float32) / 255.0 - 0.5) / 0.5
    img_t = torch.from_numpy(img[None]).to(dev)
    r = SceneRenderer(W=W, n_frames=N_FRAMES, dtype="float32", seed=SEED,
                      sparsify_eps=0.0)
    ts = []
    for i in range(6):
        t0 = time.perf_counter()
        rollout.baseline_rollout(r.model, img_t, flow, N_FRAMES)
        torch.cuda.synchronize()
        if i:  # the first is the warm-up
            ts.append(time.perf_counter() - t0)
    med = sorted(ts)[len(ts) // 2]
    print(f"k3 dense baseline float32 render: median {med * 1e3:.1f} ms = "
          f"{N_FRAMES / med:.2f} frames/s (runs {[round(x * 1e3, 1) for x in ts]} ms)")
    del r
    torch.cuda.empty_cache()
    step, runs, stages = train_step_median(dev)
    print(f"k3 training step (B={TRAIN_B}, {W}^2, T={TRAIN_T}, dense K7): median "
          f"{step:.1f} ms (runs {[round(x, 1) for x in runs]} ms); stages "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in stages.items()))
    return 0


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


def k7_timing_inputs(dev, scene_flow: np.ndarray):
    """K7 at the training shape: the scene's motion for each of the B
    samples with a moving pixel at (0, 0), its moving sets
    (``attach_moving_sets``, every moving pixel a row, padded rows at
    (0, 0)) and the training batch's counts. Returns (motion, positions,
    valid, t_f, t_p) on ``dev``."""
    import torch

    from slrsfs_tpu_torch.cli.train import attach_moving_sets

    scene = np.repeat(scene_flow[None], TRAIN_B, axis=0).copy()
    scene[:, 0, 0] = [0.5, 0.5]
    sets = attach_moving_sets({"motions": scene}, max_frac=1.0)
    idx = make_train_batch(np.random.default_rng(SEED), TRAIN_B, W)["index"]
    tf_b, tp_b = (torch.from_numpy(a).to(dev) for a in phased_counts(idx, TRAIN_T))
    return (torch.from_numpy(scene).to(dev), torch.from_numpy(sets["mov_pos"]).to(dev),
            torch.from_numpy(sets["mov_valid"]).to(dev), tf_b, tp_b)


def k7_gathers(m, tf_b, tp_b, T: int, pos=None, val=None) -> int:
    """The gathers K7's loops run on these inputs (csrc/euler_phased.cu):
    for each trajectory (the grid's pixels, or the rows of ``pos`` whose
    ``val`` is not 0) whose source has motion and each phase that latches,
    its steps up to and including the first that leaves the frame."""
    import torch

    B, H_, W_, _ = m.shape
    total = torch.zeros((), dtype=torch.int64, device=m.device)
    ys, xs = torch.meshgrid(torch.arange(H_, device=m.device),
                            torch.arange(W_, device=m.device), indexing="ij")
    grid = torch.stack([xs, ys], -1).reshape(-1, 2).to(m.dtype)
    for b in range(B):
        mb = m[b].reshape(-1, 2)
        src = grid if pos is None else pos[b][val[b] != 0].to(m.dtype)
        tf, tp = int(tf_b[b]), int(tp_b[b])
        for sign, steps, latches in ((1.0, tf, 1 <= tf <= T),
                                     (-1.0, tf + tp - max(tf, 0), tp > 0 and 1 <= tf + tp <= T)):
            if not latches:
                continue
            d = src.clone()
            at = src.long()
            moving = (mb[at[:, 1] * W_ + at[:, 0]] != 0).any(1)
            for _ in range(steps):
                total += moving.sum()
                ix = torch.round(d[:, 0]).long().clamp(0, W_ - 1)
                iy = torch.round(d[:, 1]).long().clamp(0, H_ - 1)
                g = mb[iy * W_ + ix] * sign
                nd = d + g
                inside = ~((nd[:, 0] > W_ - 1) | (nd[:, 0] < 0) | (nd[:, 1] > H_ - 1)
                           | (nd[:, 1] < 0))
                d = torch.where(moving[:, None], nd, d)
                moving = moving & inside
    return int(total)


def k7_times(dev, label, m, pos, val, tf_b, tp_b, plain_reps: int = 3) -> dict:
    """K7 dense and compact on ``k7_timing_inputs``: as called, on the card
    alone and the host's cost per call, each call's work on the card split
    by ``launch_split`` (the compact grids' zeroing and the kernel), the
    plain version (``plain_reps`` > 0) and the bound; printed after
    ``label``."""
    from slrsfs_tpu_torch.ops.euler import (
        euler_integrate_phased,
        euler_integrate_phased_compact,
        euler_integrate_phased_plain,
    )

    B, H_, W_, _ = m.shape
    T = TRAIN_T
    dense = lambda: euler_integrate_phased(m, tf_b, tp_b, T)  # noqa: E731
    compact = lambda: euler_integrate_phased_compact(m, pos, val, tf_b, tp_b, T)  # noqa: E731
    t = kernel_times(dense, reps=20)
    split = launch_split(dense)
    t_c = kernel_times(compact, reps=20)
    split_c = launch_split(compact)
    plain_ms = (cuda_time(lambda: euler_integrate_phased_plain(m, tf_b, tp_b, T),
                          reps=plain_reps, warmup=1) if plain_reps else None)
    # per trajectory and step ~20 lane-instructions (round x2, clamp x4,
    # index, gather, sign, add x2, 4 compares, pin, subtract x2, 2
    # latches), at the lane-instruction rate, for the steps these inputs
    # need (k7_gathers); bytes: motion and counts in, both displacement
    # fields out
    steps = k7_gathers(m, tf_b, tp_b, T)
    bnd = bound(B * H_ * W_ * 8 + B * 8 + 2 * B * H_ * W_ * 8, steps * 20, peak=LANE_OPS)
    steps_c = k7_gathers(m, tf_b, tp_b, T, pos, val)
    P = pos.shape[1]
    plain = "" if plain_ms is None else f"; plain {plain_ms:.2f} ms"
    print(f"{label} K7 dense: {fmt_times(t)}{plain}; bound {bnd[0]:.4f} ms by "
          f"{bnd[1]} ({steps} gathers of {B * H_ * W_ * T} at most); per call on "
          f"the card (torch.profiler): {fmt_split(split)}")
    print(f"{label} K7 compact P={P}: {fmt_times(t_c)} ({steps_c} gathers); per call "
          f"on the card (torch.profiler): {fmt_split(split_c)}")
    return {"t": t, "ms": t["ms"], "plain_ms": plain_ms, "bound": bnd, "split": split,
            "t_compact": t_c, "ms_compact": t_c["ms"], "split_compact": split_c}


def k7_phase(dev, scene_flow: np.ndarray):
    """K7 against its plain versions, bit for bit, dense and compact, at
    the training shape: the scene's motion (static top half, a moving pixel
    at (0, 0)) and random motion that leaves the grid, with t_p = 0,
    t_f = 0, t_f + t_p = T and random counts; then timed on the scene's
    motion with the training batch's counts (``k7_times``)."""
    import torch

    from slrsfs_tpu_torch import kernels
    from slrsfs_tpu_torch.ops.euler import (
        euler_integrate_phased,
        euler_integrate_phased_compact,
        euler_integrate_phased_compact_plain,
        euler_integrate_phased_plain,
    )

    B, T = TRAIN_B, TRAIN_T
    rng = np.random.default_rng(SEED + 7)
    m, pos, val, tf_b, tp_b = k7_timing_inputs(dev, scene_flow)
    t_f = rng.integers(0, T + 1, size=B).astype(np.int32)
    t_p = (rng.integers(0, T + 1, size=B) % (T - t_f + 1)).astype(np.int32)
    t_f[:3], t_p[:3] = [T, 0, 30], [0, T, 30]  # t_p = 0, t_f = 0, sum = T
    tf_d, tp_d = torch.from_numpy(t_f).to(dev), torch.from_numpy(t_p).to(dev)
    err = 0.0
    for label, m_l in (("scene", m),
                       ("random", torch.from_numpy(rng.standard_normal(tuple(m.shape))
                                                   .astype(np.float32) * 2.0).to(dev))):
        got = euler_integrate_phased(m_l, tf_d, tp_d, T)
        want = euler_integrate_phased_plain(m_l, tf_d, tp_d, T)
        torch.cuda.synchronize()
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"K7 dense {label}: kernel differs from plain")
        err = max(err, *((g - w).abs().max().item() for g, w in zip(got, want)))
        n_oob = int((want[1][..., 0] == max(H, W) + 1).sum())
        print(f"phase 8 K7 dense {label}: B={B} {H}x{W} T={T} bit-exact; "
              f"{n_oob} backward trajectories left the grid")
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
    res = k7_times(dev, "phase 8", m, pos, val, tf_b, tp_b)
    kernels.reset_counts()
    res["err"] = err
    return res


def k3_bwd_inputs(dev, scene_flow: np.ndarray, plain: bool = False):
    """K3 at the training shape (B = 16, 256², C = 65): random rows inp and
    cotangent g, and two flows: a random one (3 pixels a step) and the
    scene's flow integrated by K7 with the training batch's counts,
    sentinels included (by K7's plain version when ``plain``: the same
    values). Returns (inp, g, {label: flow})."""
    import torch

    from slrsfs_tpu_torch.ops import euler as E

    B, C = TRAIN_B, TRAIN_C
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    inp = torch.randn((B, H, W, C), generator=gen, device=dev)
    g = torch.randn((B, H, W, C), generator=gen, device=dev)
    idx = make_train_batch(np.random.default_rng(SEED), B, W)["index"]
    tf_b, tp_b = (torch.from_numpy(a).to(dev) for a in phased_counts(idx, TRAIN_T))
    m = torch.from_numpy(np.repeat(scene_flow[None], B, axis=0)).to(dev)
    phased = E.euler_integrate_phased_plain if plain else E.euler_integrate_phased
    return inp, g, {"random flow": torch.randn((B, H, W, 2), generator=gen,
                                               device=dev) * 3.0,
                    "scene flow (K7)": phased(m, tf_b, tp_b, TRAIN_T)[1]}


def k3_bwd_check(label, inp, flow, g) -> list:
    """K3's backward against its plain version, each output within 1e-5 of
    its largest magnitude: [max abs grad_inp, max abs grad_flow]."""
    import torch

    from slrsfs_tpu_torch.ops.splat import softsplat_sum_bwd_kernel, softsplat_sum_grad_plain

    gi, gf = softsplat_sum_bwd_kernel(inp, flow, g)
    wi, wf = softsplat_sum_grad_plain(inp, flow, g)
    torch.cuda.synchronize()
    errs = []
    for name, a, b in (("grad_inp", gi, wi), ("grad_flow", gf, wf)):
        scale = b.abs().max().item()
        d = (a - b).abs().max().item()
        check(d <= 1e-5 * scale, f"{label} {name}: max abs {d} vs 1e-5 x {scale}")
        errs.append(d)
    return errs


def k3_bwd_times(dev, label, inp, flow, g, reps: int = 20, plain_reps: int = 3) -> dict:
    """K3's backward on ``k3_bwd_inputs``: as called, on the card alone and
    the host's cost per call, the card's work per call split by
    ``launch_split``, the plain version (``plain_reps`` > 0), the bound and
    the window misses; printed after ``label``."""
    from slrsfs_tpu_torch.ops.splat import softsplat_sum_bwd_kernel, softsplat_sum_grad_plain

    B, H_, W_, C = inp.shape
    fn = lambda: softsplat_sum_bwd_kernel(inp, flow, g)  # noqa: E731
    t = kernel_times(fn, reps=reps)
    split = launch_split(fn)
    plain_ms = (cuda_time(lambda: softsplat_sum_grad_plain(inp, flow, g),
                          reps=plain_reps, warmup=1) if plain_reps else None)
    n = B * H_ * W_
    # inp, flow and g in, grad_inp and grad_flow out; per channel and
    # corner 2 multiply-adds (g·w, inp·g)
    bnd = bound(n * C * 4 * 3 + n * 8 * 2, n * (16 * C + 40))
    misses = window_misses("dense bwd", flow, C)
    plain = "" if plain_ms is None else f"; plain {plain_ms:.2f} ms"
    print(f"{label}: {fmt_times(t)}{plain}; bound {bnd[0]:.4f} ms by {bnd[1]}")
    print(f"{label} per call on the card (torch.profiler): {fmt_split(split)}; {misses}")
    return {"t": t, "ms": t["ms"], "plain_ms": plain_ms, "bound": bnd, "split": split,
            "misses": misses}


def k3_phase(dev, scene_flow: np.ndarray):
    """K3's forward and backward against their plain versions at the
    training shape (B = 16, 256², C = 65): random inputs with a random flow,
    and with the scene's flow integrated by K7 (sentinels included); both
    directions timed on the scene flow, the backward on both flows."""
    inp, g, flows = k3_bwd_inputs(dev, scene_flow)
    B, _, _, C = inp.shape
    res = {"fwd_err": 0.0, "bwd_err": 0.0}
    for label, flow in flows.items():
        e, n_cancel, n_empty = k3_check(f"K3 forward {label}", inp, flow)
        eb = k3_bwd_check(f"K3 backward {label}", inp, flow, g)
        res["fwd_err"] = max(res["fwd_err"], e)
        res["bwd_err"] = max(res["bwd_err"], *eb)
        print(f"phase 9 K3 {label}: forward max abs {e:.3g} (atol/rtol 1e-5), "
              f"empty cells match ({n_empty}; "
              f"{n_cancel} elements of reached cells exactly 0 on one side); "
              f"backward max abs grad_inp {eb[0]:.3g}, grad_flow {eb[1]:.3g} "
              f"(limit 1e-5 of each output's max)")
    flow = flows["scene flow (K7)"]
    fwd = k3_fwd_times(dev, f"phase 9 K3 forward ({B}, {H}, {W}, {C})", inp, flow,
                       reps=20, plain_reps=3)
    res.update(ms_fwd=fwd["ms"], plain_fwd=fwd["plain_ms"], lib_fwd=fwd["lib_ms"],
               bound_fwd=fwd["bound"])
    bwd = {label: k3_bwd_times(dev, f"phase 9 K3 backward ({B}, {H}, {W}, {C}) {label}",
                               inp, f, g, plain_reps=3 if label == "scene flow (K7)" else 0)
           for label, f in flows.items()}
    scene = bwd["scene flow (K7)"]
    res.update(ms_bwd=scene["ms"], plain_bwd=scene["plain_ms"], bound_bwd=scene["bound"],
               ms_bwd_random=bwd["random flow"]["ms"])
    return res


def train_step_median(dev):
    """The stage-1 G+D step at full width (``Options()`` defaults, batch
    16, 256², T = 60, dense K7), one warm-up and 3 timed steps: (median ms,
    the runs, mean CUDA-event stage ms)."""
    import torch

    from slrsfs_tpu_torch.cli.train import build, to_device_batch
    from slrsfs_tpu_torch.config import Options

    opt = Options(W=W, batch_size=TRAIN_B)
    _, tr = build(opt, train_max_steps=TRAIN_T, device=dev, seed=SEED)
    batch = to_device_batch(make_train_batch(np.random.default_rng(SEED), TRAIN_B, W), dev)
    tr.train_step(batch)  # warm-up
    torch.cuda.synchronize()
    host, stages, _ = _step_times(tr, batch, 3)
    return float(np.median(host)), host, stages


def _step_times(tr, batch, n_steps: int):
    """n timed G+D steps: (host ms per step list, mean CUDA-event stage ms,
    logs of the last step)."""
    import torch

    stages = {}
    host = []
    logs = None
    with no_gc():
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
    from slrsfs_tpu_torch.ops.splat import softsplat_sum_at_quad_dual_plain

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
    k2 = k2_inputs(dev, rng, flow, positions, valid)
    for name, st in k2.items():
        C1, n_norm = st["C1"], st["n_norm"]
        wrapper, plain = st["wrapper"], st["plain"]

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
    for name, st in k2.items():
        k2_times(dev, name, st, positions, valid, disp_f[T_MID], disp_b[T_MID])
    k8 = k8_phase(dev, k2["K2"]["u_mov"], positions, disp_f[T_MID], disp_b[T_MID])

    # ---- phase 4: K5 and K6 against the plain versions, bit for bit ---
    z2d = torch.from_numpy((rng.standard_normal((H, W)) * 3.0)
                           .astype(np.float32)).to(dev)
    z_mov = z2d[py, px].contiguous()
    k5_err = k6_err = 0.0
    padded = torch.zeros_like(valid)
    for label, d, v in [(f"t={t}", disp_f[t], valid) for t in T_CHECK] + [
            ("sentinel/integer/border", special, valid),
            (f"t={T_MID} all rows padded", disp_f[T_MID], padded)]:
        kd, km = maxwarp.maximum_warp_norm_sparse(z2d, static, z_mov, positions,
                                                  v, d)
        pd, pm = maxwarp.maximum_warp_norm_sparse_plain(z2d, static, z_mov,
                                                        positions, v, d)
        torch.cuda.synchronize()
        check(torch.equal(kd, pd) and torch.equal(km, pm),
              f"K5 {label}: kernel differs from plain")
        k5_err = max(k5_err, (kd - pd).abs().max().item(),
                     (km - pm).abs().max().item())
        print(f"phase 4 K5 {label}: bit-exact (P={P}, {int(v.sum())} valid, "
              f"{int((pm > z_mov).sum())} moving rows raised by a neighbour)")
    dense_f, _ = euler_integrate_all_dual_plain(flow, N_FRAMES - 1, 1)
    special_dense = dense_f[T_MID].reshape(-1, 2).clone()
    special_dense[0::3] = float(max(H, W) + 1)
    special_dense[1::3] = torch.tensor([3.0, -2.0], device=dev)
    special_dense[2::3] = torch.tensor([-0.75, -127.5], device=dev)
    z4 = z2d[None, ..., None].contiguous()
    z4_b2 = torch.cat([z4, -0.5 * z4.flip(1)])
    for label, z_, fl in [(f"t={t}", z4, dense_f[t][None]) for t in T_CHECK] + [
            ("sentinel/integer/border", z4, special_dense.reshape(1, H, W, 2)),
            (f"B=2 t=1, t={T_MID}", z4_b2, dense_f[[1, T_MID]])]:
        fl = fl.contiguous()
        got = maxwarp.maximum_warp_norm_splat(z_, fl)
        want = maxwarp.maximum_warp_norm_splat_plain(z_, fl)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"K6 {label}: kernel differs from plain")
        k6_err = max(k6_err, (got - want).abs().max().item())
        print(f"phase 4 K6 {label}: bit-exact ({int((want > z_).sum())} pixels "
              f"raised by a neighbour)")
    d_mid = disp_f[T_MID]
    fl_mid = dense_f[T_MID][None].contiguous()
    mw = maxwarp_phase(dev, z2d, static, z_mov, positions, valid, d_mid, z4, fl_mid)
    for name, r in mw.items():
        check(r["per_call"] == 1, f"{name}: {r['per_call']} CUDA kernels per call "
              f"on the card ({r['names']}), not one")
        print(f"phase 4 {name}: {r['per_call']:g} CUDA kernel per call on the card "
              f"(torch.profiler: {', '.join(r['names'])})")

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
    rows, fields, (out_dir, v2_frames) = v2_stages(
        lambda: render_capture(r32v2, img_path, flow_path,
                               os.path.join(scene_dir, "baseline v2"),
                               name="synthetic", rawsize=True),
        r32v2.model, positions, valid)
    v2_first = (rows, fields, v2_frames)  # for v2_diagnostic
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
    v2_path_err = (v2_frames - v2_plain).abs().max().item()
    v2_dense_err = (v2_frames - v2_dense).abs().max().item()
    img_t = torch.from_numpy(img[None]).to(dev)
    v2_sparse = lambda plain=False: r32v2.frames(img, flow_np, plain=plain)  # noqa: E731
    v2_diagnostic("baseline kernel vs plain path", v2_path_err, r32v2.model,
                  positions, valid, v2_sparse, lambda: v2_sparse(True), v2_first)
    v2_diagnostic("baseline sparse vs dense", v2_dense_err, r32v2.model,
                  positions, valid, v2_sparse,
                  lambda: rollout.baseline_rollout(r32v2.model, img_t, flow, N_FRAMES),
                  v2_first)
    del v2_first, rows, fields
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
    k3_dense = k3_dense_render_times(dev, flow)

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
        run = lambda: render_capture(  # noqa: E731
            r, img_path, flow_path, os.path.join(scene_dir, "slr " + label),
            name="synthetic", rawsize=True,
            alpha_region_path=region_path if v2 else None)
        if v2:
            rows, fields, (out_dir, outs) = v2_stages(run, r.model, positions, valid)
            slr_v2_first = (rows, fields, outs)  # for v2_diagnostic
            del rows, fields
        else:
            out_dir, outs = run()
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
                                                    alpha_region=rg), slr_v2_first)
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
                                                    alpha_region=region_t),
                  slr_v2_first)
    del slr_v2_first
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
    t_k1 = kernel_times(lambda: euler_compact_dual(flow, positions, N_FRAMES - 1,
                                                   N_FRAMES), reps=20)
    ms_k1 = t_k1["ms"]
    ms_k1_plain = cuda_time(lambda: euler_compact_dual_plain(
        flow, positions, N_FRAMES - 1, N_FRAMES), reps=3, warmup=1)
    steps = (N_FRAMES - 1) + N_FRAMES
    k1_bound = bound(H * W * 8 + P * 8 + (steps + 2) * P * 8,
                     steps * P * 12)  # round x2, add x2, 4 compares, sub x2, 2 sel
    print(f"phase 7 K1: {fmt_times(t_k1)}; plain {ms_k1_plain:.3f} ms; bound "
          f"{k1_bound[0]:.4f} ms by {k1_bound[1]}")
    print_maxwarp("phase 7", mw)

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
    ms_s[f"K5 x{N_FRAMES}"] = mw["K5"]["ms"] * N_FRAMES
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
        row("maximum_warp_norm_sparse", "slrsfs_tpu_torch/csrc/maxwarp.cu",
            "slrsfs_tpu/ops/splat.py:492",
            slr_launches["float32 v2"]["maximum_warp_norm_sparse"], k5_err,
            mw["K5"]["ms"], mw["K5"]["plain_ms"], mw["K5"]["bound"],
            mw["K5"]["lib"]["ms"]),
        row("maximum_warp_norm_splat", "slrsfs_tpu_torch/csrc/maxwarp.cu",
            "slrsfs_tpu/ops/splat.py:240",
            dense_launches["maximum_warp_norm_splat"], k6_err, mw["K6"]["ms"],
            mw["K6"]["plain_ms"], mw["K6"]["bound"], mw["K6"]["lib"]["ms"]),
        row("splat_dense_fwd", "slrsfs_tpu_torch/csrc/splat_dense.cu",
            "slrsfs_tpu/ops/splat.py:139", train["launches"]["splat_dense_fwd"],
            k3["fwd_err"], k3["ms_fwd"], k3["plain_fwd"], k3["bound_fwd"],
            k3["lib_fwd"]),
        row("splat_dense_fwd (dense render, B=1)", "slrsfs_tpu_torch/csrc/splat_dense.cu",
            "slrsfs_tpu/ops/splat.py:139",
            dense["scene"]["launches"]["splat_dense_fwd"], k3_dense["err"],
            k3_dense["ms"], k3_dense["plain_ms"], k3_dense["bound"],
            k3_dense["lib_ms"]),
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
    modes = {"--maxwarp-in": maxwarp_in, "--k2-in": k2_in, "--k3-in": k3_in}
    if len(sys.argv) == 3 and sys.argv[1] in modes:
        sys.exit(modes[sys.argv[1]](sys.argv[2]))
    check(len(sys.argv) == 1,
          f"usage: {sys.argv[0]} [--maxwarp-in TREE | --k2-in TREE | --k3-in TREE]")
    sys.exit(main())
