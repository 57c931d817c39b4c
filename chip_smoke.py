#!/usr/bin/env python3
"""Smoke test of the PyTorch port (slrsfs_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --maxwarp-in TREE   # K5 and K6 of another tree
    python3 chip_smoke.py --k2-in TREE        # K2 and K8 of another tree
    python3 chip_smoke.py --k3-in TREE        # K3 and K7 of another tree
    python3 chip_smoke.py --k1-in TREE        # K1 and K4 of another tree
    python3 chip_smoke.py --k7bwd-in TREE     # K7's backward of another tree
    python3 chip_smoke.py --maxsplat-in TREE  # K6a and K6b of another tree

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

K1 is held bit for bit on the scene's flow, a quarter-pixel flow (rounding
ties) and a leaving flow (half the trajectories leave the frame within 4
steps); its device time and K4's dense dual form's are printed beside two
bounds, the bytes (every entry stored once) and the latency of 60
dependent gathers a trajectory, which slrsfs_tpu_torch/tools/chase_probe.py
measures in this run, each with its share.

The dense baseline render (K4, the dense integrator, and K3's forward) runs
on the scene, held at 1e-4 against the sparse render, and in the
configuration of __graft_entry__.py:entry() (256², N = 12), held at 1e-4
against its plain path; K3's forward is also held and timed at the dense
render's own shape, one frame end of (1, 256, 256, 65). K4 is checked bit for bit in every form; K8 (the
exported single- and two-ended raw splats) and K2's bf16 mode against their
plain versions in f32 (1e-5); in bf16 accumulation every element against
the f32 sums of the same rows, within the bound no summation order can
break (bf16_cell_bound: gamma_(n+2) at u = 2^-8 times the cell's sum of
|terms|, n its terms, both from the plain f32 splat of |u| and of the
nonzero taps; through the normalisation for K2), the kernel's and the
plain version's distances printed beside it. K9, the
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
counts the CUDA kernels one call of each runs on the card (one). K6's
two halves as entries of their own, K6a (max_splat, a window
max-scatter at one channel) and K6b (inverse_max_gather, a run of
pixels a warp; both
csrc/maxsplat.cu), are held bit for bit at C = 1, 3, 4 and 65 on a ragged
(2, 253, 232) grid with the special rows, a smooth field and a scattered
flow, the pair against K6's one launch, and timed at 256^2 and 768^2
beside their bytes bounds and the launch floor (an empty kernel,
slrsfs_tpu_torch/tools/maxsplat_probe.py), with K6a's window misses
(phase 25, which also holds the plain ResNetDecoder on its five arch
tables at ngf 64, card against CPU within 1e-4 of max). A v2
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
against a plain-path step from one snapshot (kernel_vs_plain_steps: the
convolutions off cuDNN, the bilinear upsampling's backward without atomics, the
kernel step's K3 forwards replayed into the plain step after its inputs
are checked bit-equal, so that the losses and the K3 backwards' incoming
cotangents are bit-equal; a self-check that two plain steps from the
snapshot agree within 1e-5 of the largest gradient; each backward kernel
call held against its plain version on its own inputs; the gradients
within 1e-3 of the largest); and the train CLI for 2 steps
on a synthetic dataset, whose checkpoint SceneRenderer then renders; then
SLR stage 3 through the train CLI for 2 steps from that checkpoint and a
seeded bg checkpoint (the SLR losses logged, the alpha nets kept at their
initial weights), whose SLR checkpoint SceneRenderer renders (K1, K2-SLR).

Then the crop decode (the render's default path, crop_decode 'auto') at
full width: Options() defaults at W = 768, N = 60, a synthetic scene whose
rows 288-479 x columns 192-575 move (P = 73,728), planned as the JAX
package plans it. The baseline in float32, bfloat16 and bfloat16-fast,
crop and no-crop, each timed (median of 3); float32 crop against no-crop
and against the crop render through the plain versions (1e-4), bf16 and
bf16-fast crop against no-crop within twice that dtype's kernel render's
distance from its plain render; the SLR model in float32 and float32 v2,
crop and no-crop once each (1e-4; v2 launches K5 N + 1 times); K1 held bit
for bit and timed on the 768^2 grid at the crop scene's moving set; K2 and
K5 held and timed on the window grid (K5 also on the full grid with every
row invalid). The scene sweep (cli/render_all.py, default flags) over four
768^2 scenes, two of them sharing a window size, with PNG and mp4 saves:
scenes/hour, the count of (P, window) shapes, and each scene's PNGs against
a one-scene render within one u8 level. The render CLI with
--profile-stages on the 768^2 scene: the full and crop stage times, each
> 0, their sums (each profile's fastest pass) within 10 % of the fastest
phase 12 render of the same kind; and one crop render
under engine/profiler.py:profile_trace, whose trace gives the device's
busy share of the render.

Last, motion from hints (phase 15, SceneRenderer(motion_ckpt=...)): a
seeded random full-width SPADE motion regressor (32 filters, 8 downs)
written as a reference-style .pth; the 768^2 scene's flow only seeds the
speed-threshold mask and five k-means/RBF hints, and the regressor's dense
motion moves nearly every pixel (P = 589,824, no crop), rendered through
SceneRenderer.render(..., rawsize=True) in float32 and bfloat16. The hints
on the card against the CPU's (the same centroid pixels, the field 1e-6),
the regressor on the card against the CPU (1e-4 of max |pred|), K1 bit for
bit and K2 (f32 1e-5, bf16 accumulation within its per-cell bound) on the
whole grid, the f32 render kernels vs plain (1e-4) and
warp_flow_rollout kernels vs plain (1e-5); t_hints, t_regressor, the
regressor's peak memory and frames/s with the hints and the regression
included.

Then the CLAW evaluation at 768² (phase 16, eval_phase): cli/render_all.py
with --rawsize renders the sweep's four scenes (768^2 PredImg, 60 frames;
K1 x 4, K2 x 240), each gets a seeded 60-frame GT mp4 (its input plus a few
u8 levels of noise), and cli/eval.py scores them on the card with seeded
random VGG16, AlexNet, LPIPS and I3D weights in the user's layouts, plain
and --fluid: every scene scored, the four Total columns and TotalFVD
finite, the file equal to the returned dict; one frame pair's metrics and
four 60-frame videos' I3D features and Frechet distance card vs CPU; the
eval's wall time, each metric's time a frame (CUDA events), the host's
PNG loads, mp4 decode and GT resizes, I3D and preprocess_video a video,
the eval's peak memory and the render's frames/s.

Then SLR stage 3 at full width (phase 17, slr_training_phase): the CLI's
stage-3 options on Options() widths, batch 16 (halved only if it does not
fit, said so), W = 256, T = 60, f32, a synthetic batch with a rock polygon
over about a quarter of the frame and a mean video; one warm-up and 3
timed G+D steps dense (K7 dense) and with 50 % moving rows (K7 compact),
each with 6 K3 forward, 6 backward and 3 K7 launches and nothing else,
every loss finite; K3 forward (1e-5, the same empty cells) and backward
(1e-5 of each output's max) at (16, 256, 256, 67) on the step's own packed
rows and flows, timed with their bound, index_add_ and window misses; the
fluid alpha mask's elements that differ between a kernel and a plain
forward; K7 on the compact batch, bit for bit and timed; a kernel-path
step against a plain-path step (losses 1e-4, gradients 1e-3); ms/step,
samples/s, CUDA-event stages and the peak memory.

Then the remaining training stages. Phase 18 (embedded_phase): the
unfrozen joint step and the fix-motion step on Options() widths with the
shipped 8-down SPADE regressor (width 32) and 1.0_EndPointError, batch
16, W = 256, T = 60, f32, synthetic hint batches; one warm-up and 3 timed
steps each with 6 K3 forward, 6 backward and 3 K7 launches, and 3 K7
backward launches when unfrozen (0 frozen), nothing else; a kernel-path
step against a plain-path step by sub-network (the regressor's included);
K3 and K7 on the joint step's own inputs checked and timed. Phase 19
(k7_bwd_phase): K7's backward against the plain autograd (1e-5 of the
gradient's max, two launches) on the step's predicted motion, the scene
flow, the leaving flow and a batch with t_f = 0, t_p = 0 and static
pixels; timed on the first three beside its bound and its window counts
(runs, window hits and misses, the cells a block's flush adds), with the
counts of two other windows. Phase 20 (other_stages_phase): the bg stage-2 step and the
motion-GAN step at batch 16, 256². Phase 21 (stage_chains_phase): the train
CLI at 256², batch 2, two steps each (the joint run four: --init-from
restores the fix-motion run's Adam count): motion GAN → fix-motion → joint →
SceneRenderer with the joint checkpoint as --motion-ckpt, and stage 1 → bg
stage 2 → SLR stage 3 from the port's own stage-2 checkpoint.

Then the rest of training (phase 23, rest_of_training_phase): K3's bf16
mode (bf16 rows, f32 flow) on the bf16 stage-1 (C = 65) and SLR stage-3
(C = 67) steps' own rows: the forward within the per-cell bf16 bound of
the f32 sums of the same rows (bf16_cell_bound), every element whose
terms are all 0 exactly 0, the backward's grad_inp bit for bit the plain
version's (the count of elements that differ printed and held at 0) and
grad_flow within 1e-5 of its max, each timed beside its bound, its plain
version and (forward) one bf16 index_add_, split per launch (the
forward's zeroing and scatter) and with its window misses; the two bf16
steps at batch 16 (6 K3 bf16 forward and
backward and 3 K7 launches over 3 steps, every persistent tensor float32,
L1 and Total within 0.12·|f32| + 0.05 of the f32 step from the same
state, both with zero BN noise); one stage-1 step over two micro-batches of 16 in each
accumulation scale (with b1 = 0, Adam's first moment under 'reference'
4x the one under 'mean' within 1e-5 on the same micro-batch gradients); the motion GAN with the
pix2pixHDorigin D (GAN_Feat 0) and a stage-1 step with the style loss and
the free-form mask, each timed; and the CLI at 256², batch 2: SIGUSR1
mid-epoch saves at epoch - 1 and exits, the resume file loads on the card
bit for bit, --resume continues at the next step and writes HALT, a
re-run returns at once, --init-from the finished checkpoint restores the
count and both Adam states bit for bit.

Then Multi-GPU on one card (phase 24, multi_gpu_phase): a 1-rank NCCL
group formed in this process and destroyed after; the frame-sharded
baseline and SLR renders (SceneRenderer(shard_frames=True), float32, N =
60) within 1e-4 of the unsharded renders, their launches, and frames/s of
both in turns; the data-parallel stage-1 step (Trainer(mesh=...), batch
16) against the plain unsharded step from one snapshot through
kernel_vs_plain_steps, its launches over 3 steps (6 K3 forward, 6
backward, 3 K7), its step time beside the unsharded step's and the
gradient all-reduce's time (CUDA events) and bytes. One card holds one
rank: no multi-rank speed is measured.

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
backward on the training shape's random and scene flows, K3's bf16
forward and backward on the bf16 stage-1 and SLR steps' own rows (held
as phase 23 holds them, split, with bounds and window misses), K7 dense
and compact (each with its split), the dense float32 render and the
stage-1 training step; with --k1-in TREE, K1 on the scene, quarter-pixel and
leaving flows and K4's four forms on the scene, leaving and random flows
(each held bit for bit, timed, split and set beside its bytes and latency
bounds) and the baseline float32 render; with --k7bwd-in TREE, K7's
backward on the joint step's predicted motion, the scene flow and the
leaving flow beside its window counts, and the joint step; with
--maxsplat-in TREE, K6a, K6b and the pair beside K6 at (1, 256, 256, 1),
(1, 768, 768, 1), (1, 256, 256, 65) and on a scattered flow at (1, 256,
256, 1), each held bit for bit, timed, K6a split by torch.profiler into
its fill and its scatter, beside the bytes bounds, the launch floor, the
plain versions, scatter_reduce_(amax) and K6a's window misses
(slrsfs_tpu_torch/tools/compare.sh runs any of them on several trees in
turns).
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import re
import signal
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


def synthetic_scene(seed: int, size: int = H, rows=None, cols=None):
    """uint8 (size, size, 3) image and a smooth flow that moves in ``rows``
    x ``cols`` (default: the bottom half of the rows) and is exactly zero
    elsewhere, both from a numpy seed."""
    rng = np.random.default_rng(seed)
    coarse = rng.uniform(0, 255, (size // 16, size // 16, 3))
    img = np.kron(coarse, np.ones((16, 16, 1))) + rng.normal(0, 8, (size, size, 3))
    img_u8 = np.clip(img, 0, 255).astype(np.uint8)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    flow = np.stack([1.5 * np.sin(yy / 17.0) + 0.6 * np.cos(xx / 23.0),
                     0.8 * np.cos(xx / 29.0) + 0.3], axis=-1).astype(np.float32)
    flow += rng.normal(0, 0.05, flow.shape).astype(np.float32)
    keep = np.zeros((size, size), bool)
    keep[slice(size // 2, size) if rows is None else rows,
         slice(0, size) if cols is None else cols] = True
    flow[~keep] = 0.0
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
    ``torch.profiler`` trace of ``reps`` calls after one warm-up. A trace
    that reports no device event at all, or a kernel fewer times than a
    whole number of calls would launch it (CUPTI now and then drops
    events: once K5 showed 3 launches in 4 calls), is taken again, at most
    three times; the last trace is returned as it is, so an empty split
    stays empty and a count that stays fractional reaches the caller's
    checks."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        total = {}
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                n, us = total.get(e.name, (0, 0.0))
                total[e.name] = (n + 1, us + e.time_range.elapsed_us())
        if total and all(n % reps == 0 for n, _ in total.values()):
            break
    return {k: (n / reps, us / reps) for k, (n, us) in total.items()}


def kernels_per_call(fn, reps: int = 4):
    """(CUDA kernels the card ran per call of ``fn``, their names), from
    ``launch_split``; copies and memsets are not counted."""
    split = launch_split(fn, reps)
    names = sorted(k for k in split if not k.startswith(("Memcpy", "Memset")))
    return sum(split[k][0] for k in names), names


def fmt_split(split: dict) -> str:
    if not split:
        return "not measured (the trace held no device event)"
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
    Kinds "dense bf16" (args flow) and "dense bf16 bwd" (args flow and
    C): the same two counts for K3's bf16 mode. Kind "max splat" (args
    flow and C): K6a's window max-scatter, which runs at one channel only.
    A package without the window (an older tree of ``--k2-in``, ``--k3-in``
    or ``--maxsplat-in``) says so."""
    from slrsfs_tpu_torch import kernels
    from slrsfs_tpu_torch.ops import splat as S

    if kind == "max splat":
        lib = kernels.MAX_SPLAT
        lib.load()
        if not hasattr(lib._lib, "max_splat_window_cells"):
            return "window misses: this package's K6a has no window"
        if args[1] != 1:
            return "window misses: none, K6a has no window above one channel"
        tile = (lib.query("max_splat_tile_rows"), lib.query("max_splat_tile_cols"))
        cap = lib.query("max_splat_window_cells")
        n_in, n_miss = S.dense_window_misses(args[0], tile, cap)
        return (f"window misses {n_miss} of {n_in} corners in the grid "
                f"({100.0 * n_miss / max(n_in, 1):.2f} %; {tile[0]}x{tile[1]} tiles, "
                f"windows of {cap} cells)")
    if kind.startswith("dense bf16"):
        kernels.SPLAT_DENSE_BWD_BF16.load()
        if not hasattr(kernels.SPLAT_DENSE_BWD_BF16._lib, "splat_dense_bwd_bf16_window_cells"):
            return "window misses: this package's bf16 mode has no window"
    if kind in ("dense bwd", "dense bf16 bwd"):
        if not hasattr(S, "dense_window_units"):
            return "window misses: this package's backward has no window"
        lib = kernels.SPLAT_DENSE_BWD
        tile = (lib.query("splat_dense_bwd_tile_rows"), lib.query("splat_dense_bwd_tile_cols"))
        cap = lib.query("splat_dense_bwd_bf16_window_cells" if "bf16" in kind
                        else "splat_dense_bwd_window_cells", args[1])
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


# Unit roundoffs (round to nearest): bf16 keeps 8 significand bits, f32 24.
BF16_U = 2.0 ** -8
F32_U = 2.0 ** -24


def rounding_gamma(k, u: float):
    """Higham's gamma_k = k u / (1 - k u), elementwise over a tensor of k:
    |prod (1 + d_i) - 1| <= gamma_k for any k roundings |d_i| <= u."""
    import torch

    ku = k * u
    return torch.where(ku < 1.0, ku / (1.0 - ku), torch.full_like(ku, float("inf")))


def tap_counts(positions, valid, disps, H_: int, W_: int):
    """(H_, W_, 1) float32: the corner taps with a nonzero weight that each
    cell receives from the rows at ``positions`` (those with ``valid`` != 0;
    every row when None) moved by each displacement of ``disps``."""
    import torch

    from slrsfs_tpu_torch.ops.splat import _corner_taps

    n = torch.zeros(H_ * W_, dtype=torch.float32, device=positions.device)
    px, py = positions[:, 0].float(), positions[:, 1].float()
    keep = 1.0 if valid is None else (valid != 0).float()
    for d in disps:
        for lin, w in _corner_taps(px + d[:, 0], py + d[:, 1], H_, W_):
            n.index_add_(0, lin, (w != 0).float() * keep)
    return n.reshape(H_, W_, 1)


def bf16_cell_bound(ref32, abs_terms, n_terms, pairs=None, out_dtype=None):
    """The most any summation order can move a bf16-accumulated splat from
    the f32 sums ``ref32`` of the same rows, per element.

    A cell's sum of n terms t_i (each a bf16 row times one or two weights,
    each product rounded once to bf16, n - 1 additions on any term's path,
    the sum then stored or rounded once more) is sum t_i prod(1 + d_ij) with
    at most n + 2 factors, so it lies within gamma_{n+2}(2^-8) sum |t_i| of
    the exact sum; the f32 reference is within gamma_{n+2}(2^-24) of it.
    This is (n u + u) sum |t_i| to first order in u, with every rounding
    counted. ``abs_terms`` (..., C1) is sum |t_i| per accumulator channel and
    ``n_terms`` (..., 1) the cell's n, both from the plain f32 splat of |u|
    and of the nonzero taps (``tap_counts``). Raw sums (``pairs`` None):
    the bound is gamma sum |t_i| channel for channel. Normalised outputs
    (``pairs``: for each output channel its (feature, normaliser) channels,
    the normaliser's terms positive): with |F^ - F| <= eF, |N^ - N| <= eN
    and denominators clamped at NORM_EPS, |F^/N^ - F/N| <= (eF + |F/N| eN)
    / max(N (1 - gamma), NORM_EPS), plus the division's f32 rounding and the
    output's (``out_dtype``). Subnormal products add at most 2^-133 each."""
    import torch

    from slrsfs_tpu_torch.ops.splat import NORM_EPS

    k = n_terms + 2.0
    g = rounding_gamma(k, BF16_U) + rounding_gamma(k, F32_U)
    tiny = k * 2.0 ** -133
    if pairs is None:
        return g * abs_terms + tiny
    feat = torch.tensor([p[0] for p in pairs], device=abs_terms.device)
    norm = torch.tensor([p[1] for p in pairs], device=abs_terms.device)
    r = ref32.abs()
    big_n = abs_terms[..., norm]
    e = ((g * abs_terms[..., feat] + tiny + r * (g * big_n + tiny))
         / torch.clamp(big_n * (1.0 - g), min=NORM_EPS))
    out_u = BF16_U if out_dtype == torch.bfloat16 else F32_U
    return e + (out_u + 2.0 * F32_U) * (r + e)


def bf16_cell_check(label, got, plain, ref32, bnd) -> dict:
    """Fail unless the kernel's bf16-accumulated ``got`` lies within the
    per-element bound ``bnd`` (``bf16_cell_bound``) of the f32 sums
    ``ref32``, exactly where the bound is 0. Returns the largest share of
    the bound that the kernel and the plain version use, and (for
    information) each one's largest distance from the f32 sums."""
    d_k = (got.float() - ref32).abs()
    d_p = (plain.float() - ref32).abs()
    pos = bnd > 0
    check(bool((d_k <= bnd).all()), f"{label}: kernel beyond the per-cell bf16 "
          f"bound at {int((d_k > bnd).sum())} elements (largest "
          f"{(d_k / bnd.clamp(min=1e-38)).max().item():.3g} of it)")
    return {"share": (d_k[pos] / bnd[pos]).max().item() if pos.any() else 0.0,
            "share_plain": (d_p[pos] / bnd[pos]).max().item() if pos.any() else 0.0,
            "d_k": d_k.max().item(), "d_p": d_p.max().item()}


def fmt_bf16(c: dict) -> str:
    return (f"per-cell bound (gamma_(n+2) at 2^-8): kernel uses {c['share']:.3g} of "
            f"it, plain {c['share_plain']:.3g}; from the f32 sums kernel {c['d_k']:.3g}, "
            f"plain {c['d_p']:.3g} (ratio {c['d_k'] / max(c['d_p'], 1e-30):.2f})")


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


def call_median(fn, reps: int = 3):
    """(median seconds, each run's) of ``fn()`` synchronised with the card,
    over ``reps`` runs after one warm-up, GC held off."""
    import torch

    fn()
    torch.cuda.synchronize()
    ts = []
    with no_gc():
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2], ts


def render_median(r, img, flow, reps: int = 3):
    """Median seconds of ``r.frames`` over ``reps`` runs after one warm-up."""
    return call_median(lambda: r.frames(img, flow), reps)


def render_capture(r, *args, **kw):
    """``r.render(*args, **kw)`` and the outputs that render computed and
    wrote, once its background saves have finished: (out_dir, frames or
    dict of outputs)."""
    got = {}
    frames = r.frames

    def spy(*a, **k):
        got["out"] = frames(*a, **k)
        return got["out"]

    r.frames = spy
    try:
        out_dir = r.render(*args, **kw)
        r.finish()
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


def k4_phase(dev, flow, lat: dict):
    """K4 against its plain versions, bit for bit, at 256²: the dense dual
    form with (N - 1, N) steps on the scene's flow and on a random flow that
    sends many trajectories out of the frame; the dense and compact
    single-direction forms with visibility, the last-step form and
    n_steps = 0 on both. Then the dense dual form timed on the scene beside
    its bytes bound and its latency bound ``lat`` (``euler_latency``)."""
    import torch

    from slrsfs_tpu_torch.engine.rollout import prepare_scene_sparse
    from slrsfs_tpu_torch.ops import euler as E

    rng = np.random.default_rng(SEED + 4)
    rand = torch.from_numpy((rng.standard_normal((H, W, 2)) * 2.0)
                            .astype(np.float32)).to(dev)
    pos = torch.from_numpy(prepare_scene_sparse(flow.cpu().numpy())[0]).to(dev)
    n_f, n_b = N_FRAMES - 1, N_FRAMES
    err = 0.0
    for label, m in (("scene", flow), ("random", rand), ("leaving", leaving_flow(dev))):
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
    plain_ms = cuda_time(lambda: E.euler_integrate_all_dual_plain(flow, n_f, n_b),
                         reps=3, warmup=1)
    (case,) = [c for c in euler_cases(flow, pos) if c["name"] == "K4 dense dual"]
    r = euler_times([case], lat, "phase 2")[case["label"]]
    return {"err": err, "ms": r["ms"], "plain_ms": plain_ms, "bound": r["bound"]}


def leaving_flow(dev):
    """A random 256² flow of ~32 px a step in random directions, drawn from
    a seed: half the trajectories leave the frame within 4 steps, and are
    then pinned to their source."""
    import torch

    rng = np.random.default_rng(SEED + 11)
    return torch.from_numpy((rng.standard_normal((H, W, 2)) * 32.0)
                            .astype(np.float32)).to(dev)


def euler_cases(flow, positions, label: str = "") -> list:
    """K1's and K4's calls at the render paths' shapes on ``flow``: K1
    (P = positions, (N - 1, N) steps) and K4's four forms (dense dual
    (N - 1, N), dense and last step with visibility, N; compact with
    visibility on ``positions``, N). Each case: its label (prefixed with
    ``label``), the call, its rows, output entries, bytes an entry, input
    bytes, trajectory steps, and which latency bound applies (``K1`` for
    rows at ``positions``, ``K4`` for the grid)."""
    from slrsfs_tpu_torch.ops import euler as E

    n_f, n_b, N = N_FRAMES - 1, N_FRAMES, N_FRAMES
    P, R = positions.shape[0], flow.shape[0] * flow.shape[1]
    sfx = f" {label}" if label else ""

    def case(name, call, rows, entries, entry_bytes, steps, lat, compact=False):
        return {"name": name, "label": name + sfx, "call": call, "rows": rows, "entries": entries,
                "entry_bytes": entry_bytes, "in_bytes": R * 8 + (P * 8 if compact else 0),
                "steps": steps, "lat": lat}

    return [
        case("K1", lambda: E.euler_compact_dual(flow, positions, n_f, n_b), P,
             n_f + n_b + 2, 8, n_f + n_b, "K1", compact=True),
        case("K4 dense dual", lambda: E.euler_integrate_all_dual(flow, n_f, n_b), R,
             n_f + n_b + 2, 8, n_f + n_b, "K4"),
        case("K4 dense", lambda: E.euler_integrate_all(flow, N), R, N + 1, 12, N, "K4"),
        case("K4 last step", lambda: E.euler_integrate(flow, N), R, 1, 12, N, "K4"),
        case("K4 compact", lambda: E.euler_integrate_compact(flow, positions, N), P,
             N + 1, 12, N, "K1", compact=True),
    ]


def euler_latency(dll, probe, flow, positions) -> dict:
    """K1's and K4's latency bounds from ``tools/chase_probe.py``: device ms
    of N dependent gathers a trajectory, no stores, from K1's rows (both
    directions, 2P threads) and from every pixel (K4's dense grid, 2HW)."""
    import torch

    cells = positions[:, 1].long() * W + positions[:, 0].long()
    grid = torch.arange(H * W, device=flow.device)
    return {"K1": probe.latency_bound(dll, flow, cells, N_FRAMES, device_time),
            "K4": probe.latency_bound(dll, flow, grid, N_FRAMES, device_time)}


def euler_times(cases, lat: dict, prefix: str) -> dict:
    """Each case of ``euler_cases`` as called, on the card alone and the
    host's cost per call (``kernel_times``), with the card's work per call
    (``launch_split``), beside its bytes bound (every entry stored once;
    ~12 operations a trajectory step) and its latency bound ``lat`` (the
    chase probe's, None where the data ends the chains early), with the
    share of each; printed after ``prefix``."""
    out = {}
    for c in cases:
        t = kernel_times(c["call"], reps=20)
        sp = launch_split(c["call"])
        bnd = bound(c["in_bytes"] + c["entries"] * c["rows"] * c["entry_bytes"],
                    c["steps"] * c["rows"] * 12)
        lat_ms = lat.get(c["lat"])
        latency = ("" if lat_ms is None else
                   f", latency {lat_ms:.4f} ms ({100 * lat_ms / t['ms']:.1f} %)")
        print(f"{prefix} {c['label']}: {fmt_times(t)}; bounds: {bnd[1]} "
              f"{bnd[0]:.4f} ms ({100 * bnd[0] / t['ms']:.1f} %){latency}; per call "
              f"on the card (torch.profiler): {fmt_split(sp)}")
        out[c["label"]] = {"t": t, "ms": t["ms"], "bound": bnd, "latency": lat_ms,
                           "split": sp}
    return out


def tool_module(name: str):
    """This checkout's ``slrsfs_tpu_torch/tools/<name>.py``, loaded by its
    path (an older tree of ``--k1-in`` or ``--maxsplat-in`` lacks it); it
    builds with the imported package's ``kernels`` flags."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "slrsfs_tpu_torch",
                        "tools", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod



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


def k2_bf16_bound(name, ref32, u_mov, u_static, positions, valid, disp_a, disp_b,
                  w_a, w_b, out_dtype):
    """``bf16_cell_bound`` for K2 (name "K2": 64 features over e^Z) or K2-SLR
    (64 features over e^Z, af over e^C) in bf16 accumulation: sum |terms|
    by the plain f32 splat of |u_mov| with |u_static|, n the cell's nonzero
    taps plus its static row."""
    import torch

    from slrsfs_tpu_torch.ops.splat import _splat_dual_plain

    H_, W_, C1 = u_static.shape
    abs_terms = _splat_dual_plain(u_mov.float().abs(), positions, valid, disp_a, disp_b,
                                  w_a, w_b, u_static.float().abs())
    n = tap_counts(positions, valid, (disp_a, disp_b), H_, W_) + (
        u_static != 0).any(-1, keepdim=True).float()
    pairs = ([(c, C1 - 1) for c in range(C1 - 3)] + [(C1 - 3, C1 - 2)]
             if name == "K2-SLR" else [(c, C1 - 1) for c in range(C1 - 1)])
    return bf16_cell_bound(ref32, abs_terms, n, pairs, out_dtype)


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
    held against the f32 sums of the same rows, every element within the
    bound no summation order can break (``bf16_cell_bound``); the kernel's
    and the plain version's largest distances and their ratio are printed);
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
            bnd_one = bf16_cell_bound(ref_one, S.softsplat_sum_at_plain(
                u32.abs(), positions, disp_a, H, W),
                tap_counts(positions, None, (disp_a,), H, W))
            bnd_two = bf16_cell_bound(ref_two, S.softsplat_sum_at_quad_dual_plain(
                u32.abs(), positions, disp_a, disp_b, 0.5, 0.5, H, W),
                tap_counts(positions, None, (disp_a, disp_b), H, W))
        err, far, n_cancel = 0.0, [], 0
        for name, got, want in [(n, g, want_one) for n, g in one.items()] + [
                ("softsplat_sum_at_quad_dual", two, want_two)]:
            e = (got.float() - want.float()).abs().max().item()
            if dtype == torch.float32:
                check(torch.allclose(got, want, rtol=1e-5, atol=1e-5),
                      f"K8 f32 {name}: max abs {e}")
                n_cancel += check_zeros(got, want, f"K8 f32 {name}")
            else:
                dual = got is two
                c = bf16_cell_check(f"K8 bf16 {name}", got, want,
                                    ref_two if dual else ref_one,
                                    bnd_two if dual else bnd_one)
                far.append((c, e / want.float().abs().max().item()))
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
        worst = max(far, key=lambda f: f[0]["share"])[0] if far else None
        limit = (f"atol/rtol 1e-5, empty cells match; {n_cancel} elements of "
                 f"reached cells exactly 0 on one side") if label == "f32" else (
            f"{fmt_bf16(worst)} (the call that uses most of its bound); kernel vs "
            f"plain up to {max(f[1] for f in far):.3g} of max |out|")
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
                          sparsify_eps=0.0, crop_decode="off",
                          opt_overrides=overrides)
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
                      sparsify_eps=0.0, crop_decode="off",
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
                              sparsify_eps=0.0, crop_decode="off",
                          opt_overrides=overrides)
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
    * K3's bf16 forward and backward on the bf16 stage-1 (C = 65) and SLR
      stage-3 (C = 67) steps' own rows (``bf16_step_rows``), held as phase
      23 holds them (``k3_bf16_check``) and timed with their splits,
      bounds and window misses (``k3_bf16_times``);
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
    for name, (x, disp) in bf16_step_rows(dev).items():
        label = f"k3 bf16, {name}"
        g = k3_bf16_check(dev, label, x, disp)["g"]
        k3_bf16_times(dev, label, x, disp, g, plain=False)
        del x, disp, g
    torch.cuda.empty_cache()
    k7_times(dev, "k7", *k7_timing_inputs(dev, flow_np), plain_reps=0)
    # the end-to-end metrics: the dense render (K3's forward) and the
    # training step (K3 both ways, K7)
    img = (img_u8.astype(np.float32) / 255.0 - 0.5) / 0.5
    img_t = torch.from_numpy(img[None]).to(dev)
    r = SceneRenderer(W=W, n_frames=N_FRAMES, dtype="float32", seed=SEED,
                      sparsify_eps=0.0, crop_decode="off")
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


def k1_in(tree: str) -> int:
    """``python3 chip_smoke.py --k1-in TREE``: on the package of another
    unpacked tree of this repository, K1 and K4 at the render paths'
    shapes and the metric they move, to compare commits on one card
    (slrsfs_tpu_torch/tools/compare.sh k1):

    * the latency bounds (this checkout's ``tools/chase_probe.py``, built
      in TREE/build/probe);
    * K1 on phase 2's scene, quarter-pixel and leaving flows (P = 32768,
      (N - 1, N) steps), each held bit for bit against its plain version
      and timed (``euler_times``: as called, on the card alone, the host's
      cost, the per-launch split, the bytes bound and the latency bound);
    * K4's four forms on the scene, the leaving flow and ``k4_phase``'s
      random flow (``euler_cases``), held and timed likewise;
    * the baseline float32 render of the scene (median of 5)."""
    import torch

    dev = use_tree(tree)
    from slrsfs_tpu_torch.cli.render import SceneRenderer
    from slrsfs_tpu_torch.engine.rollout import prepare_scene_sparse
    from slrsfs_tpu_torch.ops import euler as E

    probe = tool_module("chase_probe")
    dll = probe.finish_build(probe.start_build())
    img_u8, flow_np = synthetic_scene(SEED)
    flow = torch.from_numpy(flow_np).to(dev)
    positions = torch.from_numpy(prepare_scene_sparse(flow_np)[0]).to(dev)
    lat = euler_latency(dll, probe, flow, positions)
    print(f"k1 latency bounds (tools/chase_probe.py): K1's rows {lat['K1']:.4f} ms, "
          f"K4's grid {lat['K4']:.4f} ms")
    rand = torch.from_numpy((np.random.default_rng(SEED + 4).standard_normal((H, W, 2))
                             * 2.0).astype(np.float32)).to(dev)
    flows = {"scene": flow, "quarter-pixel": torch.round(flow * 4.0) / 4.0,
             "leaving": leaving_flow(dev), "random": rand}
    plain = {"K1": lambda m: E.euler_compact_dual_plain(m, positions, N_FRAMES - 1,
                                                        N_FRAMES),
             "K4 dense dual": lambda m: E.euler_integrate_all_dual_plain(
                 m, N_FRAMES - 1, N_FRAMES),
             "K4 dense": lambda m: E.euler_integrate_all_plain(m, N_FRAMES),
             "K4 last step": lambda m: E.euler_integrate_plain(m, N_FRAMES),
             "K4 compact": lambda m: E.euler_integrate_compact_plain(m, positions,
                                                                    N_FRAMES)}
    which = {"scene": ("K1", "K4"), "quarter-pixel": ("K1",), "leaving": ("K1", "K4"),
             "random": ("K4",)}
    for label, m in flows.items():
        cases = [c for c in euler_cases(m, positions, label)
                 if c["name"].startswith(which[label])]
        for c in cases:
            got = c["call"]()
            want = plain[c["name"]](m)
            torch.cuda.synchronize()
            check(all(torch.equal(g, w) for g, w in zip(got, want)),
                  f"{c['label']}: kernel differs from plain")
        # the leaving flow's chains end early: no latency bound
        euler_times(cases, {} if label == "leaving" else lat, "k1")
    # the end-to-end metric K1 moves: the baseline f32 render
    img = (img_u8.astype(np.float32) / 255.0 - 0.5) / 0.5
    r = SceneRenderer(W=W, n_frames=N_FRAMES, dtype="float32", seed=SEED,
                      sparsify_eps=0.0, crop_decode="off")
    med, ts = render_median(r, img, flow_np, reps=5)
    print(f"k1 baseline float32 render: median {med * 1e3:.1f} ms = "
          f"{N_FRAMES / med:.2f} frames/s (runs {[round(x * 1e3, 1) for x in ts]} ms)")
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


def step_runs(dev, phase: int, label: str, options, make_batch, log_keys=()) -> dict:
    """The full-width G+D step through Trainer.train_step at batch 16
    (halved while it does not fit, said so): a dense batch (K7 dense) and
    one with 50 % moving rows through attach_moving_sets (K7 compact), one
    warm-up and 3 timed steps each, launches counted over each run's 3
    steps (6 K3 forward, 6 backward, 3 K7, nothing else), every loss
    finite and each of ``log_keys`` logged. ``options(B)`` gives the
    Options, ``make_batch(rng, B, W, moving_frac)`` the numpy batch."""
    import torch

    from slrsfs_tpu_torch import kernels
    from slrsfs_tpu_torch.cli.train import (
        attach_moving_sets,
        build,
        to_device_batch,
    )

    B = TRAIN_B
    while True:
        opt = options(B)
        _, tr = build(opt, train_max_steps=TRAIN_T, device=dev, seed=SEED)
        batch = to_device_batch(make_batch(np.random.default_rng(SEED), B, W), dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        try:
            tr.train_step(batch)  # warm-up
            torch.cuda.synchronize()
            break
        except torch.cuda.OutOfMemoryError:
            peak = torch.cuda.max_memory_allocated()
            del tr, batch
            gc.collect()
            torch.cuda.empty_cache()
            print(f"phase {phase} batch {B} does not fit the card (peak "
                  f"{peak / 2**30:.1f} GiB at the failure); halving")
            check(B > 1, "batch 1 does not fit")
            B //= 2
    warm_peak = torch.cuda.max_memory_allocated()
    want = {**{k.name: 0 for k in kernels.KERNELS}, "splat_dense_fwd": 6,
            "splat_dense_bwd": 6, "euler_phased": 3}
    sparse_np = attach_moving_sets(make_batch(np.random.default_rng(SEED + 1), B, W,
                                              moving_frac=0.5))
    check("mov_pos" in sparse_np, f"{label}: the 50 % batch has no moving sets")
    sparse = to_device_batch(sparse_np, dev)
    res = {"B": B, "tr": tr, "batch": batch, "sparse": sparse, "sparse_np": sparse_np}
    for kind, b in (("dense", batch), ("compact", sparse)):
        if kind == "compact":
            tr.train_step(b)  # warm-up
        kernels.reset_counts()
        host, stages, logs = _step_times(tr, b, 3)
        launches = kernels.counts()
        check(launches == want, f"{label} {kind} launches over 3 steps: {launches}")
        for k in log_keys:
            check(k in logs, f"{label} logs lack {k}: {sorted(logs)}")
        for k, v in logs.items():
            check(bool(torch.isfinite(v)), f"{label} {kind} loss {k} = {v}")
        step_ms = float(np.median(host))
        head = (f"phase {phase} {label} (dense K7): B={B} {W}^2 ngf={opt.ngf} T={TRAIN_T}"
                if kind == "dense" else f"phase {phase} {label} (50 % moving, compact K7, "
                f"P={sparse_np['mov_pos'].shape[1]})")
        tail = (f"; launches over 3 steps {launches}; peak {warm_peak / 2**30:.2f} GiB; losses "
                + ", ".join(f"{k} {v.item():.4f}" for k, v in logs.items())
                if kind == "dense" else "")
        print(f"{head}: {step_ms:.1f} ms/step median = {B / step_ms * 1e3:.2f} samples/s "
              f"(runs {[round(x, 1) for x in host]} ms); stages "
              + ", ".join(f"{k} {v:.1f} ms" for k, v in stages.items()) + tail)
        sfx = "" if kind == "dense" else "_compact"
        res.update({"launches" + sfx: launches, "step_ms" + sfx: step_ms,
                    "stages" + sfx: stages})
    return res


def _upsample2x_adjoint_1d(g, dim: int):
    """The VJP of 2x bilinear upsampling (align_corners False) along
    ``dim`` (even size 2n): output 2k takes 0.25 x[k-1] + 0.75 x[k] (x[0]
    at k = 0), output 2k+1 takes 0.75 x[k] + 0.25 x[k+1] (x[n-1] at the
    end). Slices and adds only, so the same inputs give the same bits."""
    n = g.shape[dim] // 2
    pairs = g.unflatten(dim, (n, 2))
    even, odd = pairs.select(dim + 1, 0), pairs.select(dim + 1, 1)
    gx = 0.75 * (even + odd)
    gx.narrow(dim, 0, n - 1).add_(0.25 * even.narrow(dim, 1, n - 1))
    gx.narrow(dim, 1, n - 1).add_(0.25 * odd.narrow(dim, 0, n - 1))
    gx.narrow(dim, 0, 1).add_(0.25 * even.narrow(dim, 0, 1))
    gx.narrow(dim, n - 1, 1).add_(0.25 * odd.narrow(dim, n - 1, 1))
    return gx


def upsample_bilinear_2x_deterministic(x):
    """``nn/conv.py:upsample_bilinear_2x`` (the same forward) whose
    backward adds without atomics (``_upsample2x_adjoint_1d`` along H,
    then W), where the card's F.interpolate backward adds with atomics in
    a run-to-run order."""
    import torch
    import torch.nn.functional as F

    class _Up(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)

        @staticmethod
        def backward(ctx, g):
            return _upsample2x_adjoint_1d(_upsample2x_adjoint_1d(g, 2), 3)

    return _Up.apply(x)


@contextlib.contextmanager
def deterministic_steps():
    """Training steps whose sums are added in one order every run, but for
    the kernels' atomics: the convolutions off cuDNN (PyTorch's own
    im2col and GEMM convolutions, whose order of sums does not depend on
    the device memory free, as cuDNN's choice of algorithm does), and the
    bilinear upsampling of the decoders and the motion regressor with
    ``upsample_bilinear_2x_deterministic``'s backward."""
    import torch

    from slrsfs_tpu_torch.models import motion
    from slrsfs_tpu_torch.nn import blocks

    cudnn = torch.backends.cudnn
    prev = (cudnn.enabled, blocks.upsample_bilinear_2x, motion.upsample_bilinear_2x)
    cudnn.enabled = False
    blocks.upsample_bilinear_2x = motion.upsample_bilinear_2x = \
        upsample_bilinear_2x_deterministic
    try:
        yield
    finally:
        cudnn.enabled, blocks.upsample_bilinear_2x, motion.upsample_bilinear_2x = prev


def _host(t):
    """A host copy of a tensor (None stays None)."""
    return None if t is None else t.detach().to("cpu", copy=True)


class StepRecorder:
    """The K3 and K7 calls of one training step, for a plain step to replay
    or to be compared with, kept in host memory. ``record()`` wraps the
    kernel entries (K3's and K7's forwards as the model calls them, K3's
    and K7's backwards) and keeps each call's inputs and outputs;
    ``replay(rec)`` makes the plain path's K3 and K7 forwards return the
    recorded kernel forwards' outputs (their inputs checked bit-equal
    first; a K7 motion that requires grad gets the plain autograd as its
    VJP) and keeps each plain K3 backward's inputs and outputs, on the
    host. ``device``: the calls' device."""

    def __init__(self):
        self.fwd, self.bwd, self.k7, self.k7_bwd = [], [], [], []
        self.device = None

    @contextlib.contextmanager
    def record(self):
        from slrsfs_tpu_torch.models import baseline as port_models
        from slrsfs_tpu_torch.ops import euler as port_euler
        from slrsfs_tpu_torch.ops import splat as port_splat

        fwd, bwd, k7b = (port_splat.softsplat_sum_fwd_kernel,
                         port_splat.softsplat_sum_bwd_kernel, port_euler.euler_phased_bwd)

        def rec_k7(fn):
            def call(motion, *args):
                out_f, out_p = fn(motion, *args)
                self.k7.append((tuple(_host(a) for a in (motion,) + args[:-1]), args[-1],
                                _host(out_f), _host(out_p)))
                return out_f, out_p
            return call

        def rec_fwd(inp, flow):
            out = fwd(inp, flow)
            self.device = inp.device
            self.fwd.append((_host(inp), _host(flow), _host(out)))
            return out

        def rec_bwd(inp, flow, g):
            gi, gf = bwd(inp, flow, g)
            self.bwd.append(tuple(_host(t) for t in (inp, flow, g, gi, gf)))
            return gi, gf

        def rec_k7b(motion, t_fwd, t_bwd, out_f, out_p, cot_f, cot_p, n_steps):
            grad = k7b(motion, t_fwd, t_bwd, out_f, out_p, cot_f, cot_p, n_steps)
            self.k7_bwd.append(tuple(_host(t) for t in (
                motion, t_fwd, t_bwd, cot_f, cot_p, grad)) + (n_steps,))
            return grad

        with _patched(port_splat, softsplat_sum_fwd_kernel=rec_fwd,
                      softsplat_sum_bwd_kernel=rec_bwd), \
                _patched(port_euler, euler_phased_bwd=rec_k7b), \
                _patched(port_models, euler_integrate_phased=rec_k7(
                    port_models.euler_integrate_phased),
                    euler_integrate_phased_compact=rec_k7(
                        port_models.euler_integrate_phased_compact)):
            yield self

    @contextlib.contextmanager
    def replay(self, rec: "StepRecorder"):
        import torch

        from slrsfs_tpu_torch.models import baseline as port_models
        from slrsfs_tpu_torch.ops import splat as port_splat

        grad_plain = port_splat.softsplat_sum_grad_plain
        n, m = [0], [0]

        class ReplayedK7(torch.autograd.Function):
            """A recorded K7 forward's outputs, copied to ``device``, whose
            VJP is the plain version's autograd (``fn``, recomputed)."""

            @staticmethod
            def forward(ctx, motion, out_f, out_p, device, fn, args):
                ctx.save_for_backward(motion)
                ctx.fn, ctx.args = fn, args
                return out_f.to(device), out_p.to(device)

            @staticmethod
            def backward(ctx, g_f, g_p):
                (motion,) = ctx.saved_tensors
                with torch.enable_grad():
                    x = motion.detach().requires_grad_(True)
                    a, b = ctx.fn(x, *ctx.args)
                    loss = sum((o * g).sum() for o, g in ((a, g_f), (b, g_p))
                               if g is not None)
                    grad = torch.autograd.grad(loss, x)[0]
                return grad, None, None, None, None, None

        def replay_k7(fn):
            def call(motion, *args):
                check(m[0] < len(rec.k7), "the plain step integrates more often than the "
                      "kernel step")
                k_in, k_steps, k_f, k_p = rec.k7[m[0]]
                m[0] += 1
                check(k_steps == args[-1] and len(k_in) == len(args) and all(
                    torch_equal(a.detach().cpu(), b) for a, b in zip((motion,) + args[:-1], k_in)),
                    f"the plain step's K7 forward {m[0]} has other inputs than the kernel's")
                self.k7.append(None)
                if torch.is_grad_enabled() and motion.requires_grad:
                    return ReplayedK7.apply(motion, k_f, k_p, motion.device, fn, args)
                return k_f.to(motion.device), k_p.to(motion.device)
            return call

        def replay_fwd(inp, flow):
            check(n[0] < len(rec.fwd), "the plain step splats more often than the kernel step")
            k_inp, k_flow, k_out = rec.fwd[n[0]]
            n[0] += 1
            check(torch_equal(inp.cpu(), k_inp) and torch_equal(flow.cpu(), k_flow),
                  f"the plain step's K3 forward {n[0]} has other inputs than the kernel's")
            self.device = inp.device
            self.fwd.append(None)
            return k_out.to(inp.device)

        def rec_bwd(inp, flow, g):
            gi, gf = grad_plain(inp, flow, g)
            self.bwd.append(tuple(_host(t) for t in (inp, flow, g, gi, gf)))
            return gi, gf

        with _patched(port_splat, softsplat_sum_plain=replay_fwd,
                      softsplat_sum_grad_plain=rec_bwd), \
                _patched(port_models, euler_integrate_phased_plain=replay_k7(
                    port_models.euler_integrate_phased_plain),
                    euler_integrate_phased_compact_plain=replay_k7(
                        port_models.euler_integrate_phased_compact_plain)):
            yield self
        check(n[0] == len(rec.fwd) and m[0] == len(rec.k7), f"the plain step replayed "
              f"{n[0]} of {len(rec.fwd)} K3 forwards and {m[0]} of {len(rec.k7)} K7 forwards")


def torch_equal(a, b) -> bool:
    import torch

    return a.shape == b.shape and a.dtype == b.dtype and bool(torch.equal(a, b))


@contextlib.contextmanager
def _patched(module, **attrs):
    prev = {k: getattr(module, k) for k in attrs}
    for k, v in attrs.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in prev.items():
            setattr(module, k, v)


def k3_grad_flow_terms(inp, flow, g):
    """(B, H, W, 2) float64: the sum of |terms| of each grad_flow entry of
    K3's backward, sum over the corners of |dw/d{x,y}| · sum over the
    channels of |inp · g at the corner|, with the corners and fractions
    computed in f32 as both versions compute them."""
    import torch

    from slrsfs_tpu_torch.ops.splat import corners

    B, H_, W_, C = inp.shape
    xs = torch.arange(W_, dtype=flow.dtype, device=flow.device)[None, :]
    ys = torch.arange(H_, dtype=flow.dtype, device=flow.device)[:, None]
    out = torch.zeros((B, H_ * W_, 2), dtype=torch.float64, device=flow.device)
    for b in range(B):
        ox = (xs + flow[b, ..., 0]).reshape(-1)
        oy = (ys + flow[b, ..., 1]).reshape(-1)
        dx = (ox - torch.floor(ox)).double()
        dy = (oy - torch.floor(oy)).double()
        x = inp[b].reshape(H_ * W_, C).abs().double()
        gb = g[b].reshape(H_ * W_, C).abs().double()
        for (lin, _, inside), ax, ay in zip(corners(ox, oy, H_, W_),
                                            (1.0 - dy, 1.0 - dy, dy, dy),
                                            (1.0 - dx, dx, 1.0 - dx, dx)):
            inner = (x * torch.where(inside[:, None], gb[lin], 0.0)).sum(-1)
            out[b, :, 0] += inner * ax
            out[b, :, 1] += inner * ay
    return out.reshape(B, H_, W_, 2)


def bwd_kernel_checks(label: str, rec: StepRecorder) -> dict:
    """Each recorded backward kernel call against its plain version on the
    same inputs: K3's grad_inp within 1e-5 of its largest entry
    (``k3_bwd_check``'s bound; it is bit for bit); K3's grad_flow, a sum
    over the C channels and four corners that the step's own cotangents
    make cancel, entry by entry within the two f32 sums' rounding bound,
    2 gamma_(C+6) (u = 2^-24) times the entry's sum of |terms|
    (``k3_grad_flow_terms``), its distance of the largest entry printed;
    K7's gradient within 1e-5 of its largest (the plain forward's
    autograd). Returns the largest shares."""
    import torch

    from slrsfs_tpu_torch.ops.euler import euler_integrate_phased_plain
    from slrsfs_tpu_torch.ops.splat import softsplat_sum_grad_plain

    out = {"K3 grad_inp": 0.0, "K3 grad_flow": 0.0, "K3 grad_flow of its bound": 0.0,
           "K7": 0.0}
    for call in rec.bwd:
        inp, flow, g, gi, gf = (t.to(rec.device) for t in call)
        wi, wf = softsplat_sum_grad_plain(inp, flow, g)
        r = (gi - wi).abs().max().item() / max(wi.abs().max().item(), 1e-30)
        check(r <= 1e-5, f"{label} K3 grad_inp: {r:.3g} of its largest (limit 1e-5)")
        out["K3 grad_inp"] = max(out["K3 grad_inp"], r)
        d = (gf - wf).abs().double()
        bnd = 2.0 * rounding_gamma(torch.tensor(float(inp.shape[-1] + 6)), F32_U).item() \
            * k3_grad_flow_terms(inp, flow, g)
        share = (d / bnd.clamp(min=1e-300)).max().item()
        check(bool((d <= bnd).all()), f"{label} K3 grad_flow: {share:.3g} of its rounding "
              f"bound 2 gamma_(C+6) x the sum of |terms| (limit 1)")
        out["K3 grad_flow of its bound"] = max(out["K3 grad_flow of its bound"], share)
        out["K3 grad_flow"] = max(out["K3 grad_flow"], d.max().item()
                                  / max(wf.abs().max().item(), 1e-30))
    for call in rec.k7_bwd:
        motion, t_fwd, t_bwd, cot_f, cot_p, grad = (
            None if t is None else t.to(rec.device) for t in call[:-1])
        n_steps = call[-1]
        x = motion.clone().requires_grad_(True)
        a, b = euler_integrate_phased_plain(x, t_fwd, t_bwd, n_steps)
        loss = sum((o * c).sum() for o, c in ((a, cot_f), (b, cot_p)) if c is not None)
        want = torch.autograd.grad(loss, x)[0]
        r = (grad - want).abs().max().item() / max(want.abs().max().item(), 1e-30)
        check(r <= 1e-5, f"{label} K7 backward: {r:.3g} of its largest (limit 1e-5)")
        out["K7"] = max(out["K7"], r)
    return out


def _left_sources(a: StepRecorder, b: StepRecorder, la: dict, lb: dict) -> list:
    """Where two plain steps' recorded calls first differ: the losses, then
    each K3 backward's incoming cotangent and outputs in call order."""
    left = [f"loss {k}" for k in la if la[k].item() != lb[k].item()]
    for i, (x, y) in enumerate(zip(a.bwd, b.bwd)):
        for name, s, t in zip(("cotangent", "grad_inp", "grad_flow"), x[2:], y[2:]):
            if not torch_equal(s, t):
                left.append(f"K3 backward {i} {name}")
    return left or ["the steps' other sums (the K7 plain backward's scatter, the "
                    "optimizers' inputs)"]


def kernel_vs_plain_steps(phase: int, label: str, tr, batches: dict,
                          own_limit: float = None, ref=None) -> dict:
    """A kernel-path step against a plain-path step from one snapshot for
    each batch, measuring the kernels and not the run-to-run order of sums.

    Under ``deterministic_steps`` (the convolutions off cuDNN, the
    bilinear upsampling's backward without atomics) the kernel step
    records each K3 forward (whose f32 atomics reorder from run to run),
    each K7 forward and each K3 and K7 backward (``StepRecorder``); the
    plain step (``ref``'s, ``tr``'s by default) replays the kernel
    forwards' outputs after checking that their inputs are bit-equal.
    cuDNN is off because the algorithm it picks depends on the device
    memory free when a shape is first seen (under the whole script's
    memory pressure the first deterministic-mode step of phase 17's
    trainer took other algorithms than the steps after it, and so the
    losses parted by one ulp); PyTorch's own convolutions sum in one
    order whatever the memory. So the two steps' forwards are the same
    bits: the losses must be bit-equal, and so must each K3 backward's
    incoming cotangent (K7's carries K3's backward's difference). Held:

    * self-check: a second plain step from the snapshot, replaying too,
      within 1e-5 of the largest gradient of the first (else the phase
      fails and names the sums left);
    * each backward kernel call against its plain version on its own
      recorded inputs (``bwd_kernel_checks``);
    * the gradients within 1e-3 of the largest, printed by sub-network
      (G's top-level children and D, each against the largest and against
      its own largest) and, with ``own_limit``, held within it of each
      sub-network's own largest.

    Both trainers are restored after."""
    import torch

    ref = tr if ref is None else ref
    path = {}
    names = tr.g_names + [f"D.{n}" for n, _ in tr.d_model.named_parameters()]

    def _fresh():
        tr.last_grads = ref.last_grads = {}
        gc.collect()

    for kind, b in batches.items():
        snap, snap_ref = tr.snapshot(), (None if ref is tr else ref.snapshot())
        with deterministic_steps():
            k_rec = StepRecorder()
            _fresh()
            with k_rec.record():
                got = tr.train_step(b)
            g_k = [_host(x) for x in tr.last_grads["g"] + tr.last_grads["d"]]
            tr.restore(snap)
            runs = []
            for _ in range(2):
                p_rec = StepRecorder()
                _fresh()
                with p_rec.replay(k_rec):
                    logs = ref.train_step(b, plain=True)
                runs.append((p_rec, logs, [_host(x) for x in ref.last_grads["g"]
                                           + ref.last_grads["d"]]))
                ref.restore(snap if snap_ref is None else snap_ref)
        (p_rec, want_l, g_p), (p_rec2, want_l2, g_p2) = runs
        d, s = _max_grad_diff(g_p2, g_p)
        self_rel = d / max(s, 1e-30)
        check(self_rel <= 1e-5, f"{label} {kind}: two plain steps from one snapshot differ "
              f"by {self_rel:.3g} of the largest gradient (limit 1e-5); sums left: "
              + ", ".join(_left_sources(p_rec, p_rec2, want_l, want_l2)))
        differ = {k: (got[k].item(), want_l[k].item()) for k in want_l
                  if got[k].item() != want_l[k].item()}
        if differ:
            check(False, f"{label} {kind}: the kernel and plain steps' forwards are the "
                  f"same bits but their losses differ: {differ}; device memory free "
                  f"{torch.cuda.mem_get_info()[0] / 2**30:.2f} GiB after the steps, peak "
                  f"allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        check(len(k_rec.bwd) == len(p_rec.bwd) and all(
            torch_equal(x[2], y[2]) for x, y in zip(k_rec.bwd, p_rec.bwd)),
            f"{label} {kind}: a K3 backward's incoming cotangent differs between the "
            f"kernel and plain steps")
        bwd = bwd_kernel_checks(f"{label} {kind}", k_rec)
        g_diff, g_scale = _max_grad_diff(g_k, g_p)
        groups = {}
        for n, a, w in zip(names, g_k, g_p):
            top = n.split(".", 1)[0]
            d, s = groups.get(top, (0.0, 0.0))
            groups[top] = (max(d, (a - w).abs().max().item()), max(s, w.abs().max().item()))
        check(g_diff <= 1e-3 * g_scale, f"{label} {kind} kernel vs plain step: "
              f"gradients differ by {g_diff:.3g} (largest {g_scale:.3g})")
        for n, (d, s) in groups.items():
            check(own_limit is None or d <= own_limit * s, f"{label} {kind} kernel vs plain "
                  f"step: {n}'s gradients differ by {d:.3g} (its largest {s:.3g})")
        path[kind] = {"self": self_rel, "grad": g_diff / g_scale, "bwd": bwd,
                      "k3_calls": len(k_rec.fwd), "k7_calls": len(k_rec.k7),
                      "k7_bwd_calls": len(k_rec.k7_bwd),
                      "groups": {n: (d / g_scale, d / max(s, 1e-30))
                                 for n, (d, s) in groups.items()}}
        del g_k, g_p, g_p2, k_rec, p_rec, p_rec2, runs, snap, snap_ref
    print(f"phase {phase} {label} kernel vs plain step (convolutions off cuDNN, "
          f"upsampling backward without atomics, the kernel's K3 and K7 forwards replayed "
          f"into the plain step): " + "; ".join(
              f"{k}: self-check two plain steps {v['self']:.3g} of the largest gradient "
              f"(limit 1e-5); losses and the K3 backwards' incoming cotangents "
              f"bit-equal ({v['k3_calls']} K3 and {v['k7_calls']} K7 forwards replayed); "
              f"backward kernels on "
              f"their own inputs, of their largest (limit 1e-5 but grad_flow's): "
              + ", ".join(f"{n} {x:.3g}" for n, x in v["bwd"].items())
              + f" (limit 1; {v['k7_bwd_calls']} K7 backward calls); "
              f"gradients {v['grad']:.3g} of the largest (limit 1e-3); by sub-network, of "
              f"the largest / of its own largest"
              + ("" if own_limit is None else f" (limit {own_limit:g})") + ": "
              + ", ".join(f"{n} {a:.3g} / {o:.3g}" for n, (a, o) in v["groups"].items())
              for k, v in path.items()))
    return path


def step_peak(phase: int, label: str, tr, batch) -> int:
    """The peak memory of one step, printed with the resident part."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    tr.train_step(batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    print(f"phase {phase} {label} peak memory of a step: {peak / 2**30:.2f} GiB allocated "
          f"({(peak - base) / 2**30:.2f} GiB above the resident "
          f"{base / 2**30:.2f} GiB of weights, optimizer and batch)")
    return peak


def training_phase(dev):
    """The stage-1 step at full width (``Options()`` defaults, ngf 64, D
    ndf 64): ``step_runs``, the kernel path against the plain path from
    one snapshot (both batches) and the peak memory of a step."""
    from slrsfs_tpu_torch.config import Options

    res = step_runs(dev, 10, "training step",
                    lambda B: Options(W=W, batch_size=B), make_train_batch)
    tr, batch, sparse = res.pop("tr"), res.pop("batch"), res.pop("sparse")
    del res["sparse_np"]
    kernel_vs_plain_steps(10, "training", tr, {"dense": batch, "compact": sparse})
    res["peak"] = step_peak(10, "training", tr, batch)
    return res


def write_train_fixture(root: str, seed: int):
    """Two training scenes and one validation scene in the reference layout
    (<split>/<scene>_gt.mp4 and _motion.npz, avr_image/<scene>.png, one
    rock_label/<scene>.png.json, <split>/<scene>_sparse_motion.flo), as
    tests/conftest.py makes them: 12 frames of 256x144, the bottom half
    moving, the first frame as the mean video, half the motion as the
    hints, a rock polygon on the first training scene."""
    import cv2
    from PIL import Image

    from slrsfs_tpu_torch.utils.flow_viz import write_flo

    rng = np.random.default_rng(seed)
    h, w, n = 144, 256, 12
    os.makedirs(os.path.join(root, "avr_image"), exist_ok=True)
    os.makedirs(os.path.join(root, "rock_label"), exist_ok=True)
    label = {"width": w, "height": h, "step_1": {"result": [{"pointList": [
        {"x": 20, "y": 70}, {"x": 150, "y": 80}, {"x": 140, "y": 140},
        {"x": 10, "y": 135}]}]}}
    with open(os.path.join(root, "rock_label", "00001_00000.png.json"), "w") as f:
        json.dump(label, f)
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
            write_flo(os.path.join(root, split, f"{scene}_sparse_motion.flo"), motion * 0.5)
            Image.fromarray(base).save(os.path.join(root, "avr_image", f"{scene}.png"))


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
    r = SceneRenderer(ckpt=ckpt, W=64, n_frames=8, crop_decode="off")
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
    slr_cli_phase(root, ckpt, scene_dir, img_path, flow_path)


SLR_LOG_KEYS = ("AlphaTV", "L1_bg", "Perceptual_bg", "FluidRegionLoss", "RockRegionLoss",
                "Alpha Decoder Consistency Loss")


def write_bg_ckpt(path: str, seed: int) -> str:
    """A seeded full-width ``net_bg`` (an ``SLRModel``'s, ``Options()``
    widths) as a reference-style stage-2 ``.pth`` (keys
    ``model.module.net_bg.*``)."""
    import torch

    from slrsfs_tpu_torch.config import Options
    from slrsfs_tpu_torch.models.baseline import init_random_weights
    from slrsfs_tpu_torch.models.slr import SLRModel

    m = SLRModel(Options(**SLR_OPTS))
    init_random_weights(m, seed)
    torch.save({"state_dict": {f"model.module.{k}": v for k, v in m.state_dict().items()
                               if k.startswith("net_bg.")}}, path)
    return path


def slr_cli_phase(root: str, s1_ckpt: str, scene_dir: str, img_path: str, flow_path: str):
    """SLR stage 3 through the train CLI for 2 steps (full width, W = 64,
    batch 2) from phase 11's stage-1 checkpoint and a seeded bg checkpoint;
    its SLR losses logged and finite, the alpha nets kept at their initial
    weights; then SceneRenderer renders the SLR checkpoint (K1 once, K2-SLR
    a frame)."""
    import shutil

    import torch

    from slrsfs_tpu_torch import kernels
    from slrsfs_tpu_torch.cli.render import SceneRenderer

    out = os.path.join(OUT_DIR, "train_run_slr")
    shutil.rmtree(out, ignore_errors=True)
    bg = write_bg_ckpt(os.path.join(OUT_DIR, "bg.pth"), SEED + 11)
    cmd = [sys.executable, "-m", "slrsfs_tpu_torch.cli.train", "--data-root", root,
           "--out", out, "--model-type", SLR_OPTS["model_type"], "--init-from", s1_ckpt,
           "--init-bg-from", bg, "--batch-size", "2", "--W", "64", "--niter", "1",
           "--niter-decay", "0", "--steps-per-epoch", "2", "--val-steps", "1",
           "--seed", str(SEED)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    secs = time.perf_counter() - t0
    check(proc.returncode == 0, f"stage-3 train CLI failed:\n{proc.stdout}\n{proc.stderr}")
    check("kept at init: ['net_alpha_encoder', 'net_alpha_decoder']" in proc.stdout,
          f"stage-3 warm start: {proc.stdout}")
    ckpt = os.path.join(out, "checkpoint.pth")
    with open(os.path.join(out, "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    steps = [r for r in rows if r["split"] == "train"]
    check(len(steps) == 2, f"stage-3 train CLI logged {len(steps)} steps")
    for r in steps:
        check(all(k in r for k in SLR_LOG_KEYS), f"stage-3 log lacks SLR keys: {sorted(r)}")
    for r in rows:
        check(all(np.isfinite(v) for k, v in r.items() if k != "split"),
              f"stage-3 train CLI log not finite: {r}")
    r = SceneRenderer(ckpt=ckpt, W=64, n_frames=8, crop_decode="off")
    check(r.slr, "the stage-3 checkpoint does not load as SLR")
    kernels.reset_counts()
    out_dir, outs = render_capture(r, img_path, flow_path,
                                   os.path.join(scene_dir, "trained_slr"), name="synthetic")
    torch.cuda.synchronize()
    launches = kernels.counts()
    check(launches == {**{k.name: 0 for k in kernels.KERNELS}, "euler_compact_dual": 1,
                       "splat_dual_normalize_slr": 8},
          f"stage-3 SLR render launches {launches}")
    pred = outs["PredImg"]
    check(tuple(pred.shape) == (8, 64, 64, 3), f"SLR frames {pred.shape}")
    check(all(bool(torch.isfinite(v).all()) for v in outs.values()),
          "stage-3 SLR render not finite")
    pngs = sorted(os.listdir(os.path.join(out_dir, "PredImg")))
    check(len(pngs) == 8, f"stage-3 SLR render wrote {len(pngs)} PNGs")
    last = steps[-1]
    print(f"phase 11 stage-3 train CLI (--init-from the stage-1 checkpoint, "
          f"--init-bg-from a seeded net_bg): 2 steps + validation + checkpoint in "
          f"{secs:.1f} s; alpha nets kept at init; last step " + ", ".join(
              f"{k} {last[k]:.4f}" for k in ("Total Loss",) + SLR_LOG_KEYS)
          + f"; SceneRenderer rendered the SLR checkpoint: launches "
          f"{ {k: v for k, v in launches.items() if v} }, 8 PNGs, frame range "
          f"[{pred.min().item():.3f}, {pred.max().item():.3f}]")


# ---- SLR stage 3: the joint two-layer step at full width -----------------
#
# The CLI's stage-3 option set on Options() widths (ngf 64, pconv decoders,
# spectral D), batch 16, W = 256, T = 60, float32: the packed splat rows are
# [fs·e^Z (64), af·e^C, e^C, e^Z], C = 67.
SLR_TRAIN_C = 67


def make_slr_batch(rng, B: int, W_: int, moving_frac: float = 1.0):
    """``make_train_batch`` plus a rock mask (one polygon over about a
    quarter of the frame) and a mean video, as numpy."""
    from PIL import Image, ImageDraw

    batch = make_train_batch(rng, B, W_, moving_frac)
    poly = Image.new("L", (W_, W_), 0)
    ImageDraw.Draw(poly).polygon([(0.1 * W_, 0.45 * W_), (0.6 * W_, 0.5 * W_),
                                  (0.55 * W_, 0.95 * W_), (0.05 * W_, 0.9 * W_)],
                                 outline=1, fill=1)
    mask = np.asarray(poly, np.float32)[None, ..., None]
    batch["mask_rock"] = np.repeat(mask, B, axis=0)
    batch["mean_video"] = (rng.standard_normal((B, W_, W_, 3)) * 0.25).astype(np.float32)
    return batch


def slr_splat_inputs(tr, batch):
    """The packed rows and flows the step's two splats take, and the fluid
    alpha masks ``g[..., -1:] > NORM_EPS`` of a kernel-path and a
    plain-path forward, all from one snapshot (restored after)."""
    import torch

    from slrsfs_tpu_torch.models import slr as slr_mod

    seen = []
    kernel_splat = slr_mod.softsplat_sum

    def spy(inp, flow):
        seen.append((inp.detach().clone(), flow.detach().clone()))
        return kernel_splat(inp, flow)

    snap = tr.snapshot()
    masks = []
    with torch.no_grad():
        for plain in (False, True):
            slr_mod.softsplat_sum = spy
            try:
                _, pred = tr.model.forward_train(batch, train=True, deterministic=True,
                                                 plain=plain)
            finally:
                slr_mod.softsplat_sum = kernel_splat
            masks.append(pred["AlphaFluidMask"])
            del pred
            tr.restore(snap)
    del snap
    return seen, masks


def slr_training_phase(dev):
    """The SLR stage-3 G+D step at full width (the CLI's stage-3 options on
    ``Options()`` widths): ``step_runs`` on ``make_slr_batch``; K3 forward
    and backward at (B, 256, 256, 67) on the dense step's own packed rows
    and flows against their plain versions and timed, and the fluid alpha
    mask's elements that differ between a kernel and a plain forward; K7
    on the compact batch, bit for bit and timed; the kernel path against
    the plain path from one snapshot; the peak memory of a step."""
    import torch

    from slrsfs_tpu_torch.cli.train import stage_options
    from slrsfs_tpu_torch.config import Options
    from slrsfs_tpu_torch.ops.euler import (
        euler_integrate_phased,
        euler_integrate_phased_compact,
        euler_integrate_phased_compact_plain,
        euler_integrate_phased_plain,
    )

    slr_type = SLR_OPTS["model_type"]
    res = step_runs(dev, 17, f"SLR stage-3 step (C={SLR_TRAIN_C})",
                    lambda B: Options(W=W, batch_size=B, model_type=slr_type,
                                      **stage_options(slr_type)),
                    make_slr_batch, SLR_LOG_KEYS + ("Total Loss", "GAN", "D_Fake"))
    tr, batch, sparse = res.pop("tr"), res.pop("batch"), res.pop("sparse")
    sparse_np = res.pop("sparse_np")
    B = res["B"]

    # K3 at C = 67 on the dense step's own packed rows and flows
    seen, masks = slr_splat_inputs(tr, batch)
    check(len(seen) == 2 and all(tuple(u.shape) == (B, H, W, SLR_TRAIN_C)
                                 for u, _ in seen),
          f"SLR splat inputs {[tuple(u.shape) for u, _ in seen]}")
    n_flip = int((masks[0] != masks[1]).sum())
    res.update(fwd_err=0.0, bwd_err=0.0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    for end, (inp, flow) in zip(("start", "end"), seen):
        e, n_cancel, n_empty = k3_check(f"SLR K3 forward ({end})", inp, flow)
        g = torch.randn(inp.shape, generator=gen, device=dev)
        eb = k3_bwd_check(f"SLR K3 backward ({end})", inp, flow, g)
        res["fwd_err"] = max(res["fwd_err"], e)
        res["bwd_err"] = max(res["bwd_err"], *eb)
        print(f"phase 17 K3 at the step's {end} rows ({B}, {H}, {W}, {SLR_TRAIN_C}): "
              f"forward max abs {e:.3g} (atol/rtol 1e-5), empty cells match ({n_empty}; "
              f"{n_cancel} elements of reached cells exactly 0 on one side); backward "
              f"max abs grad_inp {eb[0]:.3g}, grad_flow {eb[1]:.3g} (limit 1e-5 of "
              f"each output's max)")
    inp, flow = seen[0]
    del seen, masks
    fwd = k3_fwd_times(dev, f"phase 17 K3 forward ({B}, {H}, {W}, {SLR_TRAIN_C})", inp,
                       flow, reps=20, plain_reps=3)
    g = torch.randn(inp.shape, generator=gen, device=dev)
    bwd = k3_bwd_times(dev, f"phase 17 K3 backward ({B}, {H}, {W}, {SLR_TRAIN_C})", inp,
                       flow, g, plain_reps=3)
    res.update(ms_fwd=fwd["ms"], plain_fwd=fwd["plain_ms"], lib_fwd=fwd["lib_ms"],
               bound_fwd=fwd["bound"], ms_bwd=bwd["ms"], plain_bwd=bwd["plain_ms"],
               bound_bwd=bwd["bound"])
    del inp, flow, g
    print(f"phase 17 fluid alpha mask g[..., -1] > 1e-8: {n_flip} of "
          f"{B * H * W} elements differ between the kernel and the plain forward")

    # K7 on the compact batch's motion, counts and moving sets
    m, pos, val = sparse["motions"], sparse["mov_pos"], sparse["mov_valid"]
    tf_b, tp_b = (torch.from_numpy(a).to(dev)
                  for a in phased_counts(sparse_np["index"], TRAIN_T))
    for label, got, ref in (
            ("dense", euler_integrate_phased(m, tf_b, tp_b, TRAIN_T),
             euler_integrate_phased_plain(m, tf_b, tp_b, TRAIN_T)),
            ("compact", euler_integrate_phased_compact(m, pos, val, tf_b, tp_b, TRAIN_T),
             euler_integrate_phased_compact_plain(m, pos, val, tf_b, tp_b, TRAIN_T))):
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, ref)),
              f"SLR K7 {label}: kernel differs from plain")
    res["k7"] = k7_times(dev, "phase 17", m, pos, val, tf_b, tp_b)

    kernel_vs_plain_steps(17, "SLR", tr, {"dense": batch, "compact": sparse})
    res["peak"] = step_peak(17, "SLR", tr, batch)
    st, k7 = res["stages"], res["k7"]
    k3k7 = k7["ms"] + 2 * res["ms_fwd"] + 2 * res["ms_bwd"]
    print(f"phase 17 SLR step stages with the kernels (dense, B={B}): G forward "
          f"{st['G forward']:.1f} ms, of which K7 {k7['ms']:.3f} ms and K3 forward "
          f"x2 {2 * res['ms_fwd']:.3f} ms; G backward {st['G backward']:.1f} ms, of "
          f"which K3 backward x2 {2 * res['ms_bwd']:.3f} ms; D step "
          f"{st['D step']:.1f} ms; updates {st['updates']:.1f} ms; K3 and K7 "
          f"together {100 * k3k7 / res['step_ms']:.2f} % of the step")
    return res


# ---- the remaining training stages: embedded motion, K7's backward, the --
# ---- motion GAN, bg stage 2 and the CLI chains ---------------------------
#
# The embedded-motion stages on Options() widths (ngf 64) with the shipped
# 8-down SPADE regressor (motion_num_filters 32) and 1.0_EndPointError,
# batch 16, W = 256, T = 60, f32: the regressor's motion is dense, so K7
# runs its dense form and, unfrozen, its backward.


def make_motion_train_batch(rng, B: int, W_: int):
    """``make_train_batch`` plus sparse hints (the motion at ~2 % of the
    pixels), as numpy."""
    batch = make_train_batch(rng, B, W_)
    keep = rng.random((B, W_, W_, 1)) < 0.02
    batch["hints"] = (batch["motions"] * keep).astype(np.float32)
    return batch


def make_bg_batch(rng, B: int, W_: int):
    """Stage 2's batch: two views, counts with middle = end, zero motion and
    a mean video, as numpy."""
    imgs = [(rng.standard_normal((B, W_, W_, 3)) * 0.25).astype(np.float32)
            for _ in range(2)]
    idx = np.zeros((B, 3), np.int32)
    idx[:, 1:] = rng.integers(1, 59, size=(B, 1))
    return {"images": imgs, "index": idx, "motions": np.zeros((B, W_, W_, 2), np.float32),
            "mean_video": (rng.standard_normal((B, W_, W_, 3)) * 0.25).astype(np.float32)}


def make_motion_gan_batch(rng, B: int, W_: int):
    """The motion GAN's batch: one view, the motion and its hints."""
    batch = make_motion_train_batch(rng, B, W_)
    return {"images": batch["images"][:1], "motions": batch["motions"],
            "hints": batch["hints"]}


def timed_steps(phase: int, label: str, tr, batch, want_launches: dict, log_keys=()):
    """One warm-up and 3 timed G+D steps: the launches over the 3, every
    loss finite and each of ``log_keys`` logged, the peak memory of the
    warm-up; printed. Returns {step_ms, host, stages, launches, peak}."""
    import torch

    from slrsfs_tpu_torch import kernels

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    tr.train_step(batch)  # warm-up
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    kernels.reset_counts()
    host, stages, logs = _step_times(tr, batch, 3)
    launches = kernels.counts()
    want = {**{k.name: 0 for k in kernels.KERNELS}, **want_launches}
    check(launches == want, f"{label} launches over 3 steps: {launches}")
    for k in log_keys:
        check(k in logs, f"{label} logs lack {k}: {sorted(logs)}")
    for k, v in logs.items():
        check(bool(torch.isfinite(v)), f"{label} loss {k} = {v}")
    step_ms = float(np.median(host))
    B = batch["images"][0].shape[0]
    print(f"phase {phase} {label}: B={B} {W}^2: {step_ms:.1f} ms/step median = "
          f"{B / step_ms * 1e3:.2f} samples/s (runs {[round(x, 1) for x in host]} ms); "
          f"stages " + ", ".join(f"{k} {v:.1f} ms" for k, v in stages.items())
          + f"; launches over 3 steps { {k: v for k, v in launches.items() if v} }; peak "
          f"{peak / 2**30:.2f} GiB ({(peak - base) / 2**30:.2f} above the resident "
          f"{base / 2**30:.2f}); losses " + ", ".join(f"{k} {v.item():.4f}"
                                                     for k, v in logs.items()))
    return {"step_ms": step_ms, "host": host, "stages": stages, "launches": launches,
            "peak": peak}


def embedded_inputs(tr, batch):
    """The joint step's own K3 and K7 inputs, from one forward (restored
    after): [(packed rows, flow)] of the two splats and (motion, t_f, t_p)
    of the integration."""
    import torch

    from slrsfs_tpu_torch.models import baseline as base_mod

    seen, phased = [], {}
    splat, integ = base_mod.softsplat_sum, base_mod.euler_integrate_phased

    def spy_splat(inp, flow):
        seen.append((inp.detach().clone(), flow.detach().clone()))
        return splat(inp, flow)

    def spy_phased(m, tf, tp, n):
        phased.update(m=m.detach().clone(), tf=tf.clone(), tp=tp.clone())
        return integ(m, tf, tp, n)

    snap = tr.snapshot()
    base_mod.softsplat_sum, base_mod.euler_integrate_phased = spy_splat, spy_phased
    try:
        with torch.no_grad():
            tr.model.forward_train(batch, train=True, deterministic=True)
    finally:
        base_mod.softsplat_sum, base_mod.euler_integrate_phased = splat, integ
        tr.restore(snap)
    return seen, (phased["m"], phased["tf"], phased["tp"])


def embedded_phase(dev):
    """Phase 18: the unfrozen joint step and the fix-motion step at full
    width (``timed_steps``: K3 fwd 6, K3 bwd 6, K7 fwd 3 over 3 steps in
    both, K7 bwd 3 joint and 0 frozen), each kernel step against a plain
    step by sub-network, the regressor's included; on the joint step's own
    inputs K3 forward and backward (C = 65) and K7 dense forward checked
    and timed. Returns the runs and the joint step's K7 inputs."""
    import torch

    from slrsfs_tpu_torch.cli.train import MODEL_TYPE, build, stage_options, to_device_batch
    from slrsfs_tpu_torch.config import Options
    from slrsfs_tpu_torch.ops.euler import euler_integrate_phased, euler_integrate_phased_plain

    res = {}
    for label, frozen in (("joint", False), ("fix-motion", True)):
        opt = Options(W=W, batch_size=TRAIN_B, freeze_motion=frozen,
                      **stage_options(MODEL_TYPE, True))
        _, tr = build(opt, train_max_steps=TRAIN_T, device=dev, seed=SEED)
        check(any(n.startswith("motion_regressor.") for n in tr.g_names) != frozen,
              f"{label}: the regressor in G's Adam = {not frozen} expected")
        batch = to_device_batch(make_motion_train_batch(np.random.default_rng(SEED), TRAIN_B,
                                                        W), dev)
        run = timed_steps(18, f"{label} step (8-down SPADE regressor nf "
                              f"{opt.motion_num_filters}, dense K7, T={TRAIN_T})", tr, batch,
                          {"splat_dense_fwd": 6, "splat_dense_bwd": 6, "euler_phased": 3,
                           "euler_phased_bwd": 0 if frozen else 3},
                          ("EndPointError", "L1", "Perceptual", "GAN"))
        run["path"] = kernel_vs_plain_steps(18, label, tr, {"dense": batch}, own_limit=1e-3)
        if not frozen:
            seen, k7_in = embedded_inputs(tr, batch)
            res["k7_in"] = k7_in
            check(len(seen) == 2 and all(tuple(u.shape) == (TRAIN_B, H, W, TRAIN_C)
                                         for u, _ in seen),
                  f"joint splat inputs {[tuple(u.shape) for u, _ in seen]}")
            gen = torch.Generator(device=dev).manual_seed(SEED + 18)
            run.update(fwd_err=0.0, bwd_err=0.0)
            for end, (inp, flow) in zip(("start", "end"), seen):
                e, n_cancel, n_empty = k3_check(f"joint K3 forward ({end})", inp, flow)
                eb = k3_bwd_check(f"joint K3 backward ({end})", inp, flow,
                                  torch.randn(inp.shape, generator=gen, device=dev))
                run["fwd_err"] = max(run["fwd_err"], e)
                run["bwd_err"] = max(run["bwd_err"], *eb)
                print(f"phase 18 K3 at the joint step's {end} rows ({TRAIN_B}, {H}, {W}, "
                      f"{TRAIN_C}): forward max abs {e:.3g} (atol/rtol 1e-5), empty cells "
                      f"match ({n_empty}; {n_cancel} reached elements exactly 0 on one side); "
                      f"backward max abs grad_inp {eb[0]:.3g}, grad_flow {eb[1]:.3g} (limit "
                      f"1e-5 of each output's max)")
            inp, flow = seen[0]
            del seen
            run["k3_fwd"] = k3_fwd_times(dev, f"phase 18 joint K3 forward ({TRAIN_B}, {H}, "
                                              f"{W}, {TRAIN_C})", inp, flow, reps=20,
                                         plain_reps=3)
            g = torch.randn(inp.shape, generator=gen, device=dev)
            run["k3_bwd"] = k3_bwd_times(dev, f"phase 18 joint K3 backward ({TRAIN_B}, {H}, "
                                              f"{W}, {TRAIN_C})", inp, flow, g, plain_reps=3)
            del inp, flow, g
            m, tf_b, tp_b = k7_in
            got = euler_integrate_phased(m, tf_b, tp_b, TRAIN_T)
            ref = euler_integrate_phased_plain(m, tf_b, tp_b, TRAIN_T)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(got, ref)),
                  "joint K7 forward: kernel differs from plain on the predicted motion")
            t = kernel_times(lambda: euler_integrate_phased(m, tf_b, tp_b, TRAIN_T), reps=20)
            plain_ms = cuda_time(lambda: euler_integrate_phased_plain(m, tf_b, tp_b, TRAIN_T),
                                 reps=3, warmup=1)
            steps = k7_gathers(m, tf_b, tp_b, TRAIN_T)
            bnd = bound(m.numel() * 4 * 3 + TRAIN_B * 8, steps * 20, peak=LANE_OPS)
            run["k7"] = {"t": t, "ms": t["ms"], "plain_ms": plain_ms, "bound": bnd,
                         "err": 0.0}
            print(f"phase 18 joint K7 dense on the predicted motion: bit-exact; "
                  f"{fmt_times(t)}; plain {plain_ms:.2f} ms; bound {bnd[0]:.4f} ms by "
                  f"{bnd[1]} ({steps} gathers of {m.numel() // 2 * TRAIN_T} at most)")
        res[label] = run
        del tr, batch
        gc.collect()
        torch.cuda.empty_cache()
    return res


_SASS_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")


def sass_of(lib: str, function: str) -> list:
    """[(address, opcode, operands)] of the first kernel in the shared
    library ``lib`` whose name contains ``function``, read with the
    toolkit's ``cuobjdump``."""
    from slrsfs_tpu_torch.kernels import nvcc_path

    tool = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    body = next(part for part in sass.split("Function : ")[1:]
                if function in part.split("\n", 1)[0])
    return [(int(a, 16), op, rest) for a, op, rest in _SASS_INSN.findall(body)]


def sass_step_instructions(kernel, function: str):
    """(fewest, most) SASS instructions a step of ``function``'s loops in
    ``kernel``'s build, or None when no loop gathers: a loop is a backward
    branch, its body the instructions from the branch's target to the
    branch, NOPs left out (branches taken now and then included), and a
    step one gather (LDG) in the body (an unrolled body holds several)."""
    kernel.load()
    insns = sass_of(kernel._lib_path(), function)
    per_step = []
    for addr, op, rest in insns:
        target = re.search(r"0x([0-9a-f]+)", rest) if op.startswith("BRA") else None
        if target is None or int(target.group(1), 16) >= addr:
            continue
        loop = [o for a, o, _ in insns if int(target.group(1), 16) <= a <= addr and o != "NOP"]
        n_gather = sum(o.startswith("LDG") for o in loop)
        if n_gather:
            per_step.append(len(loop) / n_gather)
    return (min(per_step), max(per_step)) if per_step else None


# The bound's yardstick for K7's backward: the SASS instructions a step of
# the first design's loop (a thread a row, one global reduction a step,
# unrolled by 4: round, clamp, index, 64-bit addresses, gather, reduction,
# adds; its build's fewest, read by sass_step_instructions). A constant,
# so that a redesign does not move its own bound.
K7_BWD_STEP_INSNS = 19.75
# (tile, margin) of the backward's window whose counts phase 19 prints: the
# kernel's first, then two larger candidates it was chosen over
K7_BWD_WINDOWS = ((32, 16), (32, 32), (64, 48))


def k7_bwd_work(m, tf_b, tp_b, out_f, out_p, T: int) -> int:
    """The reductions the first design of K7's backward issued on these
    inputs (one a step of each valid row whose source moves, one for each
    valid static row, for each phase that latches): the work its bound
    counts."""
    oob = float(max(m.shape[1], m.shape[2]) + 1)
    rest = (m == 0).all(-1).reshape(m.shape[0], -1)
    total = 0
    for b in range(m.shape[0]):
        tf, tp = int(tf_b[b]), int(tp_b[b])
        for steps, latches, out in ((tf, 1 <= tf <= T, out_f),
                                    (tf + tp - max(tf, 0), tp > 0 and 1 <= tf + tp <= T,
                                     out_p)):
            if not latches:
                continue
            valid = out[b].reshape(-1, 2)[:, 0] != oob
            total += int((valid & ~rest[b]).sum()) * steps + int((valid & rest[b]).sum())
    return total


def k7_bwd_counts(label: str, m, tf_b, tp_b) -> dict:
    """The backward's window counts on these inputs
    (``ops/euler.py:phased_bwd_window_counts``) for each of
    ``K7_BWD_WINDOWS``, printed; returns the first's, or {} for a package
    without them (an older tree of ``--k7bwd-in``)."""
    from slrsfs_tpu_torch.ops import euler as E

    if not hasattr(E, "phased_bwd_window_counts"):
        print(f"{label}: window counts: this package's backward has no window")
        return {}
    res = {}
    for tile, margin in K7_BWD_WINDOWS:
        n = E.phased_bwd_window_counts(m, tf_b, tp_b, TRAIN_T, tile, margin)
        red = max(n["reductions"], 1)
        print(f"{label}: window {tile}x{tile} tile, margin {margin}: "
              f"{n['reductions']} reductions, {100 * n['repeats'] / red:.1f} % on the "
              f"previous step's cell; {n['runs']} runs ({100 * n['runs'] / red:.1f} %): "
              f"hits {n['hits']} ({100 * n['hits'] / max(n['runs'], 1):.2f} % of the runs), "
              f"misses {n['misses']} ({100 * n['misses'] / red:.2f} % of the reductions); "
              f"touched cells {n['touched']} ({100 * n['touched'] / red:.2f} %); to device "
              f"memory misses + touched = {n['misses'] + n['touched']} "
              f"({100 * (n['misses'] + n['touched']) / red:.2f} %)")
        res.setdefault("kernel", n)
    return res["kernel"]


def k7_bwd_inputs(dev, k7_in) -> dict:
    """Phase 19's inputs, {label: (motion, t_f, t_p)}: the joint step's own
    predicted motion and counts (``k7_in``), the scene flow at the same
    counts (``k7_timing_inputs``' motion: what a trained regressor
    predicts), ``leaving_flow`` and random motion with a static third,
    t_f = 0 and t_p = 0 samples and t_f + t_p = T."""
    import torch

    T = TRAIN_T
    m, tf_b, tp_b = k7_in
    B = m.shape[0]
    rng = np.random.default_rng(SEED + 19)
    rand = (rng.standard_normal(tuple(m.shape)) * 2.0).astype(np.float32)
    rand[:, : H // 3] = 0.0
    t_f = rng.integers(0, T + 1, size=B).astype(np.int32)
    t_p = (rng.integers(0, T + 1, size=B) % (T - t_f + 1)).astype(np.int32)
    t_f[:3], t_p[:3] = [T, 0, T // 2], [0, T, T - T // 2]
    return {"predicted motion (joint step)": (m, tf_b, tp_b),
            "scene flow": (k7_timing_inputs(dev, synthetic_scene(SEED, H)[1])[0], tf_b, tp_b),
            "leaving flow": (leaving_flow(dev)[None].expand(B, -1, -1, -1).contiguous(),
                             tf_b, tp_b),
            "random, static third, t_f = 0, t_p = 0": (
                torch.from_numpy(rand).to(dev), torch.from_numpy(t_f).to(dev),
                torch.from_numpy(t_p).to(dev))}


def k7_bwd_times(dev, label: str, m, tf_b, tp_b, plain_reps: int = 0) -> dict:
    """K7's backward on (m, t_f, t_p) with seeded random cotangents: timed
    (device, as called, host), the plain autograd (forward and backward,
    ``plain_reps`` > 0), the window counts (``k7_bwd_counts``) and the
    bound: the first design's reductions (``k7_bwd_work``) x
    ``K7_BWD_STEP_INSNS`` at the lane-instruction rate, or the bytes
    (motion, both outputs and cotangents in, the gradient out) at 3.35
    TB/s; printed after ``label``."""
    import torch

    from slrsfs_tpu_torch.ops.euler import (
        euler_integrate_phased,
        euler_integrate_phased_plain,
        euler_phased_bwd,
    )

    T = TRAIN_T
    gen = torch.Generator(device=dev).manual_seed(SEED + 191)
    cf = torch.randn(m.shape, generator=gen, device=dev)
    cp = torch.randn(m.shape, generator=gen, device=dev)
    with torch.no_grad():
        out_f, out_p = euler_integrate_phased(m, tf_b, tp_b, T)
    t = kernel_times(lambda: euler_phased_bwd(m, tf_b, tp_b, out_f, out_p, cf, cp, T), reps=20)

    def plain():
        x = m.clone().requires_grad_(True)
        a, b = euler_integrate_phased_plain(x, tf_b, tp_b, T)
        return torch.autograd.grad((a * cf).sum() + (b * cp).sum(), x)[0]

    plain_ms = cuda_time(plain, reps=plain_reps, warmup=1) if plain_reps else None
    work = k7_bwd_work(m, tf_b, tp_b, out_f, out_p, T)
    n_bytes = m.numel() * 4 * 6
    bnd = bound(n_bytes, work * K7_BWD_STEP_INSNS, peak=LANE_OPS)
    plain_txt = "" if plain_ms is None else (f"; plain autograd (forward and backward) "
                                             f"{plain_ms:.2f} ms")
    print(f"{label}: {fmt_times(t)}{plain_txt}; bound {bnd[0]:.4f} ms by {bnd[1]} "
          f"({100 * bnd[0] / t['ms']:.1f} % of it): bytes {n_bytes} = "
          f"{n_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms at 3.35 TB/s; operations {work} "
          f"reductions of the first design (of {m.numel() // 2 * T} at most) x "
          f"{K7_BWD_STEP_INSNS} SASS instructions a step = "
          f"{work * K7_BWD_STEP_INSNS / LANE_OPS * 1e3:.4f} ms at {LANE_OPS:.3g} "
          f"lane-instructions/s; library: none")
    counts = k7_bwd_counts(label, m, tf_b, tp_b)
    return {"t": t, "ms": t["ms"], "plain_ms": plain_ms, "bound": bnd, "counts": counts}


def k7_bwd_phase(dev, k7_in) -> dict:
    """Phase 19: K7's backward against the plain version's autograd, within
    1e-5 of the gradient's largest magnitude on two launches each, on
    ``k7_bwd_inputs``; the window's geometry in the library against
    ``ops/euler.py``'s; timed (``k7_bwd_times``) on the predicted motion
    (with the plain autograd), the scene flow and the leaving flow, each
    beside its window counts and the bound. Returns the predicted motion's
    times, bound and the largest error."""
    import torch

    from slrsfs_tpu_torch import kernels
    from slrsfs_tpu_torch.ops import euler as E

    T = TRAIN_T
    geometry = (kernels.EULER_PHASED_BWD.query("euler_phased_bwd_tile"),
                kernels.EULER_PHASED_BWD.query("euler_phased_bwd_margin"))
    check(geometry == (E.PHASED_BWD_TILE, E.PHASED_BWD_MARGIN) == K7_BWD_WINDOWS[0],
          f"K7 backward window {geometry} vs ops/euler.py's "
          f"{(E.PHASED_BWD_TILE, E.PHASED_BWD_MARGIN)}")
    cases = k7_bwd_inputs(dev, k7_in)
    gen = torch.Generator(device=dev).manual_seed(SEED + 19)
    err = 0.0
    for label, (mm, tf, tp) in cases.items():
        B = mm.shape[0]
        cf = torch.randn(mm.shape, generator=gen, device=dev)
        cp = torch.randn(mm.shape, generator=gen, device=dev)

        def grad(fn):
            x = mm.clone().requires_grad_(True)
            a, b = fn(x, tf, tp, T)
            return torch.autograd.grad((a * cf).sum() + (b * cp).sum(), x)[0]

        want = grad(E.euler_integrate_phased_plain)
        scale = want.abs().max().item()
        for i in range(2):
            kernels.reset_counts()
            got = grad(E.euler_integrate_phased)
            torch.cuda.synchronize()
            check(kernels.counts()["euler_phased_bwd"] == 1, f"K7 bwd {label}: launches")
            e = (got - want).abs().max().item()
            check(e <= 1e-5 * scale, f"K7 backward {label} launch {i}: max abs {e} vs 1e-5 "
                  f"x {scale}")
            err = max(err, e)
        with torch.no_grad():
            out_f, out_p = E.euler_integrate_phased(mm, tf, tp, T)
        oob = max(H, W) + 1
        static = (mm == 0).all(-1)
        print(f"phase 19 K7 backward {label}: B={B} {H}x{W} T={T}: max abs {e:.3g} of "
              f"{scale:.4g} (limit 1e-5 of the max), two launches; "
              f"{int((out_f[..., 0] == oob).sum()) + int((out_p[..., 0] == oob).sum())} "
              f"latched sentinels (no gradient), {int(static.sum())} static sources"
              + (f" (gradient max {want[static].abs().max().item():.4g}, not 0)"
                 if static.any() else ""))
        del want, got
    res = {}
    for label in ("predicted motion (joint step)", "scene flow", "leaving flow"):
        res[label] = k7_bwd_times(dev, f"phase 19 K7 backward timed, {label}", *cases[label],
                                  plain_reps=3 if not res else 0)
    steps = sass_step_instructions(kernels.EULER_PHASED_BWD, "euler_phased_bwd_kernel")
    print("phase 19 K7 backward, this build's SASS a step (information only; the bound "
          f"counts {K7_BWD_STEP_INSNS}): "
          + ("no loop with a gather" if steps is None else
             f"{steps[0]:.4g} to {steps[1]:.4g} instructions a gather in its loops"))
    return {**res["predicted motion (joint step)"], "err": err}


def k7bwd_in(tree: str) -> int:
    """``python3 chip_smoke.py --k7bwd-in TREE``: on the package of another
    unpacked tree of this repository, K7's backward (``k7_bwd_times``:
    device, as called and host times, the window counts, the bound) on the
    unfrozen joint step's predicted motion (phase 18's trainer and batch),
    the scene flow and the leaving flow, and the joint step (median of 3),
    to compare commits on one card (slrsfs_tpu_torch/tools/compare.sh
    k7bwd)."""
    import torch

    dev = use_tree(tree)
    from slrsfs_tpu_torch.cli.train import MODEL_TYPE, build, stage_options, to_device_batch
    from slrsfs_tpu_torch.config import Options

    opt = Options(W=W, batch_size=TRAIN_B, freeze_motion=False,
                  **stage_options(MODEL_TYPE, True))
    _, tr = build(opt, train_max_steps=TRAIN_T, device=dev, seed=SEED)
    batch = to_device_batch(make_motion_train_batch(np.random.default_rng(SEED), TRAIN_B, W),
                            dev)
    # the motion of the seeded weights, before any step moves them
    _, k7_in = embedded_inputs(tr, batch)
    timed_steps(18, "k7bwd joint step", tr, batch,
                {"splat_dense_fwd": 6, "splat_dense_bwd": 6, "euler_phased": 3,
                 "euler_phased_bwd": 3})
    del tr, batch
    gc.collect()
    torch.cuda.empty_cache()
    cases = k7_bwd_inputs(dev, k7_in)
    for label in ("predicted motion (joint step)", "scene flow", "leaving flow"):
        k7_bwd_times(dev, f"k7bwd {label}", *cases[label])
    return 0


def other_stages_phase(dev) -> dict:
    """Phase 20: the bg stage-2 step (``BackgroundModel``, task 'bg', MVloss
    1) and the motion-GAN step (the 8-down SPADE regressor, task 'motion',
    10.0_EndPointError, a 2-channel D) at B = 16, 256²: ``timed_steps``
    (no kernel launches: neither integrates nor splats)."""
    import torch

    from slrsfs_tpu_torch.cli.train import build, stage_options, to_device_batch
    from slrsfs_tpu_torch.config import Options

    res = {}
    for label, mt, make, keys in (
            ("bg stage-2 step", "bg", make_bg_batch, ("L1_bg", "Perceptual_bg", "GAN")),
            ("motion-GAN step", "SPADE_unet_mask_motion", make_motion_gan_batch,
             ("EndPointError", "PSNR_motion", "GAN"))):
        opt = Options(W=W, batch_size=TRAIN_B, model_type=mt, **stage_options(mt))
        _, tr = build(opt, train_max_steps=TRAIN_T, device=dev, seed=SEED)
        batch = to_device_batch(make(np.random.default_rng(SEED), TRAIN_B, W), dev)
        res[mt] = timed_steps(20, label, tr, batch, {}, keys)
        del tr, batch
        gc.collect()
        torch.cuda.empty_cache()
    return res


def run_train_cli(label: str, root: str, out: str, *args, n_steps: int = 2) -> tuple:
    """``python -m slrsfs_tpu_torch.cli.train`` (W = 256, batch 2, ``n_steps``
    steps (``--steps-per-epoch``), 1 validation step): (checkpoint, stdout,
    seconds, the last train row)."""
    import shutil

    shutil.rmtree(out, ignore_errors=True)
    cmd = [sys.executable, "-m", "slrsfs_tpu_torch.cli.train", "--data-root", root,
           "--out", out, "--batch-size", "2", "--W", str(W), "--niter", "1",
           "--niter-decay", "0", "--steps-per-epoch", str(n_steps), "--val-steps", "1",
           "--seed", str(SEED), *args]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    secs = time.perf_counter() - t0
    check(proc.returncode == 0, f"{label} CLI failed:\n{proc.stdout}\n{proc.stderr}")
    ckpt = os.path.join(out, "checkpoint.pth")
    check(os.path.exists(ckpt), f"{label} CLI wrote no checkpoint")
    with open(os.path.join(out, "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    steps = [r for r in rows if r["split"] == "train"]
    check(len(steps) == n_steps, f"{label} CLI logged {len(steps)} steps")
    for r in rows:
        check(all(np.isfinite(v) for k, v in r.items() if k != "split"),
              f"{label} CLI log not finite: {r}")
    return ckpt, proc.stdout, secs, steps[-1]


def stage_chains_phase(scene_dir: str, img_path: str, flow_path: str) -> dict:
    """Phase 21: the CLI chains at 256² (the 8-down regressor's smallest
    input), full width, batch 2, two steps each (the joint run four, its
    rate above 0 after the restored Adam count): the motion GAN → the
    fix-motion finetune (``--init-from`` a stage-1 run, ``--init-motion-from``
    the motion GAN's, ``--freeze-motion``; its regressor the motion GAN's)
    → the unfrozen joint stage from the fix-motion checkpoint (its regressor
    moved) → ``SceneRenderer`` with the joint checkpoint as ``--ckpt`` and
    ``--motion-ckpt``; stage 1 → bg stage 2 → SLR stage 3 with
    ``--init-bg-from`` the port's own stage-2 checkpoint."""
    import torch

    from slrsfs_tpu_torch import kernels
    from slrsfs_tpu_torch.cli.render import SceneRenderer

    root = os.path.join(OUT_DIR, "train_data")
    out = lambda name: os.path.join(OUT_DIR, f"chain_{name}")  # noqa: E731
    runs = {}
    runs["motion GAN"] = run_train_cli("motion GAN", root, out("motion"), "--model-type",
                                       "SPADE_unet_mask_motion")
    runs["stage 1"] = run_train_cli("stage 1", root, out("s1"))
    runs["fix-motion"] = run_train_cli(
        "fix-motion", root, out("fix"), "--embed-motion", "--freeze-motion", "--init-from",
        runs["stage 1"][0], "--init-motion-from", runs["motion GAN"][0])
    check("motion regressor loaded" in runs["fix-motion"][1],
          f"fix-motion warm start: {runs['fix-motion'][1]}")
    # --init-from restores the fix-motion run's Adam states and count (4
    # steps: stage 1's 2 and its own 2), which with one epoch of 2 steps
    # and no decay would start the joint run at a rate of 0; 4 steps an
    # epoch keep it above 0
    runs["joint"] = run_train_cli("joint", root, out("joint"), "--embed-motion",
                                  "--init-from", runs["fix-motion"][0], n_steps=4)
    runs["bg stage 2"] = run_train_cli("bg stage 2", root, out("bg"), "--model-type", "bg")
    runs["SLR stage 3"] = run_train_cli(
        "SLR stage 3", root, out("s3"), "--model-type", SLR_OPTS["model_type"], "--init-from",
        runs["stage 1"][0], "--init-bg-from", runs["bg stage 2"][0])
    check("kept at init: ['net_alpha_encoder', 'net_alpha_decoder']" in runs["SLR stage 3"][1],
          f"stage-3 warm start: {runs['SLR stage 3'][1]}")

    def sd(name):
        return torch.load(runs[name][0], map_location="cpu", weights_only=False)["state_dict"]

    gan = {k[len("model.module."):]: v for k, v in sd("motion GAN").items()
           if k.startswith("model.module.motion_predictor.")}
    head = "model.module.motion_regressor."
    fix = {k[len(head):]: v for k, v in sd("fix-motion").items() if k.startswith(head)}
    joint = {k[len(head):]: v for k, v in sd("joint").items() if k.startswith(head)}
    params = [k for k in gan if not k.endswith(("weight_u", "weight_v"))]
    check(params and all(torch.equal(fix[k], gan[k]) for k in params),
          "the fix-motion regressor is not the motion GAN's")
    check(any(not torch.equal(joint[k], fix[k]) for k in params),
          "the joint stage's regressor did not train")
    r = SceneRenderer(ckpt=runs["joint"][0], motion_ckpt=runs["joint"][0], W=W, n_frames=8,
                      crop_decode="off")
    kernels.reset_counts()
    out_dir, frames = render_capture(r, img_path, flow_path,
                                     os.path.join(scene_dir, "trained_joint"), name="synthetic")
    torch.cuda.synchronize()
    launches = kernels.counts()
    check(launches["euler_compact_dual"] == 1 and launches["splat_dual_normalize"] == 8,
          f"joint render launches {launches}")
    check(tuple(frames.shape) == (8, W, W, 3) and bool(torch.isfinite(frames).all()),
          f"joint render frames {frames.shape}")
    pngs = sorted(os.listdir(os.path.join(out_dir, "PredImg")))
    check(len(pngs) == 8, f"joint render wrote {len(pngs)} PNGs")
    print("phase 21 CLI chains (W=256, batch 2, 2 steps (the joint run 4) + validation + "
          "checkpoint each): "
          + "; ".join(f"{k} {v[2]:.1f} s (Total Loss {v[3]['Total Loss']:.4f})"
                      for k, v in runs.items())
          + f"; fix-motion regressor = motion GAN's; joint regressor trained; SceneRenderer "
          f"with --motion-ckpt = the joint checkpoint: launches "
          f"{ {k: v for k, v in launches.items() if v} }, 8 PNGs, frame range "
          f"[{frames.min().item():.3f}, {frames.max().item():.3f}]; stage 3 from the port's "
          "own stage-2 checkpoint")
    return {k: v[2] for k, v in runs.items()}


# ---- phase 23: the rest of training --------------------------------------
#
# K3's bf16 mode on a bf16 step's own rows, the bf16 stage-1 and SLR steps,
# accumulation, the motion GAN with the origin D, the style loss with the
# free-form mask, and the resume, preemption and HALT chain of the CLI.


def dense_tap_counts(flow):
    """(B, H, W, 1) float32: the corner taps with a nonzero weight that each
    cell of each sample receives from the dense splat by ``flow``."""
    import torch

    from slrsfs_tpu_torch.ops.splat import _corner_taps

    B, H_, W_, _ = flow.shape
    n = torch.zeros((B, H_ * W_), dtype=torch.float32, device=flow.device)
    xs = torch.arange(W_, dtype=torch.float32, device=flow.device)[None, :]
    ys = torch.arange(H_, dtype=torch.float32, device=flow.device)[:, None]
    for b in range(B):
        for lin, w in _corner_taps((xs + flow[b, ..., 0]).reshape(-1),
                                   (ys + flow[b, ..., 1]).reshape(-1), H_, W_):
            n[b].index_add_(0, lin, (w != 0).float())
    return n.reshape(B, H_, W_, 1)


def bf16_splat_inputs(tr, batch, module):
    """The packed bf16 rows and f32 flows of the two splats of one bf16
    forward of ``tr`` (``module``: the model's module, whose
    ``softsplat_sum`` is spied on), from a snapshot restored after."""
    import torch

    seen = []
    kernel_splat = module.softsplat_sum

    def spy(inp, flow):
        seen.append((inp.detach().clone(), flow.detach().clone()))
        return kernel_splat(inp, flow)

    snap = tr.snapshot()
    module.softsplat_sum = spy
    try:
        with torch.no_grad():
            tr.forward_train(batch)
    finally:
        module.softsplat_sum = kernel_splat
        tr.restore(snap)
    return seen


def bf16_step_options(slr: bool):
    """(label, options of a batch size, batch maker, model module) of phase
    23's bf16 stage-1 or SLR stage-3 step."""
    from slrsfs_tpu_torch.cli.train import stage_options
    from slrsfs_tpu_torch.config import Options
    from slrsfs_tpu_torch.models import baseline as base_mod
    from slrsfs_tpu_torch.models import slr as slr_mod

    if not slr:
        return (f"stage 1, C={TRAIN_C}",
                lambda B: Options(W=W, batch_size=B, train_compute_dtype="bfloat16"),
                make_train_batch, base_mod)
    slr_type = SLR_OPTS["model_type"]
    return (f"SLR stage 3, C={SLR_TRAIN_C}",
            lambda B: Options(W=W, batch_size=B, model_type=slr_type,
                              train_compute_dtype="bfloat16", **stage_options(slr_type)),
            make_slr_batch, slr_mod)


def bf16_step_rows(dev) -> dict:
    """{label: (bf16 rows, f32 flow)} of the first splat of phase 23's bf16
    stage-1 and SLR stage-3 steps at B = 16, 256², each trainer built from
    the seed as phase 23 builds it and dropped after one forward."""
    import torch

    from slrsfs_tpu_torch.cli.train import build, to_device_batch

    rows = {}
    for slr in (False, True):
        label, options, make_batch, module = bf16_step_options(slr)
        _, tr = build(options(TRAIN_B), train_max_steps=TRAIN_T, device=dev, seed=SEED)
        batch = to_device_batch(make_batch(np.random.default_rng(SEED), TRAIN_B, W), dev)
        rows[label] = bf16_splat_inputs(tr, batch, module)[0]
        del tr, batch
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def k3_bf16_check(dev, label: str, inp, flow) -> dict:
    """K3's bf16 forward and backward on one splat's rows against the plain
    versions: the forward within the per-cell bf16 bound of the f32 sums of
    the same rows (``bf16_cell_bound`` with n + 4 roundings a term: the
    plain version's weight, product, quarter adds and the combine's three;
    the window kernel's terms pass at most n + 1, its entry's and the
    cell's adds), cells whose terms are all 0 exactly 0; the backward's
    grad_inp bit for bit the plain version's (both sum the four corners in
    f32 in the order NW, NE, SW, SE and round once: the count of elements
    that differ must be 0) and grad_flow within 1e-5 of its max. Returns
    the errors and the cotangent ``g`` the backward was given."""
    import torch

    from slrsfs_tpu_torch.ops.splat import (
        softsplat_sum_bwd_bf16_kernel,
        softsplat_sum_fwd_bf16_kernel,
        softsplat_sum_grad_plain,
        softsplat_sum_plain,
    )

    out = softsplat_sum_fwd_bf16_kernel(inp, flow)
    plain = softsplat_sum_plain(inp, flow)
    ref32 = softsplat_sum_plain(inp.float(), flow)
    abs_terms = softsplat_sum_plain(inp.float().abs(), flow)
    bnd = bf16_cell_bound(ref32, abs_terms, dense_tap_counts(flow) + 2.0)
    torch.cuda.synchronize()
    cell = bf16_cell_check(f"{label} K3 bf16 forward", out, plain, ref32, bnd)
    empty = bnd == 0
    check(bool((out.float()[empty] == 0).all()), f"{label} K3 bf16: an empty cell is not 0")
    no_terms = abs_terms == 0
    n_no_terms = int(no_terms.sum())
    check(bool((out.float()[no_terms] == 0).all()),
          f"{label} K3 bf16: an element whose terms are all 0 is not 0")
    f32_err = (out.float() - ref32).abs().max().item()
    fwd_err = (out.float() - plain.float()).abs().max().item()
    del out, plain, ref32, abs_terms, bnd, empty, no_terms
    gen = torch.Generator(device=dev).manual_seed(SEED + 23)
    g = torch.randn(inp.shape, generator=gen, device=dev).to(torch.bfloat16)
    gi, gf = softsplat_sum_bwd_bf16_kernel(inp, flow, g)
    wi, wf = softsplat_sum_grad_plain(inp, flow, g)
    torch.cuda.synchronize()
    d_i = (gi.float() - wi.float()).abs()
    n_diff = int((gi != wi).sum())
    check(bool((d_i <= 2.0 ** -7 * wi.float().abs()).all()),
          f"{label} K3 bf16 backward grad_inp beyond one bf16 ulp at "
          f"{int((d_i > 2.0 ** -7 * wi.float().abs()).sum())} elements")
    check(n_diff == 0, f"{label} K3 bf16 backward grad_inp differs from the plain version's "
          f"at {n_diff} elements")
    scale = wf.abs().max().item()
    d_f = (gf - wf).abs().max().item()
    check(d_f <= 1e-5 * scale, f"{label} K3 bf16 backward grad_flow {d_f} vs 1e-5 x {scale}")
    bwd_err = max(d_i.max().item(), d_f)
    print(f"{label} K3 bf16 {tuple(inp.shape)}: forward (each term's n counted "
          f"as n + 2, the plain version's weight's and combine's roundings) {fmt_bf16(cell)}, "
          f"max abs {f32_err:.3g} from the f32 sums, {fwd_err:.3g} from the plain version, "
          f"{n_no_terms} elements without a nonzero term all 0; backward grad_inp {n_diff} "
          f"elements differ from the plain version (limit 0), grad_flow max abs {d_f:.3g} "
          f"(limit 1e-5 x {scale:.3g})")
    return {"fwd_err": fwd_err, "bwd_err": bwd_err, "grad_inp_diff": n_diff, "g": g}


def k3_bf16_times(dev, label: str, inp, flow, g, plain: bool = True) -> dict:
    """K3's bf16 forward and backward on one splat's rows timed
    (``kernel_times``), each split by ``launch_split`` (the forward: the
    output's zeroing and the scatter), beside its bound (bf16 rows and
    outputs, f32 flows), one bf16 ``index_add_`` of the 4·B·HW rows (the
    forward's library call), the window misses, and (``plain``) the plain
    versions."""
    import torch

    from slrsfs_tpu_torch.ops.splat import (
        _corner_taps,
        softsplat_sum_bwd_bf16_kernel,
        softsplat_sum_fwd_bf16_kernel,
        softsplat_sum_grad_plain,
        softsplat_sum_plain,
    )

    B, H_, W_, C = inp.shape
    t_fwd = kernel_times(lambda: softsplat_sum_fwd_bf16_kernel(inp, flow), reps=10)
    split = launch_split(lambda: softsplat_sum_fwd_bf16_kernel(inp, flow), reps=4)
    t_bwd = kernel_times(lambda: softsplat_sum_bwd_bf16_kernel(inp, flow, g), reps=10)
    split_bwd = launch_split(lambda: softsplat_sum_bwd_bf16_kernel(inp, flow, g), reps=4)
    plain_fwd = plain_bwd = None
    if plain:
        plain_fwd = cuda_time(lambda: softsplat_sum_plain(inp, flow), reps=2, warmup=1)
        plain_bwd = cuda_time(lambda: softsplat_sum_grad_plain(inp, flow, g), reps=2, warmup=1)
    xs = torch.arange(W_, device=dev, dtype=torch.float32)[None, :]
    ys = torch.arange(H_, device=dev, dtype=torch.float32)[:, None]
    lins, rows = [], []
    for b in range(B):
        for lin, w in _corner_taps((xs + flow[b, ..., 0]).reshape(-1),
                                   (ys + flow[b, ..., 1]).reshape(-1), H_, W_):
            lins.append(lin + b * H_ * W_)
            rows.append(inp[b].reshape(H_ * W_, C) * w.to(torch.bfloat16)[:, None])
    lin_all, rows_all = torch.cat(lins), torch.cat(rows)
    del lins, rows
    acc = torch.zeros((B * H_ * W_, C), device=dev, dtype=torch.bfloat16)
    t_lib = kernel_times(lambda: acc.index_add_(0, lin_all, rows_all), reps=10)
    del lin_all, rows_all, acc
    n = B * H_ * W_
    # bf16 rows in and out, the f32 flow in; per pixel ~20 ops of corner
    # math and per channel 4 multiplies and 4 adds (the backward: inp and g
    # in, grad_inp out in bf16, flow in and grad_flow out in f32, 2
    # multiply-adds per channel and corner)
    b_fwd = bound(n * C * 2 * 2 + n * 8, n * (8 * C + 20))
    b_bwd = bound(n * C * 2 * 3 + n * 8 * 2, n * (16 * C + 40))
    plain_f = "not timed" if plain_fwd is None else f"{plain_fwd:.3f} ms"
    plain_b = "not timed" if plain_bwd is None else f"{plain_bwd:.3f} ms"
    print(f"{label} K3 bf16 forward {tuple(inp.shape)}: {fmt_times(t_fwd)}; plain {plain_f}; "
          f"index_add_ {fmt_times(t_lib)}; bound {b_fwd[0]:.4f} ms by {b_fwd[1]} "
          f"({100.0 * b_fwd[0] / t_fwd['ms']:.1f} %); per call on the card (torch.profiler): "
          f"{fmt_split(split)}; {window_misses('dense bf16', flow)}")
    print(f"{label} K3 bf16 backward {tuple(inp.shape)}: {fmt_times(t_bwd)}; plain {plain_b}; "
          f"bound {b_bwd[0]:.4f} ms by {b_bwd[1]} ({100.0 * b_bwd[0] / t_bwd['ms']:.1f} %); "
          f"per call on the card: {fmt_split(split_bwd)}; "
          f"{window_misses('dense bf16 bwd', flow, C)}")
    return {"fwd": t_fwd, "bwd": t_bwd, "plain_fwd": plain_fwd, "plain_bwd": plain_bwd,
            "lib_fwd": t_lib["ms"], "bound_fwd": b_fwd, "bound_bwd": b_bwd}


def k3_bf16_case(dev, label: str, inp, flow) -> dict:
    """``k3_bf16_check`` and ``k3_bf16_times`` on one splat's rows."""
    res = k3_bf16_check(dev, f"phase 23 {label}", inp, flow)
    res.update(k3_bf16_times(dev, f"phase 23 {label}", inp, flow, res.pop("g")))
    return res


def f32_state_check(label: str, tr) -> None:
    """Every persistent tensor of a bf16-compute trainer is float32."""
    import torch

    for module in (tr.model, tr.d_model):
        for k, v in module.state_dict().items():
            check(not v.is_floating_point() or v.dtype == torch.float32,
                  f"{label}: {k} is {v.dtype}")
    for adam in (tr.opt_g, tr.opt_d):
        for t in adam.mu + adam.nu:
            check(t.dtype == torch.float32, f"{label}: an Adam state is {t.dtype}")


def bf16_step_case(dev, label: str, options, make_batch, module, k3_label: str) -> dict:
    """A bf16 step of ``options`` at B = 16, 256²: its splats' rows through
    ``k3_bf16_case``; one bf16 and one f32 step from one snapshot (L1 and
    Total within JAX's own check, 0.12·|f32| + 0.05); then ``timed_steps``
    (6 K3 bf16 forward and backward, 3 K7 launches over 3 steps) and every
    persistent tensor float32. The bf16-f32 comparison runs with zero BN
    noise."""
    import torch

    from slrsfs_tpu_torch.cli.train import build, to_device_batch

    opt = options(TRAIN_B)
    _, tr = build(opt, train_max_steps=TRAIN_T, device=dev, seed=SEED)
    batch = to_device_batch(make_batch(np.random.default_rng(SEED), TRAIN_B, W), dev)
    seen = bf16_splat_inputs(tr, batch, module)
    check(len(seen) == 2 and all(u.dtype == torch.bfloat16 and f.dtype == torch.float32
                                 for u, f in seen),
          f"{label}: splat inputs {[(u.dtype, f.dtype) for u, f in seen]}")
    k3 = k3_bf16_case(dev, k3_label, *seen[0])
    del seen
    # zero BN noise for the comparison, as the CPU parity tests run: with
    # random weights the drawn noise makes the outputs chaotic enough that
    # its bf16 rounding alone moves the losses
    snap = tr.snapshot()
    tr.deterministic = True
    logs16 = tr.train_step(batch)
    tr.restore(snap)
    tr.compute_dtype = torch.float32
    logs32 = tr.train_step(batch)
    tr.compute_dtype = torch.bfloat16
    tr.deterministic = False
    tr.restore(snap)
    del snap
    for k in ("L1", "Total Loss"):
        a, b = logs16[k].item(), logs32[k].item()
        check(abs(a - b) <= 0.12 * abs(b) + 0.05, f"{label} {k}: bf16 {a} vs f32 {b}")
    run = timed_steps(23, label, tr, batch, {"splat_dense_fwd_bf16": 6,
                                             "splat_dense_bwd_bf16": 6, "euler_phased": 3})
    f32_state_check(label, tr)
    print(f"phase 23 {label}: every parameter, statistic, vector and Adam state float32; "
          f"L1 bf16 {logs16['L1'].item():.5f} vs f32 {logs32['L1'].item():.5f}, Total "
          f"{logs16['Total Loss'].item():.4f} vs {logs32['Total Loss'].item():.4f} (limit "
          f"0.12·|f32| + 0.05)")
    del tr, batch
    gc.collect()
    torch.cuda.empty_cache()
    return {**run, "k3": k3}


def accumulation_case(dev) -> dict:
    """One stage-1 step over two micro-batches of 16 in each scale from one
    snapshot. The reference-scale step replays the mean step's micro-batch
    gradients (``Trainer._micro_step``), so that the accumulation, the scale
    and Adam run anew on the same sums: with b1 = 0 Adam's first moment
    under 'reference' is then 4x the one under 'mean' within 1e-5 of its
    largest entry. An independent reference step is timed too; its
    distance from 4x the mean step's moment is printed, not held: the K3
    forward's atomics add in another order each run, and the losses' kinks
    carry that into the gradients. Returns the two steps' ms."""
    import torch

    from slrsfs_tpu_torch.cli.train import build, to_device_batch
    from slrsfs_tpu_torch.config import Options

    opt = Options(W=W, batch_size=TRAIN_B, num_accumulations=2)
    _, tr = build(opt, train_max_steps=TRAIN_T, device=dev, seed=SEED)
    micro = [to_device_batch(make_train_batch(np.random.default_rng(SEED + s), TRAIN_B, W),
                             dev) for s in (0, 1)]
    snap = tr.snapshot()
    cached, ms = [], {}

    def record(*a, **k):
        cached.append(type(tr)._micro_step(tr, *a, **k))
        return cached[-1]

    def step(scale, micro_step=None):
        tr.opt = tr.opt.replace(accum_scale=scale)
        if micro_step is not None:
            tr._micro_step = micro_step
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logs = tr.train_step(micro)
        torch.cuda.synchronize()
        secs = (time.perf_counter() - t0) * 1e3
        if micro_step is not None:
            del tr._micro_step
        check(tr.step_count == 1, f"accumulation: {tr.step_count} Adam steps")
        for k, v in logs.items():
            check(bool(torch.isfinite(v)), f"accumulation {scale}: {k} = {v}")
        mu = [m.clone() for m in tr.opt_g.mu + tr.opt_d.mu]
        tr.restore(snap)
        return mu, secs

    mu_mean, ms["mean"] = step("mean", record)
    replay = iter(cached)
    mu_ref, _ = step("reference", lambda *a, **k: next(replay))
    mu_ind, ms["reference"] = step("reference")
    del snap, cached

    def rel(a):
        big = max(x.abs().max().item() for x in a)
        return max((x - 4.0 * m).abs().max().item() for x, m in zip(a, mu_mean)) / big

    err, err_ind = rel(mu_ref), rel(mu_ind)
    check(err <= 1e-5, f"accumulation: reference moment vs 4 x mean {err:.3g} relative")
    print(f"phase 23 accumulation (stage 1, two micro-batches of {TRAIN_B}, one Adam step): "
          f"mean {ms['mean']:.1f} ms, reference {ms['reference']:.1f} ms (first calls); "
          f"Adam's first moment under reference = 4 x mean within {err:.3g} of its largest "
          f"entry on the same micro-batch gradients (limit 1e-5); {err_ind:.3g} in an "
          f"independent reference step (K3's atomic order; not held)")
    del tr, micro, mu_mean, mu_ref, mu_ind
    gc.collect()
    torch.cuda.empty_cache()
    return {"ms": ms}


def origin_and_style_case(dev) -> dict:
    """The motion-GAN step with the pix2pixHD origin D (GAN_Feat 0, no
    kernel launches) and a stage-1 step with the style loss and the
    free-form mask (6 K3 and 3 K7 launches over 3 steps), each timed."""
    import torch

    from slrsfs_tpu_torch.cli.train import build, stage_options, to_device_batch
    from slrsfs_tpu_torch.config import Options
    from slrsfs_tpu_torch.data.augment import ff_keep_mask
    from slrsfs_tpu_torch.nn.pix2pixhd import OriginMultiscaleDiscriminator

    res = {}
    mt = "SPADE_unet_mask_motion"
    opt = Options(W=W, batch_size=TRAIN_B, model_type=mt, discriminator_losses="pix2pixHDorigin",
                  **stage_options(mt))
    _, tr = build(opt, train_max_steps=TRAIN_T, device=dev, seed=SEED)
    check(isinstance(tr.d_model, OriginMultiscaleDiscriminator), "the origin D was not built")
    batch = to_device_batch(make_motion_gan_batch(np.random.default_rng(SEED), TRAIN_B, W), dev)
    logs = tr.train_step(batch)
    check(logs["GAN_Feat"].item() == 0.0, f"origin D: GAN_Feat {logs['GAN_Feat'].item()}")
    res["origin"] = timed_steps(23, "motion-GAN step, pix2pixHDorigin D", tr, batch, {},
                                ("EndPointError", "GAN", "GAN_Feat"))
    del tr, batch
    gc.collect()
    torch.cuda.empty_cache()
    opt = Options(W=W, batch_size=TRAIN_B, losses=("1.0_l1", "10.0_content", "1.0_style"),
                  random_ff_mask=True)
    _, tr = build(opt, train_max_steps=TRAIN_T, device=dev, seed=SEED)
    nb = make_train_batch(np.random.default_rng(SEED), TRAIN_B, W)
    nb["ff_mask"] = np.stack([ff_keep_mask(np.random.default_rng(SEED + b), W, W, rate=1.0)
                              for b in range(TRAIN_B)]).astype(np.float32)
    holes = float((nb["ff_mask"] == 0).mean())
    batch = to_device_batch(nb, dev)
    res["style"] = timed_steps(23, "stage-1 step, style loss and ff mask", tr, batch,
                               {"splat_dense_fwd": 6, "splat_dense_bwd": 6, "euler_phased": 3},
                               ("Style", "Perceptual", "L1"))
    print(f"phase 23 origin D: GAN_Feat 0; ff mask holes {100 * holes:.1f} % of the pixels")
    del tr, batch
    gc.collect()
    torch.cuda.empty_cache()
    return res


def train_cli_rows(out: str) -> list:
    with open(os.path.join(out, "scalars.jsonl")) as f:
        return [json.loads(line) for line in f]


def resume_chain_case(dev, root: str) -> dict:
    """The CLI at 256², full width, batch 2: a run sent SIGUSR1 after its
    second step saves at epoch - 1 and exits; its resume file loads into a
    trainer on the card bit for bit; ``--resume`` continues at the saved
    step + 1 and writes HALT; a re-run returns at once; ``--init-from`` the
    finished checkpoint restores the count and both Adam states bit for
    bit (in process, then through the CLI)."""
    import shutil

    import torch

    from slrsfs_tpu_torch.cli import train as cli_train
    from slrsfs_tpu_torch.config import Options

    out = os.path.join(OUT_DIR, "resume_run")
    shutil.rmtree(out, ignore_errors=True)
    base = [sys.executable, "-m", "slrsfs_tpu_torch.cli.train", "--data-root", root,
            "--out", out, "--batch-size", "2", "--W", str(W), "--niter", "1",
            "--niter-decay", "0", "--val-steps", "1", "--seed", str(SEED)]
    cwd = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if k != "SLURM_JOB_ID"}
    t0 = time.perf_counter()
    proc = subprocess.Popen(base + ["--steps-per-epoch", "200"], cwd=cwd, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    log = os.path.join(out, "scalars.jsonl")
    sent = False
    while time.perf_counter() - t0 < 300 and proc.poll() is None:
        if os.path.exists(log) and len(train_cli_rows(out)) >= 2:
            proc.send_signal(signal.SIGUSR1)
            sent = True
            break
        time.sleep(0.1)
    text, _ = proc.communicate(timeout=300)
    secs_pre = time.perf_counter() - t0
    check(sent and proc.returncode == 0 and "preemption signal received" in text,
          f"SIGUSR1 run: sent {sent}, rc {proc.returncode}:\n{text}")
    ckpt_path = os.path.join(out, "checkpoint.pth")
    saved = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    n_rows = len(train_cli_rows(out))
    check(saved["epoch"] == -1 and saved["step"] == n_rows and n_rows < 200,
          f"preempted save: epoch {saved['epoch']}, step {saved['step']}, {n_rows} rows")
    check(not os.path.exists(os.path.join(out, "HALT")), "a preempted run wrote HALT")

    with open(os.path.join(out, "options.json")) as f:
        opt = Options.from_json(f.read())
    model, tr = cli_train.build(opt, device=dev, seed=SEED + 9)
    meta = cli_train.load_resume(ckpt_path, model, tr)
    sd = saved["state_dict"]
    same = all(torch.equal(v.cpu(), sd[f"model.module.{k}"])
               for k, v in model.state_dict().items())
    same &= all(torch.equal(v.cpu(), sd[f"netD.netD.{k}"])
                for k, v in tr.d_model.state_dict().items())
    for key, adam in (("optimizerG", tr.opt_g), ("optimizerD", tr.opt_d)):
        st = saved[key]["state"]
        same &= all(torch.equal(m.cpu(), st[i]["exp_avg"]) and torch.equal(v.cpu(),
                                                                           st[i]["exp_avg_sq"])
                    for i, (m, v) in enumerate(zip(adam.mu, adam.nu)))
    check(same and meta["epoch"] == -1 and tr.step_count == saved["step"],
          "the resume file did not load bit for bit")
    del model, tr
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    proc = subprocess.run(base + ["--steps-per-epoch", "2", "--resume"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)
    secs_resume = time.perf_counter() - t0
    check(proc.returncode == 0 and "resumed from epoch -1" in proc.stdout,
          f"--resume run: rc {proc.returncode}:\n{proc.stdout}\n{proc.stderr}")
    rows = train_cli_rows(out)[n_rows:]
    steps = [r["step"] for r in rows if r["split"] == "train"]
    check(steps == [saved["step"] + 1, saved["step"] + 2] and rows[-1]["split"] == "val"
          and all(r["epoch"] == 0 for r in rows), f"resumed rows {rows}")
    check(os.path.exists(os.path.join(out, "HALT")), "the finished run wrote no HALT")
    check(os.path.exists(os.path.join(out, "checkpoint_best.pth"))
          and os.path.exists(os.path.join(out, "images", "epoch0000_PredImg.png")),
          "no best checkpoint or validation images")
    n_done = len(train_cli_rows(out))
    t0 = time.perf_counter()
    proc = subprocess.run(base + ["--steps-per-epoch", "2", "--resume"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)
    secs_halt = time.perf_counter() - t0
    check(proc.returncode == 0 and "HALT marker present" in proc.stdout
          and len(train_cli_rows(out)) == n_done, f"HALT re-run:\n{proc.stdout}")

    final = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    model, tr = cli_train.build(opt, device=dev, seed=SEED + 9)
    cli_train.warm_start(model, tr, ckpt_path)
    st = final["optimizerG"]["state"]
    same = tr.step_count == final["step"] and all(
        torch.equal(m.cpu(), st[i]["exp_avg"]) and torch.equal(v.cpu(), st[i]["exp_avg_sq"])
        for i, (m, v) in enumerate(zip(tr.opt_g.mu, tr.opt_g.nu)))
    check(same, "--init-from did not restore the Adam states bit for bit")
    del model, tr
    gc.collect()
    torch.cuda.empty_cache()
    out2 = os.path.join(OUT_DIR, "init_run")
    ckpt2, stdout, secs_init, last = run_train_cli("init-from", root, out2, "--init-from",
                                                   ckpt_path)
    check(f"restored torch Adam states (step {final['step']})" in stdout
          and last["step"] == final["step"] + 2, f"--init-from run:\n{stdout}")
    print(f"phase 23 CLI chain (W={W}, batch 2): SIGUSR1 after step {saved['step']} saved at "
          f"epoch -1 and exited in {secs_pre:.1f} s; the resume file loaded on the card bit "
          f"for bit; --resume ran steps {steps} + validation in {secs_resume:.1f} s and wrote "
          f"HALT, the best checkpoint and the validation PNGs; the re-run returned in "
          f"{secs_halt:.1f} s; --init-from restored step {final['step']} and both Adam "
          f"states bit for bit and continued at step {last['step'] - 1} ({secs_init:.1f} s)")
    return {"pre_s": secs_pre, "resume_s": secs_resume, "halt_s": secs_halt,
            "init_s": secs_init}


def rest_of_training_phase(dev) -> dict:
    """Phase 23 (`` (a)``–``(e)``): K3's bf16 mode on the bf16 stage-1
    (C = 65) and SLR stage-3 (C = 67) steps' own rows, those two bf16
    steps, accumulation, the origin-D motion GAN and the style + ff-mask
    step at full width (``Options()`` defaults, B = 16, 256², T = 60), then
    the resume chain of the CLI on phase 11's data."""
    import torch

    t0 = time.perf_counter()
    k3_label, options, make_batch, module = bf16_step_options(False)
    res = {"bf16": bf16_step_case(dev, "bf16 stage-1 step", options, make_batch, module,
                                  k3_label)}
    k3_label, options, make_batch, module = bf16_step_options(True)
    res["bf16_slr"] = bf16_step_case(dev, f"bf16 SLR stage-3 step (C={SLR_TRAIN_C})",
                                     options, make_batch, module, k3_label)
    res["accum"] = accumulation_case(dev)
    res.update(origin_and_style_case(dev))
    res["cli"] = resume_chain_case(dev, os.path.join(OUT_DIR, "train_data"))
    b16, s16 = res["bf16"], res["bf16_slr"]
    print(f"phase 23 the rest of training in {time.perf_counter() - t0:.1f} s: bf16 stage 1 "
          f"{b16['step_ms']:.1f} ms = {TRAIN_B / b16['step_ms'] * 1e3:.2f} samples/s (peak "
          f"{b16['peak'] / 2**30:.2f} GiB), bf16 SLR {s16['step_ms']:.1f} ms = "
          f"{TRAIN_B / s16['step_ms'] * 1e3:.2f} samples/s (peak {s16['peak'] / 2**30:.2f} "
          f"GiB); origin-D motion GAN {res['origin']['step_ms']:.1f} ms; style + ff mask "
          f"{res['style']['step_ms']:.1f} ms; all checks passed")
    torch.cuda.empty_cache()
    return res

# ---- crop decode at full width, the scene sweep, stages and a trace ------

CROP_W = 768  # the CLAW eval protocol's size
CROP_ROWS, CROP_COLS = slice(288, 480), slice(192, 576)  # P = 73,728
# the JAX package's prepare_crop plan for synthetic_scene(SEED, CROP_W,
# CROP_ROWS, CROP_COLS) with Options() defaults and N = 60; the port must
# plan the same (tests/test_torch_crop.py holds both packages to it)
CROP_PLAN = (168, 72, 432, 624, 213, 117, 342, 534)
# the sweep's scenes: (seed, moving rows, moving columns); a and b plan
# windows of one size at two places, c and d one size each
SWEEP_SCENES = {"a": (10, slice(288, 480), slice(192, 576)),
                "b": (11, slice(320, 512), slice(160, 544)),
                "c": (13, slice(96, 288), slice(400, 768)),
                "d": (14, slice(480, 672), slice(64, 448))}


def crop_scene():
    """The crop phases' 768² scene: (uint8 image, flow, the image as the
    renderer reads it)."""
    img_u8, flow = synthetic_scene(SEED, CROP_W, CROP_ROWS, CROP_COLS)
    return img_u8, flow, (img_u8.astype(np.float32) / 255.0 - 0.5) / 0.5


def k2_grid_times(args, out, acc, reps: int, plain_reps: int) -> dict:
    """K2 in f32 on ``args`` = (u_mov, positions, valid, disp_a, disp_b, w_a,
    w_b, u_static) into ``out`` on the (h, w) grid of u_static, as
    ``kernel_times`` times it, with the card's work per call split by
    ``launch_split`` (copy, scatter, epilogue), beside its plain version (as
    called), one ``index_add_`` of the same weighted corner rows into a copy
    of u_static (device time) and its bound (each valid row, its position and both
    displacements read once, valid read, u_static read and the output
    written once; the corners' weights and adds and the division)."""
    import torch

    from slrsfs_tpu_torch.ops.splat import (
        _corner_taps,
        splat_dual_normalize,
        splat_dual_normalize_plain,
    )

    u_mov, pos, val, da, db, w_a, w_b, u_static = args
    (h, w, C1), P = u_static.shape, pos.shape[0]
    n_valid = int((val > 0.5).sum())
    res = kernel_times(lambda: splat_dual_normalize(*args, out=out, acc=acc), reps=reps)
    res["split"] = launch_split(lambda: splat_dual_normalize(*args, out=out, acc=acc))
    res["plain_ms"] = cuda_time(lambda: splat_dual_normalize_plain(*args, torch.float32),
                                reps=plain_reps)
    pcx, pcy = pos[:, 0].float(), pos[:, 1].float()
    lins, rows = [], []
    for d, wt in ((da, w_a), (db, w_b)):
        for lin, wk in _corner_taps(pcx + d[:, 0], pcy + d[:, 1], h, w):
            lins.append(lin)
            rows.append(u_mov * wt * (wk * val)[:, None])
    lin_all, rows_all = torch.cat(lins), torch.cat(rows)
    del lins, rows
    flat = u_static.reshape(h * w, C1).clone()
    res["lib"] = kernel_times(lambda: flat.index_add_(0, lin_all, rows_all), reps=reps)
    res["bound"] = bound(n_valid * (C1 * 4 + 8 + 16) + P * 4 + h * w * C1 * 4
                         + h * w * (C1 - 1) * 4,
                         2 * n_valid * C1 * (1 + 4 * 2) + h * w * (C1 - 1))
    return res


def crop_kernel_rows(dev, crop, flow, positions, valid, disp_f, disp_p, probe,
                     probe_dll):
    """The crop path's kernels at the 768² scene's shapes, each against its
    plain version. K1 on the full 768² grid, bit for bit: the render's
    ``prepare_crop`` displacements (``disp_f``, ``disp_p``) and the sweep's
    moving set (bucketed at 1.25, padding rows at (0, 0)). K2 (f32) and K5
    on the crop window's (hc, wc) grid at window coordinates, at one frame
    (T_MID) (K2 1e-5 with the same empty cells, K5 bit for bit), with the
    render's moving set (P = 73,728, no padding) and with the sweep's (its
    padding rows at negative window coordinates), K5 also on the full grid
    with every row invalid and no displacement, as the crop's static Z-norm
    calls it. Timed at the render's shapes: K1 as ``euler_times`` times it
    at 256² (beside its bytes bound and the chase probe's latency bound for
    its rows), K2 and K5 as ``k2_times`` and ``maxwarp_phase`` do
    (``kernel_times``, the plain version, one ``index_add_`` /
    ``scatter_reduce_(amax)`` of the same corner rows, the bound)."""
    import torch

    from slrsfs_tpu_torch.engine import rollout
    from slrsfs_tpu_torch.ops import maxwarp
    from slrsfs_tpu_torch.ops.euler import euler_compact_dual, euler_compact_dual_plain
    from slrsfs_tpu_torch.ops.splat import (
        corners,
        splat_dual_normalize,
        splat_dual_normalize_plain,
        splat_scratch,
    )

    hc, wc = crop.hc, crop.wc
    n = N_FRAMES
    pos_b, val_b = (torch.from_numpy(a).to(dev) for a in
                    rollout.prepare_scene_sparse(flow.cpu().numpy(), bucket_ratio=1.25))
    d_f, d_p = euler_compact_dual(flow, pos_b, n - 1, n)
    k1_sets = {"render": (positions, (disp_f, disp_p)), "sweep": (pos_b, (d_f, d_p))}
    for label, (pos, got) in k1_sets.items():
        want = euler_compact_dual_plain(flow, pos, n - 1, n)
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"K1 on the {CROP_W}^2 grid, {label} set, differs from its plain version")
    del want
    print(f"phase 12 K1 on the {CROP_W}^2 grid: bit-exact on the render's set "
          f"(P={positions.shape[0]}) and the sweep's (P={pos_b.shape[0]}, "
          f"{int((val_b < 0.5).sum())} padding rows), steps {n - 1}/{n}")
    k1_case = next(c for c in euler_cases(flow, positions, f"{CROP_W}^2 render set")
                   if c["name"] == "K1")
    cells = positions[:, 1].long() * flow.shape[1] + positions[:, 0].long()
    k1 = euler_times([k1_case], {"K1": probe.latency_bound(
        probe_dll, flow, cells, n, device_time)}, "phase 12")[k1_case["label"]]
    k1["err"] = 0.0
    k1["plain_ms"] = cuda_time(lambda: euler_compact_dual_plain(
        flow, positions, n - 1, n), reps=3, warmup=1)
    print(f"phase 12 K1 plain at the {CROP_W}^2 render set: {k1['plain_ms']:.3f} ms "
          f"(as called)")
    sets = {"render": (positions, valid, disp_f[T_MID], disp_p[n - T_MID]),
            "sweep": (pos_b, val_b, d_f[T_MID], d_p[n - T_MID])}
    shift = torch.tensor([crop.x0, crop.y0], dtype=torch.int32, device=dev)
    rng = np.random.default_rng(SEED + 7)
    ez = np.exp(-rng.uniform(0, 3, (CROP_W, CROP_W, 1))).astype(np.float32)
    u = torch.from_numpy(np.concatenate(
        [rng.normal(0, 1, (CROP_W, CROP_W, 64)).astype(np.float32) * ez, ez],
        -1)).to(dev)
    C1 = u.shape[-1]
    z_full = torch.from_numpy((np.random.default_rng(SEED + 8).standard_normal(
        (CROP_W, CROP_W)) * 3.0).astype(np.float32)).to(dev)
    z = rollout._crop_slice(z_full, crop).contiguous()
    out = torch.empty((hc, wc, C1 - 1), dtype=torch.float32, device=dev)
    acc = splat_scratch(hc, wc, C1, torch.float32, dev)
    w = 0.5
    checked = {}
    for label, (pos, val, da, db) in sets.items():
        pos_c = (pos - shift).contiguous()
        P, n_valid = pos.shape[0], int((val > 0.5).sum())
        check(bool((pos_c < 0).any()) == (P > n_valid),
              f"{label} set: padding rows and negative window coordinates disagree")
        static = rollout._static_mask(pos_c, val, hc, wc)
        px, py = pos[:, 0].long(), pos[:, 1].long()
        u_mov = (u[py, px] * val[:, None]).contiguous()
        u_static = (rollout._crop_slice(u, crop) * static[..., None]).contiguous()
        args = (u_mov, pos_c, val, da, db, w, w, u_static)
        splat_dual_normalize(*args, out=out, acc=acc)
        want = splat_dual_normalize_plain(*args, torch.float32)
        z_mov = z_full[py, px].contiguous()
        k5_args = (z, static, z_mov, pos_c, val, da)
        kd, km = maxwarp.maximum_warp_norm_sparse(*k5_args)
        pd, pm = maxwarp.maximum_warp_norm_sparse_plain(*k5_args)
        full_args = (z_full, rollout._static_mask(pos, val, CROP_W, CROP_W), z_mov,
                     pos, torch.zeros_like(val), torch.zeros_like(da))
        fd, fm = maxwarp.maximum_warp_norm_sparse(*full_args)
        gd, gm = maxwarp.maximum_warp_norm_sparse_plain(*full_args)
        torch.cuda.synchronize()
        err = (out - want).abs().max().item()
        check(torch.allclose(out, want, rtol=1e-5, atol=1e-5),
              f"K2 on the {hc}x{wc} window, {label} set: max abs {err}")
        lone = check_zeros(out, want, f"K2 on the {hc}x{wc} window, {label} set")
        check(torch.equal(kd, pd) and torch.equal(km, pm),
              f"K5 on the {hc}x{wc} window, {label} set, differs from its plain version")
        check(torch.equal(fd, gd) and torch.equal(fm, gm), f"K5 on the full grid, every "
              f"row invalid, {label} set, differs from its plain version")
        checked[label] = (P, P - n_valid, err, lone)
        if label == "render":
            timing = (args, k5_args, pos_c, val, da, db, u_mov, u_static, z_mov)
        del want, kd, km, pd, pm, fd, fm, gd, gm
    del u
    args, k5_args, pos_c, val, da, db, u_mov, u_static, z_mov = timing
    P = pos_c.shape[0]
    k2 = k2_grid_times(args, out, acc, reps=50, plain_reps=5)
    k2["err"] = max(e for _, _, e, _ in checked.values())
    del acc
    pcx, pcy = pos_c[:, 0].float(), pos_c[:, 1].float()
    n_valid = int((val > 0.5).sum())
    k5 = kernel_times(lambda: maxwarp.maximum_warp_norm_sparse(*k5_args), reps=50)
    k5["err"] = 0.0
    k5["plain_ms"] = cuda_time(lambda: maxwarp.maximum_warp_norm_sparse_plain(*k5_args),
                               reps=5)
    taps = corners(pcx + da[:, 0], pcy + da[:, 1], hc, wc)
    lin_all = torch.cat([lin for lin, _, _ in taps])
    val_all = torch.cat([torch.where(inside & (val > 0.5), z_mov * wk, float("-inf"))
                         for _, wk, inside in taps])
    mx = torch.full((hc * wc,), -1000.0, device=dev)
    k5["lib"] = kernel_times(lambda: mx.scatter_reduce_(0, lin_all, val_all,
                                                        reduce="amax"), reps=50)
    k5["bound"] = bound(hc * wc * 4 * 2 + P * (4 + 8 + 4 + 8) + hc * wc * 4 + P * 4,
                        n_valid * 20 + P * 20 + hc * wc * 9)
    sets_note = "; ".join(f"{k} set P={p} ({pad} padding rows): K2 max abs {e:.3g} "
                          f"({z} single elements exactly 0 on one side only), K5 "
                          f"bit-exact on the window and on the full grid with every "
                          f"row invalid" for k, (p, pad, e, z) in checked.items())
    print(f"phase 12 kernels on the {hc}x{wc} window against their plain versions: "
          f"{sets_note}")
    for name, r in (("K2 f32", k2), ("K5", k5)):
        print(f"phase 12 {name} at the {hc}x{wc} window (render set, P={P}): "
              f"{fmt_times(r)}; plain {r['plain_ms']:.3f} ms; library "
              f"{fmt_times(r['lib'])}; bound {r['bound'][0]:.4f} ms by {r['bound'][1]}")
    return {"K1": k1, "K2": k2, "K5": k5}


def crop_phase(dev, probe, probe_dll):
    """The crop decode at full width: Options() defaults at W = 768, N = 60,
    random weights from the seed, the scene of ``crop_scene`` (P = 73,728).
    The plan must be JAX's (``CROP_PLAN``). The baseline in float32,
    bfloat16 and bfloat16-fast through ``SceneRenderer.frames`` with
    crop_decode 'auto' (launches counted) and 'off', each timed (median of
    3 after a warm-up, GC held off); float32 crop against no-crop and
    against the crop render through the plain versions (1e-4, TF32 off);
    bf16 and bf16-fast crop against no-crop within twice that dtype's
    no-crop kernel render's distance from its plain render. The SLR model
    in float32 and float32 v2 crop and no-crop once each (1e-4; v2 K5 is
    launched N + 1 times: each frame and the static Z-norm). K2 and K5 at
    the window grid, K1 on the 768² grid (``crop_kernel_rows``, with the
    chase probe ``probe`` built as ``probe_dll`` for K1's latency bound)."""
    import torch

    from slrsfs_tpu_torch import kernels
    from slrsfs_tpu_torch.cli.render import SceneRenderer
    from slrsfs_tpu_torch.engine import rollout

    _, flow_np, img = crop_scene()
    n = N_FRAMES
    zero = {k.name: 0 for k in kernels.KERNELS}

    def max_diff(a, b):
        if not isinstance(a, dict):
            a, b = {"PredImg": a}, {"PredImg": b}
        return max((a[k].float() - b[k].float()).abs().max().item() for k in a)

    def timed(r, mode):
        r.crop_decode = mode
        return render_median(r, img, flow_np)

    res = {"fps": {}, "ms": {}, "fastest_ms": {}, "launches": {}}
    for dtype in ("float32", "bfloat16", "bfloat16-fast"):
        r = SceneRenderer(W=CROP_W, n_frames=n, dtype=dtype, seed=SEED, sparsify_eps=0.0)
        if dtype == "float32":
            _, flow_t, pos_t, val_t = r._tensors(img, flow_np)
            disp, crop = rollout.prepare_crop(r.opt, False, flow_t, pos_t, val_t, n)
            check(crop is not None and tuple(crop) == CROP_PLAN,
                  f"crop plan {crop}, JAX plans {CROP_PLAN}")
            res["crop"] = crop
            res["P"] = pos_t.shape[0]
        kernels.reset_counts()
        got = r.frames(img, flow_np)
        torch.cuda.synchronize()
        launches = kernels.counts()
        check(launches == {**zero, "euler_compact_dual": 1, "splat_dual_normalize": n},
              f"{dtype} crop render launches: {launches}")
        res["launches"][dtype] = launches
        check(bool(torch.isfinite(got).all()), f"{dtype} crop render not finite")
        r.crop_decode = "off"
        full = r.frames(img, flow_np)
        err = max_diff(got, full)
        if dtype == "float32":
            r.crop_decode = "auto"
            plain = r.frames(img, flow_np, plain=True)
            ref = max_diff(got, plain)
            check(err <= 1e-4, f"float32 crop vs no-crop render max abs {err}")
            check(ref <= 1e-4, f"float32 crop render, kernels vs plain, max abs {ref}")
            note = (f"crop vs no-crop max abs {err:.3g}, crop kernels vs plain "
                    f"{ref:.3g} (limits 1e-4)")
        else:
            ref = max_diff(full, r.frames(img, flow_np, plain=True))
            check(err <= 2.0 * ref, f"{dtype} crop vs no-crop render max abs {err}, "
                  f"over twice the no-crop kernel render's distance from its plain "
                  f"render, {ref}")
            note = (f"crop vs no-crop max abs {err:.3g} (limit twice the no-crop "
                    f"kernel vs plain render's {ref:.3g})")
        del got, full
        db = {m: r.decode_batch_for(a) for m, a in
              (("auto", crop.hc * crop.wc), ("off", CROP_W * CROP_W))}
        for mode, label in (("auto", "crop"), ("off", "no-crop")):
            med, ts = timed(r, mode)
            res["ms"][f"baseline {dtype} {label}"] = med * 1e3
            res["fastest_ms"][f"baseline {dtype} {label}"] = min(ts) * 1e3
            res["fps"][f"baseline {dtype} {label}"] = n / med
            print(f"phase 12 baseline {dtype} {label} render {CROP_W}^2 N={n} "
                  f"(decode batch {db[mode]}): median {med * 1e3:.1f} ms = "
                  f"{n / med:.2f} frames/s (runs {[round(x * 1e3, 1) for x in ts]} ms)")
        print(f"phase 12 baseline {dtype}: {note}; crop launches "
              f"{ {k: v for k, v in launches.items() if v} }")
        if dtype == "float32":
            res["renderer"] = r  # for the trace
            r.crop_decode = "auto"
        else:
            del r
        torch.cuda.empty_cache()

    for label, overrides in (("SLR float32", SLR_OPTS),
                             ("SLR float32 v2", dict(SLR_OPTS,
                                                     use_softmax_splatter_v2=True))):
        v2 = label.endswith("v2")
        r = SceneRenderer(W=CROP_W, n_frames=n, dtype="float32", seed=SEED,
                          sparsify_eps=0.0, opt_overrides=overrides)
        times = {}
        outs = {}
        with no_gc():
            for mode in ("auto", "off"):
                r.crop_decode = mode
                kernels.reset_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs[mode] = r.frames(img, flow_np)
                torch.cuda.synchronize()
                times[mode] = time.perf_counter() - t0
                if mode == "auto":
                    launches = kernels.counts()
        want = {**zero, "euler_compact_dual": 1, "splat_dual_normalize_slr": n,
                "maximum_warp_norm_sparse": n + 1 if v2 else 0}
        check(launches == want, f"{label} crop render launches: {launches}")
        res["launches"][label] = launches
        err = max_diff(outs["auto"], outs["off"])
        if v2:
            r.crop_decode = "auto"

            def side(mode):
                def run():
                    r.crop_decode = mode
                    return r.frames(img, flow_np)
                return run

            v2_diagnostic(f"{label} {CROP_W}^2 crop vs no-crop", err, r.model,
                          pos_t, val_t, side("auto"), side("off"))
        check(err <= 1e-4, f"{label} crop vs no-crop max abs {err}")
        for mode, tag in (("auto", "crop"), ("off", "no-crop")):
            res["ms"][f"{label} {tag}"] = times[mode] * 1e3
            res["fps"][f"{label} {tag}"] = n / times[mode]
        print(f"phase 12 {label} {CROP_W}^2 N={n}: crop {times['auto'] * 1e3:.1f} ms = "
              f"{n / times['auto']:.2f} frames/s, no-crop {times['off'] * 1e3:.1f} ms = "
              f"{n / times['off']:.2f} frames/s (once each); every output crop vs "
              f"no-crop max abs {err:.3g} (limit 1e-4); crop launches "
              f"{ {k: v for k, v in launches.items() if v} }")
        del r, outs
        torch.cuda.empty_cache()

    d_f, d_p = disp
    res["kernels"] = crop_kernel_rows(dev, crop, flow_t, pos_t, val_t, d_f, d_p, probe,
                                      probe_dll)
    print(f"phase 12 crop plan {tuple(crop)} (JAX's), window {crop.hc}x{crop.wc} = "
          f"{100.0 * crop.hc * crop.wc / CROP_W ** 2:.1f} % of the frame, P={res['P']}")
    return res


# ---- motion from hints at full width ---------------------------------------

MOTION_TYPE = "SPADE_unet_mask_motion"


def write_motion_ckpt(path: str, seed: int) -> str:
    """A reference-style ``.pth`` (the state_dict under ``model.module.``,
    the options as a Namespace) of a full-width SPADE motion regressor
    (Options() defaults: 32 filters, 8 downs) with seeded random weights:
    LeCun-normal kernels, zero biases, each spectral pair its kernel's top
    singular pair (``models/baseline.py:init_random_weights``)."""
    import argparse
    import dataclasses

    import torch

    from slrsfs_tpu_torch.config import Options
    from slrsfs_tpu_torch.models.baseline import init_random_weights
    from slrsfs_tpu_torch.models.motion import MotionRegressor

    opt = Options(model_type=MOTION_TYPE)
    reg = MotionRegressor(opt)
    init_random_weights(reg, seed)
    opts = argparse.Namespace(**{k: list(v) if isinstance(v, tuple) else v
                                 for k, v in dataclasses.asdict(opt).items()})
    torch.save({"state_dict": {f"model.module.{k}": v for k, v in reg.state_dict().items()},
                "opts": opts}, path)
    return path


def motion_phase(dev, probe, probe_dll):
    """Motion from hints at full width (``SceneRenderer(motion_ckpt=...)``):
    a seeded random full-width SPADE regressor written as a reference-style
    ``.pth``, ``crop_scene``'s image and flow (a JPEG-free PNG and a .flo)
    through ``SceneRenderer.render(..., rawsize=True)`` at W = 768, N = 60,
    baseline Options() defaults, crop 'auto', float32 and bfloat16 (launches
    counted). The given flow only seeds the hints; the regressor's dense
    motion moves nearly every pixel, so the crop plans no window and K1 and
    K2 run on the whole grid. Holds: the hints on the card against the
    CPU's (the same centroid pixels, the field within 1e-6); the regressor
    on the card against the same weights on the CPU (float32, TF32 off,
    1e-4 of max |pred|; the bfloat16 renderer's regressor likewise); K1 bit
    for bit on the predicted motion's moving set; K2 at T_MID on the
    768^2 grid, f32 within 1e-5 with the same empty cells and bf16
    accumulation at most twice as far from the f32 sums as its plain
    version; the f32 render through the kernels against the plain versions
    (1e-4); ``warp_flow_rollout`` kernels against plain (1e-5). Times t_hints
    and t_regressor (median of 3), the regressor's peak memory, frames/s
    with the hints and the regression included (median of 3), K1 and K2
    as ``crop_kernel_rows`` times them."""
    import tempfile

    import torch
    from PIL import Image

    from slrsfs_tpu_torch import kernels
    from slrsfs_tpu_torch.cli.render import SceneRenderer, _load_flow, load_regressor
    from slrsfs_tpu_torch.data import hints
    from slrsfs_tpu_torch.data.transforms import transform_flow
    from slrsfs_tpu_torch.utils.flow_viz import write_flo
    from slrsfs_tpu_torch.engine import rollout
    from slrsfs_tpu_torch.engine.init_utils import no_tf32
    from slrsfs_tpu_torch.ops.euler import euler_compact_dual_plain
    from slrsfs_tpu_torch.ops.splat import (
        splat_dual_normalize,
        splat_dual_normalize_plain,
        splat_scratch,
    )

    n = N_FRAMES
    zero = {k.name: 0 for k in kernels.KERNELS}
    img_u8, given, img = crop_scene()
    scene_dir = os.path.join(OUT_DIR, "motion")
    os.makedirs(scene_dir, exist_ok=True)
    img_path, flow_path = (os.path.join(scene_dir, f) for f in ("scene.png", "scene.flo"))
    Image.fromarray(img_u8).save(img_path)
    write_flo(flow_path, given)
    flow_in = transform_flow(_load_flow(flow_path), CROP_W)  # as load_inputs reads it
    res = {"fps": {}}
    with tempfile.TemporaryDirectory() as td:
        ckpt = write_motion_ckpt(os.path.join(td, "motion.pth"), SEED + 30)
        r = SceneRenderer(W=CROP_W, n_frames=n, dtype="float32", seed=SEED,
                          motion_ckpt=ckpt)
        rb = SceneRenderer(W=CROP_W, n_frames=n, dtype="bfloat16", seed=SEED,
                           motion_ckpt=ckpt)
        cpu_reg = load_regressor(ckpt, CROP_W)

    # the hints: the same centroid pixels and field on the card and the CPU
    flow_t = torch.from_numpy(flow_in).to(dev)
    mask = hints.moving_mask_threshold(flow_t)
    px = hints.kmeans_hint_pixels(mask, 5)
    px_cpu = hints.kmeans_hint_pixels(mask.cpu(), 5)
    check(np.array_equal(px, px_cpu), f"hint pixels on the card {px.tolist()}, on the "
          f"CPU {px_cpu.tolist()}")
    field = hints.densify_hints(flow_t, px, CROP_W / 5.0, mask)
    field_cpu = hints.densify_hints(flow_t.cpu(), px_cpu, CROP_W / 5.0, mask.cpu())
    hint_err = (field.cpu() - field_cpu).abs().max().item()
    check(hint_err <= 1e-6, f"hint field, card vs CPU, max abs {hint_err}")
    t_hints, hint_runs = call_median(lambda: hints.synthesize_hint(flow_t))
    hint, mask = hints.synthesize_hint(flow_t)
    check(torch.equal(hint, field), "synthesize_hint differs from its parts")

    # the regressor: the card against the CPU, float32 with TF32 off
    args = (torch.from_numpy(img[None]).to(dev), mask[None, ..., None], hint[None])
    with torch.no_grad(), no_tf32():
        pred = r.regressor(*args)
        pred_cpu = cpu_reg(*(a.cpu() for a in args))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        r.regressor(*args)
        torch.cuda.synchronize()
        reg_peak = torch.cuda.max_memory_allocated() - base
        t_reg, reg_runs = call_median(lambda: r.regressor(*args))
    scale = pred_cpu.abs().max().item()
    reg_err = (pred.cpu() - pred_cpu).abs().max().item()
    check(reg_err <= 1e-4 * scale, f"regressor, card vs CPU, max abs {reg_err} "
          f"(max |pred| {scale})")
    del pred_cpu, cpu_reg
    print(f"phase 15 hints on {int(mask.sum())} moving pixels of the given flow: "
          f"centroids {px.tolist()} on the card and the CPU, field max abs "
          f"{hint_err:.3g} (limit 1e-6); t_hints {t_hints * 1e3:.2f} ms (runs "
          f"{[round(x * 1e3, 2) for x in hint_runs]}); regressor ({MOTION_TYPE}, "
          f"{sum(p.numel() for p in r.regressor.parameters())} parameters, {CROP_W}^2 "
          f"f32, TF32 off) card vs CPU max abs {reg_err:.3g} (limit 1e-4 of max |pred| "
          f"{scale:.3g}); t_regressor {t_reg * 1e3:.2f} ms (runs "
          f"{[round(x * 1e3, 2) for x in reg_runs]}); peak {reg_peak / 2**30:.3f} GiB "
          f"above its weights and inputs")
    res.update(t_hints=t_hints, t_regressor=t_reg, regressor_peak=reg_peak)

    # the main path: SceneRenderer.render with the regressor, float32
    kernels.reset_counts()
    out_dir, frames = render_capture(r, img_path, flow_path, os.path.join(scene_dir, "f32"),
                                     name="scene", rawsize=True)
    torch.cuda.synchronize()
    launches = kernels.counts()
    check(launches == {**zero, "euler_compact_dual": 1, "splat_dual_normalize": n},
          f"motion render launches: {launches}")
    res["launches"] = launches
    check(len(os.listdir(os.path.join(out_dir, "PredImg"))) == n, "PNGs written")
    check(tuple(frames.shape) == (n, CROP_W, CROP_W, 3)
          and bool(torch.isfinite(frames).all()), "motion render frames")
    motion = r.scene_flow(img, flow_in, "scene", rawsize=True)
    _, flow_m, pos, val = r._tensors(img, motion)
    P, n_mov = pos.shape[0], int(val.sum().item())
    (disp_f, disp_p), crop = rollout.prepare_crop(r.opt, False, flow_m, pos, val, n)
    check((P, CROP_W, CROP_W) in r.shapes and crop is None,
          f"motion render shapes {r.shapes}, crop {crop}")
    res.update(P=P, n_moving=n_mov, crop=crop)
    plain = r.frames(img, motion, plain=True)
    render_err = (frames - plain).abs().max().item()
    check(render_err <= 1e-4, f"motion render, kernels vs plain, max abs {render_err}")
    del plain
    want = euler_compact_dual_plain(flow_m, pos, n - 1, n)
    check(torch.equal(disp_f, want[0]) and torch.equal(disp_p, want[1]),
          "K1 on the predicted motion differs from its plain version")
    del want
    print(f"phase 15 motion render f32 (SceneRenderer.render, --rawsize, crop auto): "
          f"P={P} ({n_mov} moving of {CROP_W * CROP_W} pixels), crop plan {crop}; "
          f"launches { {k: v for k, v in launches.items() if v} }; kernels vs plain "
          f"render max abs {render_err:.3g} (limit 1e-4); K1 bit-exact")

    # K1 and K2 at these shapes: held and timed
    cells = pos[:, 1].long() * CROP_W + pos[:, 0].long()
    k1_case = next(c for c in euler_cases(flow_m, pos, f"{CROP_W}^2 motion from hints")
                   if c["name"] == "K1")
    k1 = euler_times([k1_case], {"K1": probe.latency_bound(
        probe_dll, flow_m, cells, n, device_time)}, "phase 15")[k1_case["label"]]
    k1["err"] = 0.0
    k1["plain_ms"] = cuda_time(lambda: euler_compact_dual_plain(flow_m, pos, n - 1, n),
                               reps=3, warmup=1)
    rng = np.random.default_rng(SEED + 31)
    ez = np.exp(-rng.uniform(0, 3, (CROP_W, CROP_W, 1))).astype(np.float32)
    u = torch.from_numpy(np.concatenate(
        [rng.normal(0, 1, (CROP_W, CROP_W, 64)).astype(np.float32) * ez, ez], -1)).to(dev)
    C1 = u.shape[-1]
    static = rollout._static_mask(pos, val, CROP_W, CROP_W)
    u_mov = (u[pos[:, 1].long(), pos[:, 0].long()] * val[:, None]).contiguous()
    u_static = (u * static[..., None]).contiguous()
    del u
    k2_args = (u_mov, pos, val, disp_f[T_MID], disp_p[n - T_MID], 0.5, 0.5, u_static)
    out = torch.empty((CROP_W, CROP_W, C1 - 1), dtype=torch.float32, device=dev)
    acc = splat_scratch(CROP_W, CROP_W, C1, torch.float32, dev)
    splat_dual_normalize(*k2_args, out=out, acc=acc)
    want = splat_dual_normalize_plain(*k2_args, torch.float32)
    torch.cuda.synchronize()
    k2_err = (out - want).abs().max().item()
    check(torch.allclose(out, want, rtol=1e-5, atol=1e-5),
          f"K2 f32 on the {CROP_W}^2 grid, motion from hints: max abs {k2_err}")
    lone = check_zeros(out, want, f"K2 f32 on the {CROP_W}^2 grid, motion from hints")
    bf_args = (u_mov.to(torch.bfloat16), *k2_args[1:7], u_static.to(torch.bfloat16))
    bf = splat_dual_normalize(*bf_args, out=torch.empty_like(out))
    bf_plain = splat_dual_normalize_plain(*bf_args, torch.float32)
    torch.cuda.synchronize()
    bf_bound = k2_bf16_bound("K2", want, bf_args[0], bf_args[-1], *k2_args[1:7],
                             torch.float32)
    bf_cell = bf16_cell_check(f"K2 bf16 accumulation on the {CROP_W}^2 grid", bf,
                              bf_plain, want, bf_bound)
    del want, bf, bf_plain, bf_args, bf_bound
    k2 = k2_grid_times(k2_args, out, acc, reps=20, plain_reps=3)
    k2["err"] = k2_err
    del acc, out, k2_args, u_mov, u_static
    print(f"phase 15 K1 plain at the motion's set: {k1['plain_ms']:.3f} ms (as called)")
    print(f"phase 15 K2 f32 on the {CROP_W}^2 grid, motion from hints (P={P}): "
          f"{fmt_times(k2)}; plain {k2['plain_ms']:.3f} ms; library "
          f"{fmt_times(k2['lib'])}; bound {k2['bound'][0]:.4f} ms by {k2['bound'][1]}; "
          f"per call on the card (torch.profiler): {fmt_split(k2['split'])}")
    print(f"phase 15 K2 on the {CROP_W}^2 grid against its plain version at t={T_MID}: "
          f"f32 max abs {k2_err:.3g} (limit 1e-5; {lone} single elements exactly 0 on "
          f"one side only), bf16 accumulation: {fmt_bf16(bf_cell)}")
    res["kernels"] = {"K1": k1, "K2": k2}

    # warp_flow_rollout: K1 once, K2 with C1 = 4 a frame
    img_t = torch.from_numpy(img[None]).to(dev)
    kernels.reset_counts()
    warped = rollout.warp_flow_rollout(img_t, flow_m, n, pos, val)
    torch.cuda.synchronize()
    warp_launches = kernels.counts()
    check(warp_launches == {**zero, "euler_compact_dual": 1, "splat_dual_normalize": n},
          f"warp_flow_rollout launches {warp_launches}")
    warp_err = (warped - rollout.warp_flow_rollout(img_t, flow_m, n, pos, val,
                                                   plain=True)).abs().max().item()
    check(warp_err <= 1e-5, f"warp_flow_rollout kernels vs plain max abs {warp_err}")
    del warped
    print(f"phase 15 warp_flow_rollout {CROP_W}^2 N={n} on the predicted motion: "
          f"kernels vs plain max abs {warp_err:.3g} (limit 1e-5); launches "
          f"{ {k: v for k, v in warp_launches.items() if v} }")

    # frames/s with the hints and the regression included
    def motion_render(rr):
        return lambda: rr.frames(img, rr.scene_flow(img, flow_in, "scene", rawsize=True))

    med, ts = call_median(motion_render(r))
    res["fps"]["motion f32"] = n / med
    print(f"phase 15 motion render f32 {CROP_W}^2 N={n} (hints + regressor + render, "
          f"decode batch {r.decode_batch_for(CROP_W * CROP_W)}): median "
          f"{med * 1e3:.1f} ms = {n / med:.2f} frames/s (runs "
          f"{[round(x * 1e3, 1) for x in ts]} ms)")
    del r, frames
    torch.cuda.empty_cache()

    kernels.reset_counts()
    _, frames_b = render_capture(rb, img_path, flow_path, os.path.join(scene_dir, "bf16"),
                                 name="scene", rawsize=True)
    torch.cuda.synchronize()
    launches_b = kernels.counts()
    check(launches_b == launches, f"bfloat16 motion render launches {launches_b}")
    check(bool(torch.isfinite(frames_b).all()), "bfloat16 motion render not finite")
    motion_b = rb.scene_flow(img, flow_in, "scene", rawsize=True)
    mb_err = float(np.abs(motion_b - motion).max())
    check(mb_err <= 1e-4 * scale, f"the bfloat16 renderer's regressor (f32) differs "
          f"from the float32 one's by {mb_err}")
    med, ts = call_median(motion_render(rb))
    res["fps"]["motion bfloat16"] = n / med
    print(f"phase 15 motion render bfloat16 {CROP_W}^2 N={n}: regressed motion max abs "
          f"{mb_err:.3g} from the float32 renderer's; launches as f32; median "
          f"{med * 1e3:.1f} ms = {n / med:.2f} frames/s with hints and regressor (runs "
          f"{[round(x * 1e3, 1) for x in ts]} ms)")
    del rb, frames_b
    torch.cuda.empty_cache()
    return res


def sweep_phase():
    """``cli/render_all.py`` with its default flags (W = 768, bfloat16,
    crop decode auto, moving sets bucketed at 1.25) over the four
    ``SWEEP_SCENES`` (a JPEG and a .flo each), PNG and mp4 saves included;
    its launches, scenes/hour and count of (P, window) shapes; each scene's
    PredImg PNGs against a one-scene ``SceneRenderer.render`` of it within
    one u8 level (bf16 renders vary by a level with K2's atomic order)."""
    import shutil

    import torch
    from PIL import Image

    from slrsfs_tpu_torch import kernels
    from slrsfs_tpu_torch.cli import render_all
    from slrsfs_tpu_torch.cli.render import SceneRenderer
    from slrsfs_tpu_torch.utils.flow_viz import write_flo

    scenes_dir = os.path.join(OUT_DIR, "sweep_scenes")
    out_dir, one_dir = os.path.join(OUT_DIR, "sweep"), os.path.join(OUT_DIR, "sweep_one")
    for d in (scenes_dir, out_dir, one_dir):
        shutil.rmtree(d, ignore_errors=True)
    os.makedirs(scenes_dir)
    for name, (seed, rows, cols) in SWEEP_SCENES.items():
        img_u8, flow = synthetic_scene(seed, CROP_W, rows, cols)
        Image.fromarray(img_u8).save(os.path.join(scenes_dir, f"{name}_input.jpg"),
                                     quality=95)
        write_flo(os.path.join(scenes_dir, f"{name}_motion.flo"), flow)
    kernels.reset_counts()
    with no_gc():
        res = render_all.main([scenes_dir, out_dir])
    torch.cuda.synchronize()
    launches = kernels.counts()
    k = len(SWEEP_SCENES)
    check(res["done"] == k, f"sweep rendered {res['done']} scenes")
    check(launches == {**{kk.name: 0 for kk in kernels.KERNELS},
                       "euler_compact_dual": k, "splat_dual_normalize": k * N_FRAMES},
          f"sweep launches: {launches}")
    check(res["shapes"] == k - 1, f"sweep: {res['shapes']} (P, window) shapes, "
          f"expected {k - 1} (scenes a and b share one)")
    r = SceneRenderer(W=CROP_W, n_frames=N_FRAMES, dtype="bfloat16", seed=SEED)
    worst = 0
    for name in SWEEP_SCENES:
        r.render(os.path.join(scenes_dir, f"{name}_input.jpg"),
                 os.path.join(scenes_dir, f"{name}_motion.flo"), one_dir, name=name)
        r.finish()
        for sub in (out_dir, one_dir):
            check(len(os.listdir(os.path.join(sub, name, "PredImg"))) == N_FRAMES,
                  f"sweep {name}: PNGs missing in {sub}")
        check(os.path.exists(os.path.join(out_dir, name, f"PredImg_{name}.mp4")),
              f"sweep {name}: no mp4")
        for t in range(N_FRAMES):
            a, b = (read_png(os.path.join(sub, name, "PredImg", f"{t:06d}.png"))
                    .astype(np.int16) for sub in (out_dir, one_dir))
            worst = max(worst, int(np.abs(a - b).max()))
    check(worst <= 1, f"sweep PNGs differ from one-scene renders by {worst} u8 levels")
    per_hour = res["done"] / res["elapsed_s"] * 3600.0
    print(f"phase 13 sweep (cli/render_all.py, default flags: W={CROP_W}, bfloat16, "
          f"crop auto, P buckets 1.25): {res['done']} scenes in {res['elapsed_s']:.2f} s "
          f"incl. PNG and mp4 saves = {per_hour:.1f} scenes/hour; {res['shapes']} "
          f"distinct (P, window) shapes {sorted(r.shapes)}; launches "
          f"{ {kk: v for kk, v in launches.items() if v} }; PredImg PNGs against "
          f"one-scene renders: at most {worst} u8 level(s) apart")
    del r
    return {"scenes_per_hour": per_hour, "scenes_dir": scenes_dir, **res}


def stages_phase(crop: dict):
    """``python -m slrsfs_tpu_torch.cli.render --profile-stages`` (in this
    process, through its ``main``) on the 768² scene at float32: the full
    and the crop rollout's stages (t_encoder, t_euler_integration,
    t_softmax_splating, t_decoder), each > 0. A profile's stages are those
    of its fastest pass (JAX's ``stage_profile`` takes the fastest too),
    and one f32 768² render varies from pass to pass by up to ~10 %, so
    each profile is held to the fastest render of the same kind timed
    beside it: the full stages' sum within 10 % of the faster of two
    float32 no-crop renders just before the CLI call (the CLI profiles the
    full rollout first), the crop stages' within 10 % of the faster of the
    CLI's own render (its ``frames`` call, a crop render right after the
    crop profile, timed here) and one crop render just after it. The card's
    clock drifts over a minute of f32 work (on NVIDIA H100 80GB HBM3
    cards at 700 W phase 12's fastest crop run measured 2177 ms in one run
    of this script and 2402 ms in another, and a crop profile once came out
    13 % above it), so phase 12's fastest runs, a sweep earlier, are only
    printed beside them. Then one crop render under
    ``engine/profiler.py:profile_trace``: the device's busy share of the
    traced render (``tools/trace_busy.py``: the union of its kernel, copy
    and memset intervals over the render's span, beside the sum of their
    durations, which exceeds it where cuDNN's streams overlap)."""
    import torch
    from PIL import Image

    from slrsfs_tpu_torch.cli import render as render_cli
    from slrsfs_tpu_torch.engine.profiler import profile_trace
    from slrsfs_tpu_torch.tools import trace_busy

    img_u8, flow_np, img = crop_scene()
    scene_dir = os.path.join(OUT_DIR, "stages")
    os.makedirs(scene_dir, exist_ok=True)
    img_path = os.path.join(scene_dir, "scene768.png")
    flow_path = os.path.join(scene_dir, "scene768_motion.npy")
    Image.fromarray(img_u8).save(img_path)
    np.save(flow_path, flow_np)
    own = []
    frames = render_cli.SceneRenderer.frames

    def timed_frames(self, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = frames(self, *a, **k)
        torch.cuda.synchronize()
        own.append(time.perf_counter() - t0)
        return out

    rend = crop["renderer"]

    def beside(mode: str, reps: int) -> list:
        """Seconds of ``reps`` float32 renders of the scene in ``mode``; the
        renderer is warm from phase 12."""
        rend.crop_decode = mode
        ts = []
        with no_gc():
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                rend.frames(img, flow_np)
                torch.cuda.synchronize()
                ts.append(time.perf_counter() - t0)
        rend.crop_decode = "auto"
        return ts

    full_beside = beside("off", 2)
    render_cli.SceneRenderer.frames = timed_frames
    try:
        with no_gc():
            r = render_cli.main([img_path, flow_path, os.path.join(scene_dir, "out"),
                                 "--W", str(CROP_W), "--n-frames", str(N_FRAMES),
                                 "--profile-stages", "--sparsify-eps", "0"])
    finally:
        render_cli.SceneRenderer.frames = frames
    st = r.stage_profiles
    del r
    check(st is not None and st["crop"] is not None, f"stage profiles {st}")
    check(len(own) == 1, f"the CLI rendered {len(own)} times")
    crop_beside = own + beside("auto", 1)
    refs = {"full": (min(full_beside), "the faster of 2 no-crop renders just before",
                     crop["fastest_ms"]["baseline float32 no-crop"]),
            "crop": (min(crop_beside), "the faster of the CLI's render and 1 crop "
                     "render just after", crop["fastest_ms"]["baseline float32 crop"])}
    names = ("t_encoder", "t_euler_integration", "t_softmax_splating", "t_decoder")
    for kind in ("full", "crop"):
        s = st[kind]
        total = sum(s[k] for k in names)
        ref, what, p12_ms = refs[kind]
        runs = full_beside if kind == "full" else crop_beside
        print(f"phase 14 {kind} stages (--profile-stages, {CROP_W}^2 float32): "
              + ", ".join(f"{k} {s[k] * 1e3:.2f} ms" for k in names)
              + f"; sum {total * 1e3:.1f} ms, profiled pass {s['total'] * 1e3:.1f} ms, "
              f"{what} {ref * 1e3:.1f} ms ({100.0 * (total / ref - 1.0):+.1f} %; runs "
              f"{[round(x * 1e3, 1) for x in runs]} ms); phase 12's fastest float32 "
              f"{'no-crop' if kind == 'full' else 'crop'} run {p12_ms:.1f} ms "
              f"({100.0 * (total / (p12_ms / 1e3) - 1.0):+.1f} %, printed only)")
        check(all(s[k] > 0 for k in names), f"{kind} stages not all > 0: {s}")
        check(abs(total / ref - 1.0) <= 0.10, f"{kind} stages sum {total} s, "
              f"{what} {ref} s: more than 10 % apart")

    trace_dir = os.path.join(OUT_DIR, "trace")
    rend.frames(img, flow_np)
    torch.cuda.synchronize()
    with profile_trace(trace_dir):
        with torch.profiler.record_function(trace_busy.SPAN):
            rend.frames(img, flow_np)
            torch.cuda.synchronize()
    busy = trace_busy.device_busy(
        trace_busy.load_events(os.path.join(trace_dir, "trace.json")), trace_busy.SPAN)
    check(busy["busy_us"] <= min(busy["span_us"], busy["sum_us"]) + 1e-3,
          f"device busy {busy['busy_us']} us over a span of {busy['span_us']} us "
          f"and durations summing to {busy['sum_us']} us")
    share = busy["busy_us"] / busy["span_us"]
    print(f"phase 14 trace of one {CROP_W}^2 float32 crop render (torch.profiler, "
          f"{trace_dir}/trace.json; tools/trace_busy.py): {trace_busy.summary(busy)}")
    return {"stages": st, "own_s": own[0], "busy_share": share}


# ---- evaluation on the card: the CLAW protocol at 768² -----------------------

EVAL_KEYS = ("LPIPS", "Perceptual", "PSNR", "SSIM")


def event_ms(fn, reps: int = 5) -> float:
    """Median milliseconds of ``fn()`` between two CUDA events over ``reps``
    calls after one warm-up, GC held off."""
    import torch

    fn()
    ts = []
    with no_gc():
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            ts.append(start.elapsed_time(end))
    return sorted(ts)[len(ts) // 2]


def write_gt_video(path: str, img_u8: np.ndarray, rng) -> None:
    """``N_FRAMES`` frames of ``img_u8`` plus seeded noise of up to 4 u8
    levels each, as an mp4v video (the card's machine has no ffmpeg)."""
    import cv2

    h, w = img_u8.shape[:2]
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30, (w, h))
    check(vw.isOpened(), f"cv2 cannot write {path}")
    base = img_u8.astype(np.int16)
    try:
        for _ in range(N_FRAMES):
            f = np.clip(base + rng.integers(-4, 5, base.shape), 0, 255).astype(np.uint8)
            vw.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    finally:
        vw.release()


def eval_phase(scenes_dir: str, smi: str) -> dict:
    """The CLAW protocol end to end at 768² on the card: ``cli/render_all``
    with ``--rawsize`` renders the four ``SWEEP_SCENES`` (768² PredImg, 60
    frames, its defaults otherwise; K1 x 4, K2 x 240), each gets a seeded
    768² 60-frame GT mp4 (its input plus noise), and ``cli/eval`` scores
    them with seeded random VGG16, AlexNet, LPIPS and I3D weights (the
    user's layouts), plain and with ``--fluid`` (the sweep's .flo and
    JPEG as the motion and the input). Holds: every scene scored, the four
    Total columns and TotalFVD finite in both JSONs, each file equal to the
    returned dict; one 768² frame pair's metrics card vs CPU (PSNR, SSIM
    1e-5; Perceptual, LPIPS 1e-4 relative), the I3D features of scenes a
    and b's real and generated videos card vs CPU (1e-4 of max |feature|)
    and their Fréchet distance (1e-3 relative). Times the eval (wall, s
    per scene), each metric a frame (CUDA events), the host's PNG loads,
    mp4 decode and GT resize a frame, I3D and ``preprocess_video`` a video,
    the eval's peak memory and the render's frames/s."""
    import shutil

    import torch

    from slrsfs_tpu_torch import kernels
    from slrsfs_tpu_torch.cli import eval as eval_cli
    from slrsfs_tpu_torch.cli import render_all
    from slrsfs_tpu_torch.data.video import VideoReader
    from slrsfs_tpu_torch.engine.init_utils import no_tf32
    from slrsfs_tpu_torch.eval import metrics
    from slrsfs_tpu_torch.eval.eval_claw import _gt01, _img01
    from slrsfs_tpu_torch.eval.i3d import FVD, frechet_distance, preprocess_video
    from slrsfs_tpu_torch.eval.random_weights import write_random_weights

    t_phase = time.perf_counter()
    root = os.path.join(OUT_DIR, "eval")
    shutil.rmtree(root, ignore_errors=True)
    pred_dir, gt_dir = os.path.join(root, "pred"), os.path.join(root, "gt")
    os.makedirs(gt_dir)
    k = len(SWEEP_SCENES)
    tag = f"[{smi}]"

    kernels.reset_counts()
    with no_gc():
        res = render_all.main([scenes_dir, pred_dir, "--rawsize"])
    torch.cuda.synchronize()
    launches = kernels.counts()
    check(res["done"] == k, f"eval render: {res['done']} scenes")
    check(launches == {**{kk.name: 0 for kk in kernels.KERNELS},
                       "euler_compact_dual": k, "splat_dual_normalize": k * N_FRAMES},
          f"eval render launches: {launches}")
    for name in SWEEP_SCENES:
        frames = os.path.join(pred_dir, name, "PredImg")
        check(sorted(os.listdir(frames)) == [f"{t:06d}.png" for t in range(N_FRAMES)],
              f"eval render {name}: PredImg holds {len(os.listdir(frames))} files")
        shape = read_png(os.path.join(frames, "000000.png")).shape
        check(shape == (CROP_W, CROP_W, 3), f"eval render {name}: PredImg {shape}")
    render_fps = k * N_FRAMES / res["elapsed_s"]
    print(f"phase 16 render (cli/render_all.py --rawsize, W={CROP_W}, bfloat16, crop "
          f"auto): {k} scenes x {N_FRAMES} PredImg PNGs {CROP_W}x{CROP_W} in "
          f"{res['elapsed_s']:.2f} s incl. saves = {render_fps:.2f} frames/s; launches "
          f"{ {kk: v for kk, v in launches.items() if v} } {tag}")

    rng = np.random.default_rng(SEED + 16)
    for name, (seed, rows, cols) in SWEEP_SCENES.items():
        write_gt_video(os.path.join(gt_dir, f"{name}.mp4"),
                       synthetic_scene(seed, CROP_W, rows, cols)[0], rng)
    w = write_random_weights(os.path.join(root, "weights"), SEED)
    flags = ["--vgg16-pth", w["vgg16"], "--alexnet-pth", w["alexnet"],
             "--lpips-pth", w["lpips_alex"], "--i3d-pth", w["i3d"]]
    runs = {}
    for label, extra in (("plain", []), ("fluid", ["--fluid", "--flow-dir", scenes_dir,
                                                   "--input-dir", scenes_dir])):
        out = os.path.join(root, f"metric_{label}.json")
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with no_gc():
            got = eval_cli.main([pred_dir, gt_dir, *flags, *extra, "--out", out])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        with open(out) as f:
            check(json.load(f) == got, f"eval {label}: {out} differs from the returned dict")
        for key in EVAL_KEYS:
            check(sorted(got[key]) == sorted(SWEEP_SCENES),
                  f"eval {label}: {key} scored {sorted(got[key])}")
        totals = {key: got[key] for key in [f"Total{kk}" for kk in EVAL_KEYS] + ["TotalFVD"]}
        check(all(isinstance(v, float) and np.isfinite(v) for v in totals.values()),
              f"eval {label}: {totals}")
        runs[label] = {"s": secs, "peak": peak, "totals": totals}
        print(f"phase 16 eval {label} (cli/eval.py, all four weight flags, seeded random "
              f"weights): {k} scenes in {secs:.2f} s = {secs / k:.2f} s a scene; "
              + ", ".join(f"{kk} {v:.6g}" for kk, v in totals.items())
              + f"; peak memory {peak / 2**30:.3f} GiB allocated ({base / 2**30:.3f} "
              f"before) {tag}")
    check(runs["fluid"]["totals"]["TotalPSNR"] != runs["plain"]["totals"]["TotalPSNR"],
          "eval: the fluid composite left PSNR as it was")

    scene = next(iter(SWEEP_SCENES))
    vr = VideoReader(os.path.join(gt_dir, f"{scene}.mp4"))
    pred0 = _img01(os.path.join(pred_dir, scene, "PredImg", "000000.png"))
    gt0 = _gt01(vr[0], pred0.shape[1:3])
    vr.close()
    args = (w["vgg16"], w["alexnet"], w["lpips_alex"])
    card = metrics.PerceptualMetrics(*args)
    t0 = time.perf_counter()
    want = metrics.PerceptualMetrics(*args, device="cpu").all_metrics(pred0, gt0)
    cpu_s = time.perf_counter() - t0
    got = card.all_metrics(pred0, gt0)
    err = {kk: abs(got[kk] - want[kk]) / (1.0 if kk in ("PSNR", "SSIM") else abs(want[kk]))
           for kk in EVAL_KEYS}
    check(err["PSNR"] <= 1e-5 and err["SSIM"] <= 1e-5, f"eval card vs CPU: {err}")
    check(err["Perceptual"] <= 1e-4 and err["LPIPS"] <= 1e-4, f"eval card vs CPU: {err}")
    print(f"phase 16 metrics of one {CROP_W}^2 frame pair card vs CPU: PSNR |d| "
          f"{err['PSNR']:.3g}, SSIM |d| {err['SSIM']:.3g} (1e-5), Perceptual "
          f"{err['Perceptual']:.3g}, LPIPS {err['LPIPS']:.3g} relative (1e-4); the CPU "
          f"took {cpu_s:.2f} s {tag}")

    # scenes a and b's real and generated videos, scene a's loads timed
    videos, host = [], {}
    with no_gc():
        for i, name in enumerate(list(SWEEP_SCENES)[:2]):
            t0 = time.perf_counter()
            gen = np.concatenate([_img01(os.path.join(pred_dir, name, "PredImg",
                                                      f"{t:06d}.png")) for t in range(N_FRAMES)])
            t1 = time.perf_counter()
            vr = VideoReader(os.path.join(gt_dir, f"{name}.mp4"))
            raw = [vr[t] for t in range(N_FRAMES)]
            vr.close()
            t2 = time.perf_counter()
            real = np.concatenate([_gt01(f, gen.shape[1:3]) for f in raw])
            if i == 0:
                host = {"PNG load": (t1 - t0) * 1e3 / N_FRAMES,
                        "mp4 decode": (t2 - t1) * 1e3 / N_FRAMES,
                        "PIL GT resize": (time.perf_counter() - t2) * 1e3 / N_FRAMES}
            videos += [real, gen]
        t0 = time.perf_counter()
        pre = [torch.from_numpy(preprocess_video(v))[None] for v in videos]
        pre_ms = (time.perf_counter() - t0) * 1e3 / len(videos)
    fvd_card, fvd_cpu = FVD(w["i3d"]), FVD(w["i3d"], device="cpu")
    with torch.no_grad(), no_tf32():
        t0 = time.perf_counter()
        f_cpu = np.concatenate([fvd_cpu.model(x).numpy() for x in pre])
        cpu_s = time.perf_counter() - t0
        f_card = np.concatenate([fvd_card.model(x.to(fvd_card.device)).cpu().numpy()
                                 for x in pre])
    f_err = float(np.abs(f_card - f_cpu).max())
    check(f_err <= 1e-4 * np.abs(f_cpu).max(),
          f"I3D card vs CPU: {f_err:.3g} of max {np.abs(f_cpu).max():.3g}")
    fd = [frechet_distance(f[0::2], f[1::2]) for f in (f_card, f_cpu)]
    check(abs(fd[0] - fd[1]) <= 1e-3 * abs(fd[1]), f"FD card {fd[0]} vs CPU {fd[1]}")
    print(f"phase 16 I3D features of {len(videos)} preprocessed {N_FRAMES}-frame videos "
          f"(scenes {', '.join(list(SWEEP_SCENES)[:2])}, real and generated) card vs CPU: "
          f"max abs {f_err:.3g} of max |feature| {np.abs(f_cpu).max():.4g} (1e-4 of it); "
          f"their Frechet distance {fd[0]:.8g} vs {fd[1]:.8g} (1e-3 relative); the CPU "
          f"took {cpu_s:.2f} s {tag}")

    P = torch.as_tensor(pred0, device=card.device)
    G = torch.as_tensor(gt0, device=card.device)
    with torch.no_grad(), no_tf32():
        ms = {"PSNR": event_ms(lambda: float(metrics.psnr01(P, G))),
              "SSIM": event_ms(lambda: float(metrics.ssim01(P, G))),
              "Perceptual": event_ms(lambda: float(card.perceptual(P, G))),
              "LPIPS": event_ms(lambda: float(card.lpips(P, G)))}
        x = pre[1].to(fvd_card.device)
        i3d_ms = event_ms(lambda: fvd_card.model(x).sum().item(), reps=3)
    print(f"phase 16 per frame on the card ({CROP_W}^2, CUDA events, median of 5, "
          f"float32, TF32 off): " + ", ".join(f"{kk} {v:.3f} ms" for kk, v in ms.items())
          + f"; host per frame (scene {scene}): "
          + ", ".join(f"{kk} {v:.2f} ms" for kk, v in host.items())
          + f"; I3D {i3d_ms:.2f} ms a {N_FRAMES}-frame 224^2 video on the card (median "
          f"of 3), preprocess_video {pre_ms:.1f} ms a video on the host (mean of "
          f"{len(videos)}); phase 16 took {time.perf_counter() - t_phase:.1f} s {tag}")
    return {"render_fps": render_fps, "runs": runs, "metric_ms": ms, "host_ms": host,
            "i3d_ms": i3d_ms, "preprocess_ms": pre_ms}


# ---- phase 24: Multi-GPU on one card ---------------------------------------
#
# A 1-rank NCCL group formed in this process (file:// rendezvous in the
# output directory), destroyed at the end of the phase. The frame-sharded
# renders (SceneRenderer(shard_frames=True): this rank's block of frames,
# gathered by all_gather_into_tensor) against the unsharded ones, and the
# data-parallel stage-1 step (Trainer(mesh=...): BN moments and the Z
# maximum all-reduced, the gradients averaged by bucketed all-reduces)
# against the plain Trainer step through kernel_vs_plain_steps. One card
# holds one rank, so no multi-rank speed is measured here.


def _render_turns(fns: dict, reps: int = 2) -> dict:
    """Seconds of each render in turns (a, b, b, a, ...), synchronised,
    GC held off: {label: [seconds]}."""
    import torch

    order = list(fns)
    out = {k: [] for k in order}
    with no_gc():
        for i in range(reps):
            for k in (order if i % 2 == 0 else order[::-1]):
                t0 = time.perf_counter()
                fns[k]()
                torch.cuda.synchronize()
                out[k].append(time.perf_counter() - t0)
    return out


def multi_gpu_phase(dev, img, flow_np, region) -> dict:
    """Phase 24 (see above): the renders within 1e-4 of the unsharded ones
    with their launches (K1 once, K2 or K2-SLR N times) and frames/s in
    turns; the data-parallel step held against the plain unsharded step
    from one snapshot, its launches over 3 steps (K3 forward 6, backward 6,
    K7 3), its step ms beside the unsharded step's, the gradient
    all-reduce's ms (CUDA events) and bytes."""
    import torch
    import torch.distributed as dist

    from slrsfs_tpu_torch import kernels
    from slrsfs_tpu_torch.cli.render import SceneRenderer
    from slrsfs_tpu_torch.cli.train import build, to_device_batch
    from slrsfs_tpu_torch.config import Options
    from slrsfs_tpu_torch.parallel.mesh import make_mesh, shard_batch

    t_phase = time.perf_counter()
    rdzv = os.path.join(OUT_DIR, "phase24_rendezvous")
    if os.path.exists(rdzv):
        os.remove(rdzv)
    dist.init_process_group("nccl", init_method=f"file://{rdzv}", rank=0, world_size=1,
                            device_id=torch.device("cuda", torch.cuda.current_device()))
    res = {}
    try:
        mesh = make_mesh(1)
        check(mesh.backend == "nccl" and mesh.world == 1 and not mesh.owns_group,
              f"phase 24 mesh: {mesh}")
        for label, overrides, k2 in (("baseline", None, "splat_dual_normalize"),
                                     ("SLR", SLR_OPTS, "splat_dual_normalize_slr")):
            kw = dict(W=W, n_frames=N_FRAMES, dtype="float32", seed=SEED, sparsify_eps=0.0,
                      crop_decode="off", opt_overrides=overrides)
            r1 = SceneRenderer(**kw)
            rs = SceneRenderer(shard_frames=True, **kw)
            check(rs.mesh is not None and rs.mesh.world == 1, "phase 24 renderer's mesh")
            reg = region if overrides else None
            kernels.reset_counts()
            got = rs.frames(img, flow_np, alpha_region=reg)
            torch.cuda.synchronize()
            launches = kernels.counts()
            check(launches == {**{k.name: 0 for k in kernels.KERNELS},
                               "euler_compact_dual": 1, k2: N_FRAMES},
                  f"phase 24 sharded {label} render launches: {launches}")
            want = r1.frames(img, flow_np, alpha_region=reg)
            got, want = ({"PredImg": o} if torch.is_tensor(o) else o for o in (got, want))
            check(set(got) == set(want), f"phase 24 {label} outputs {sorted(got)}")
            err = max((got[k] - want[k]).abs().max().item() for k in want)
            check(err <= 1e-4, f"phase 24 sharded {label} render vs unsharded: max abs {err}")
            check(all(bool(torch.isfinite(v).all()) for v in got.values()),
                  f"phase 24 sharded {label} render not finite")
            del got, want
            secs = _render_turns({"sharded": lambda: rs.frames(img, flow_np, alpha_region=reg),
                                  "unsharded": lambda: r1.frames(img, flow_np,
                                                                 alpha_region=reg)})
            fps = {k: N_FRAMES / float(np.mean(v)) for k, v in secs.items()}
            res[label] = {"err": err, "fps": fps, "launches": launches}
            print(f"phase 24 {label} f32 render, frame-sharded over a 1-rank NCCL group "
                  f"(SceneRenderer(shard_frames=True), {N_FRAMES} frames {H}^2): max abs "
                  f"{err:.3g} from the unsharded render (limit 1e-4); launches "
                  f"{ {k: v for k, v in launches.items() if v} }; in turns (sharded, "
                  f"unsharded, unsharded, sharded, GC off): sharded {fps['sharded']:.2f} "
                  f"frames/s (runs {[round(x * 1e3, 1) for x in secs['sharded']]} ms), "
                  f"unsharded {fps['unsharded']:.2f} (runs "
                  f"{[round(x * 1e3, 1) for x in secs['unsharded']]} ms)")
            del r1, rs
        gc.collect()
        torch.cuda.empty_cache()

        opt = Options(W=W, batch_size=TRAIN_B)
        _, tr_dp = build(opt, train_max_steps=TRAIN_T, device=dev, seed=SEED, mesh=mesh)
        _, tr = build(opt, train_max_steps=TRAIN_T, device=dev, seed=SEED)
        for a, b in ((tr_dp.model, tr.model), (tr_dp.d_model, tr.d_model)):
            sa, sb = a.state_dict(), b.state_dict()
            check(all(torch.equal(sa[k], sb[k]) for k in sb),
                  "phase 24: the data-parallel and unsharded trainers start apart")
        batch_np = make_train_batch(np.random.default_rng(SEED), TRAIN_B, W)
        batch = to_device_batch(batch_np, dev)
        mine = to_device_batch(shard_batch(batch_np, mesh, batch_size=TRAIN_B), dev)
        res["path"] = kernel_vs_plain_steps(24, "data-parallel", tr_dp, {"dense": mine},
                                            ref=tr)
        tr_dp.train_step(mine)  # warm-up
        tr.train_step(batch)
        torch.cuda.synchronize()
        kernels.reset_counts()
        host, stages, logs = _step_times(tr_dp, mine, 3)
        launches = kernels.counts()
        want = {**{k.name: 0 for k in kernels.KERNELS}, "splat_dense_fwd": 6,
                "splat_dense_bwd": 6, "euler_phased": 3}
        check(launches == want, f"phase 24 data-parallel launches over 3 steps: {launches}")
        for k, v in logs.items():
            check(bool(torch.isfinite(v)), f"phase 24 data-parallel loss {k} = {v}")
        host1, stages1, _ = _step_times(tr, batch, 3)
        ar_bytes = sum(p.numel() * p.element_size() for p in tr_dp.g_params + tr_dp.d_params)
        dp_ms, one_ms = float(np.median(host)), float(np.median(host1))
        res.update(step_ms=dp_ms, step_ms_unsharded=one_ms, allreduce_ms=stages["all-reduce"],
                   allreduce_bytes=ar_bytes, launches=launches)
        print(f"phase 24 data-parallel stage-1 step on 1 NCCL rank (Trainer(mesh=...), "
              f"B={TRAIN_B} {W}^2 T={TRAIN_T}): {dp_ms:.1f} ms/step median (runs "
              f"{[round(x, 1) for x in host]} ms) beside the unsharded step's {one_ms:.1f} "
              f"(runs {[round(x, 1) for x in host1]} ms); gradient all-reduce "
              f"{stages['all-reduce']:.2f} ms (CUDA events) over {ar_bytes} bytes of G and D "
              f"gradients ({ar_bytes / 2**20:.1f} MiB) and the logs; stages "
              + ", ".join(f"{k} {v:.1f} ms" for k, v in stages.items())
              + f" (unsharded: " + ", ".join(f"{k} {v:.1f} ms" for k, v in stages1.items())
              + f"); launches over 3 steps { {k: v for k, v in launches.items() if v} }")
        del tr_dp, tr, batch, mine
    finally:
        dist.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t_phase
    print(f"phase 24 wall {res['seconds']:.1f} s (no multi-rank speed: one card, one rank)")
    return res


# ---- phase 25: the last modules: K6's two halves, ResNetDecoder ------------
#
# K6a (max_splat: the -1000 fill, then at one channel the window
# max-scatter, above a thread a (pixel, channel) and one atomic max a
# corner) and K6b (inverse_max_gather: a gather, no atomics),
# csrc/maxsplat.cu, against their plain versions bit for bit (±0 equal) at
# C = 1, 3, 4 and 65 on a ragged (2, 253, 232) grid with the special rows
# of the CPU tests (sentinel, integer shifts, border landings, off the
# grid), a smooth flow (every corner in its window) and a scattered one
# (most miss it); the pair
# against K6's one cooperative launch at the dense v2 render's (1, 256,
# 256, 1), bit for bit; the CUDA kernels one call of each runs
# (torch.profiler: 2 and 1); each timed at (1, 256, 256, 1) and (1, 768,
# 768, 1) beside its bytes bound, its plain version, for K6a one
# scatter_reduce_(amax) of the 4·B·HW corner rows, and the pair's sum
# beside K6's one launch. No render path launches K6a or K6b (phases 5 and
# 6 check their counts at 0). Then the plain ResNetDecoder on the five arch
# tables the JAX package builds, at ngf 64 and 64², card against CPU
# within 1e-4 of max |CPU|, TF32 off.

DECODER_TABLES = ("resnet_256W16UpDown64_nonorm", "resnet_256W5UpDown64BG_nonorm",
                  "resnet_256W8UpDown64SingleAlpha_nonorm",
                  "resnet_256W5UpDown64Layers_nonorm", "resnet_256W5UpDown64_nonorm")


def special_flow(rng, B: int, H_: int, W_: int):
    """A random flow (B, H_, W_, 2) with the CPU tests' special rows
    (tests/test_torch_maxsplat.py:_inputs), numpy."""
    flow = (rng.standard_normal((B, H_, W_, 2)) * 2.5).astype(np.float32)
    flow[0, 0::5] = max(H_, W_) + 1
    flow[0, 1::5] = [3.0, -2.0]
    flow[-1, 2::5] = [-0.75, -H_ + 0.5]
    flow[-1, :, -3:] = [W_ + 4.0, 0.25]
    return flow


def pair_inputs(dev, size: int):
    """z (1, size, size, 1) from a seed and the dense displacement at T_MID
    of the synthetic scene's flow at that size (the plain integrator)."""
    import torch

    from slrsfs_tpu_torch.ops.euler import euler_integrate_all_dual_plain

    _, flow_np = synthetic_scene(SEED, size)
    flow = torch.from_numpy(flow_np).to(dev)
    fl = euler_integrate_all_dual_plain(flow, N_FRAMES - 1, 1)[0][T_MID][None].contiguous()
    z = torch.from_numpy((np.random.default_rng(SEED + 25).standard_normal(
        (1, size, size, 1)) * 3.0).astype(np.float32)).to(dev)
    return z, fl


def smooth_flow(B: int, H_: int, W_: int):
    """A smooth flow (B, H_, W_, 2) that moves every pixel by a fractional,
    slowly turning displacement, numpy: the corners of each 8x16 tile meet
    in a few cells, all inside K6a's window."""
    yy, xx = np.mgrid[0:H_, 0:W_].astype(np.float32)
    flow = np.stack([1.5 * np.sin(yy / 17.0) + 0.6 * np.cos(xx / 23.0) + 0.37,
                     0.8 * np.cos(xx / 29.0) - 0.41], axis=-1).astype(np.float32)
    return np.ascontiguousarray(np.broadcast_to(flow, (B, H_, W_, 2)))


def scattered_flow(rng, B: int, H_: int, W_: int):
    """A flow (B, H_, W_, 2) that sends each pixel to a target drawn
    uniformly over the grid from ``rng``, numpy: the corners of a tile
    scatter, and most miss K6a's window."""
    yy, xx = np.mgrid[0:H_, 0:W_]
    tx = rng.uniform(0.0, W_ - 1.0, (B, H_, W_))
    ty = rng.uniform(0.0, H_ - 1.0, (B, H_, W_))
    return np.stack([tx - xx, ty - yy], axis=-1).astype(np.float32)


def max_splat_times(dev, prefix: str, label: str, z, fl, floor_ms: float) -> dict:
    """K6a, K6b and, at one channel, K6 on (z, fl), B = 1, each held bit for
    bit against its plain version first: ``kernel_times`` each, the plain
    versions as called, K6a's card work a call split by CUDA kernel
    (``launch_split``: the fill and the scatter), K6a's library call (one
    scatter_reduce_(amax) of the 4·HW corner rows into a -1000 map), the
    bytes bounds beside the launch floor ``floor_ms`` (an empty kernel's
    device time) and K6a's window misses."""
    import torch

    from slrsfs_tpu_torch.ops import maxwarp
    from slrsfs_tpu_torch.ops.splat import corners

    B, H_, W_, C = z.shape
    mx = maxwarp.max_splat(z, fl)
    gathered = maxwarp.inverse_max_gather(mx, fl, z)
    torch.cuda.synchronize()
    check(torch.equal(mx, maxwarp.max_splat_plain(z, fl)),
          f"{prefix} K6a {label}: kernel differs from plain")
    check(torch.equal(gathered, maxwarp.inverse_max_gather_plain(mx, fl, z)),
          f"{prefix} K6b {label}: kernel differs from plain")
    px = B * H_ * W_
    taps = corners((torch.arange(W_, device=dev)[None, :] + fl[0, ..., 0]).reshape(-1),
                   (torch.arange(H_, device=dev)[:, None] + fl[0, ..., 1]).reshape(-1),
                   H_, W_)
    lin_all = torch.cat([lin for lin, _, _ in taps])[:, None].expand(-1, C).contiguous()
    val_all = torch.cat([torch.where(inside[:, None], z[0].reshape(-1, C) * w[:, None],
                                     float("-inf")) for _, w, inside in taps])
    lib_map = torch.full((H_ * W_, C), -1000.0, device=dev)
    res = {
        # K6a: inp and flow in, out once; per pixel ~16 ops for the corners
        # and weights, per element 4 products and 4 maxes
        "K6a": dict(kernel_times(lambda: maxwarp.max_splat(z, fl), reps=50),
                    plain_ms=cuda_time(lambda: maxwarp.max_splat_plain(z, fl), reps=5),
                    bound=bound(px * (4 * C + 8 + 4 * C), px * (16 + 8 * C)),
                    lib=kernel_times(lambda: lib_map.scatter_reduce_(
                        0, lin_all, val_all, reduce="amax"), reps=50),
                    split=launch_split(lambda: maxwarp.max_splat(z, fl))),
        # K6b: maxmap, flow and init in, out once; ~16 ops a pixel, 4 maxes
        # an element
        "K6b": dict(kernel_times(lambda: maxwarp.inverse_max_gather(mx, fl, z), reps=50),
                    plain_ms=cuda_time(lambda: maxwarp.inverse_max_gather_plain(mx, fl, z),
                                       reps=5),
                    bound=bound(px * (4 * C + 8 + 4 * C + 4 * C), px * (16 + 4 * C)),
                    lib=None),
        "floor_ms": floor_ms,
        "misses": window_misses("max splat", fl, C),
    }
    if C == 1:
        res["K6"] = kernel_times(lambda: maxwarp.maximum_warp_norm_splat(z, fl), reps=50)
    for name, launches in (("K6a", 2), ("K6b", 1)):
        r = res[name]
        lib = "none: no single PyTorch call" if r["lib"] is None else (
            f"scatter_reduce_(amax) of the {4 * px} corner rows {fmt_times(r['lib'])}")
        split = f"; split {fmt_split(r['split'])}" if "split" in r else ""
        print(f"{prefix} {name} {label}: {fmt_times(r)}{split}; plain {r['plain_ms']:.4f} ms; "
              f"bound {r['bound'][0]:.5f} ms by {r['bound'][1]}; launch floor {floor_ms:.5f} "
              f"ms ({launches} launches {launches * floor_ms:.5f}); library {lib}")
    print(f"{prefix} K6a {label}: {res['misses']}")
    pair = res["K6a"]["ms"] + res["K6b"]["ms"]
    beside = (f" beside K6's one cooperative launch {fmt_times(res['K6'])} "
              f"({pair / res['K6']['ms']:.2f}x)" if C == 1 else "")
    print(f"{prefix} K6a + K6b {label}: device {pair:.4f} ms{beside}")
    return res


def maxsplat_shapes(dev) -> list:
    """(label, z, flow) at the shapes ``--maxsplat-in`` times: (1, 256,
    256, 1) and (1, 768, 768, 1) on the synthetic scene's displacement at
    T_MID (``pair_inputs``), (1, 256, 256, 65) on the same flow (a shape
    above one channel, where maximum_warp_norm_splat would run the pair:
    no caller of the port sends one, models/baseline.py:z_normalize passes
    C = 1) and (1, 256, 256, 1) on a scattered flow."""
    import torch

    z256, fl256 = pair_inputs(dev, W)
    z768, fl768 = pair_inputs(dev, CROP_W)
    z65 = torch.from_numpy((np.random.default_rng(SEED + 27).standard_normal((1, H, W, 65))
                            * 3.0).astype(np.float32)).to(dev)
    scattered = torch.from_numpy(scattered_flow(np.random.default_rng(SEED + 28), 1, H, W)).to(dev)
    return [(f"(1, {H}, {W}, 1)", z256, fl256),
            (f"(1, {CROP_W}, {CROP_W}, 1)", z768, fl768),
            (f"(1, {H}, {W}, 65)", z65, fl256),
            (f"(1, {H}, {W}, 1), scattered flow", z256, scattered)]


def launch_floor(probe, dll) -> dict:
    """``kernel_times`` of one empty kernel (``tools/maxsplat_probe.py``),
    the faster of two takes: the first take in a process once read 0.0117
    ms against 0.0019 for every later one."""
    return min((kernel_times(lambda: probe.launch_floor(dll), reps=50) for _ in range(2)),
               key=lambda t: t["ms"])


def maxsplat_in(tree: str) -> int:
    """``python3 chip_smoke.py --maxsplat-in TREE``: K6a, K6b and the pair
    beside K6 (``max_splat_times``) at ``maxsplat_shapes`` on the package of
    another unpacked tree of this repository (its kernels built in
    TREE/build), beside the launch floor (this checkout's
    ``tools/maxsplat_probe.py``), to compare commits on one card
    (slrsfs_tpu_torch/tools/compare.sh)."""
    dev = use_tree(tree)
    from slrsfs_tpu_torch import kernels

    probe = tool_module("maxsplat_probe")
    job = probe.start_build()
    kernels.build_all()
    dll = probe.finish_build(job)
    floor = launch_floor(probe, dll)
    print(f"maxsplat launch floor (an empty kernel of one warp, tools/maxsplat_probe.py): "
          f"{fmt_times(floor)}")
    for label, z, fl in maxsplat_shapes(dev):
        max_splat_times(dev, "maxsplat", label, z, fl, floor["ms"])
    return 0


def decoder_tables_phase(dev) -> float:
    """The plain ResNetDecoder on each of DECODER_TABLES at ngf 64, 64²,
    random weights from a seed: card against CPU within 1e-4 of max |CPU|;
    returns the largest share of max."""
    import torch

    from slrsfs_tpu_torch.config import Options
    from slrsfs_tpu_torch.models.baseline import init_random_weights
    from slrsfs_tpu_torch.nn.archs import get_resnet_arch
    from slrsfs_tpu_torch.nn.resnets import ResNetDecoder

    worst = 0.0
    for i, table in enumerate(DECODER_TABLES):
        opt = Options(ngf=64, refine_model_type=table, addtional_decoder_output=0)
        dec = ResNetDecoder(opt).eval()
        with torch.no_grad():
            init_random_weights(dec, SEED + i)
        c_in = get_resnet_arch(table, opt)["layers_dec"][0]
        x = torch.from_numpy(np.random.default_rng(SEED + i).standard_normal(
            (1, c_in, 64, 64)).astype(np.float32))
        with torch.no_grad():
            want = dec(x)
            got = dec.to(dev)(x.to(dev)).cpu()
        scale = want.abs().max().item()
        err = (got - want).abs().max().item()
        check(bool(torch.isfinite(want).all()) and scale > 0,
              f"phase 25 ResNetDecoder {table}: CPU output not finite or all 0")
        check(tuple(got.shape) == tuple(want.shape) and err <= 1e-4 * scale,
              f"phase 25 ResNetDecoder {table}: card vs CPU {err} of max {scale}")
        worst = max(worst, err / scale)
        print(f"phase 25 ResNetDecoder {table} (ngf 64, in {c_in}, 64^2 -> "
              f"{tuple(want.shape)}): card vs CPU max abs {err:.3g} = {err / scale:.3g} of "
              f"max {scale:.3g} (limit 1e-4)")
        del dec
    return worst


MAX_SPLAT_GRID = (2, 253, 232)  # B, H, W: a ragged grid that no 8x16 tile divides
MAX_SPLAT_CHANNELS = (1, 3, 4, 65)


def max_splat_phase(dev, z4, fl_mid, probe, probe_dll) -> dict:
    """Phase 25 (see above); ``probe``, ``probe_dll``: this checkout's
    ``tools/maxsplat_probe.py`` and its library, for the launch floor.
    Returns {"err", "K6a", "K6b", "K6", "per_call", "floor", ...}."""
    import torch

    from slrsfs_tpu_torch import kernels
    from slrsfs_tpu_torch.ops import maxwarp

    t_phase = time.perf_counter()
    lib = kernels.MAX_SPLAT
    geometry = ((lib.query("max_splat_tile_rows"), lib.query("max_splat_tile_cols")),
                lib.query("max_splat_window_cells"))
    mirror = (maxwarp.MAX_SPLAT_TILE, maxwarp.MAX_SPLAT_WINDOW_CELLS)
    check(geometry == mirror, f"phase 25: K6a's library reports tile and window "
          f"{geometry}, ops/maxwarp.py {mirror}")
    rng = np.random.default_rng(SEED + 26)
    err = 0.0
    B_, H_, W_ = MAX_SPLAT_GRID
    flows = {"special rows": special_flow(rng, B_, H_, W_), "smooth": smooth_flow(B_, H_, W_),
             "scattered": scattered_flow(rng, B_, H_, W_)}
    for kind, fl_np in flows.items():
        fl = torch.from_numpy(fl_np).to(dev)
        misses = window_misses("max splat", fl, 1)
        print(f"phase 25 {kind} flow on {MAX_SPLAT_GRID}: K6a at one channel {misses}")
        for C in MAX_SPLAT_CHANNELS:
            case = f"phase 25 ({B_}, {H_}, {W_}, {C}), {kind}"
            z = torch.from_numpy((rng.standard_normal((B_, H_, W_, C)) * 3.0)
                                 .astype(np.float32)).to(dev)
            kernels.reset_counts()
            mx = maxwarp.max_splat(z, fl)
            for maxmap in (mx, torch.randn_like(z) * 3.0):
                got = maxwarp.inverse_max_gather(maxmap, fl, z)
                want = maxwarp.inverse_max_gather_plain(maxmap, fl, z)
                torch.cuda.synchronize()
                check(torch.equal(got, want), f"{case}: K6b differs from plain")
                err = max(err, (got - want).abs().max().item())
            want_mx = maxwarp.max_splat_plain(z, fl)
            torch.cuda.synchronize()
            check(torch.equal(mx, want_mx), f"{case}: K6a differs from plain")
            err = max(err, (mx - want_mx).abs().max().item())
            n = kernels.counts()
            check(n["max_splat"] == 1 and n["inverse_max_gather"] == 2, f"{case}: launches {n}")
            norm = maxwarp.maximum_warp_norm_splat(z, fl)  # K6 at one channel, else the pair
            torch.cuda.synchronize()
            check(torch.equal(norm, maxwarp.maximum_warp_norm_splat_plain(z, fl)),
                  f"{case}: maximum_warp_norm_splat differs from plain")
            beside = ""
            if C == 1:
                check(torch.equal(maxwarp.inverse_max_gather(mx, fl, z), norm),
                      f"{case}: K6a -> K6b differs from K6's one launch")
                beside = "; the pair equals K6's one launch"
            print(f"{case}: K6a, K6b bit-exact (±0 equal){beside}; "
                  f"{int((want_mx == -1000.0).all(-1).sum())} cells nothing reaches")
    kernels.reset_counts()
    pair = maxwarp.inverse_max_gather(maxwarp.max_splat(z4, fl_mid), fl_mid, z4)
    one = maxwarp.maximum_warp_norm_splat(z4, fl_mid)
    torch.cuda.synchronize()
    n = kernels.counts()
    check(n["max_splat"] == n["inverse_max_gather"] == n["maximum_warp_norm_splat"] == 1,
          f"phase 25 pair vs K6 launches {n}")
    check(torch.equal(pair, one), "phase 25 K6a -> K6b differs from K6's one launch")
    print(f"phase 25 K6a -> K6b against K6's one launch at the dense v2 render's "
          f"{tuple(z4.shape)}: bit-exact")
    z3 = z4.repeat(1, 1, 1, 3)
    per_call = {"K6a": kernels_per_call(lambda: maxwarp.max_splat(z4, fl_mid), reps=8),
                "K6a, C = 3": kernels_per_call(lambda: maxwarp.max_splat(z3, fl_mid), reps=8),
                "K6b": kernels_per_call(lambda: maxwarp.inverse_max_gather(
                    pair, fl_mid, z4), reps=8)}
    # K6a's two kernels (the fill, then at one channel the window
    # max-scatter, above the scatter a thread a (pixel, channel)) and the
    # run gather, by name
    want_names = {"K6a": ("max_splat_fill_kernel", "max_splat_window_kernel"),
                  "K6a, C = 3": ("max_splat_fill_kernel", "max_splat_kernel"),
                  "K6b": ("inverse_max_gather_run_kernel",)}
    for name, (k, names) in per_call.items():
        # the trace must hold exactly the entry's own kernels; CUPTI now and
        # then drops a few microsecond-long kernels' events (K6b once showed
        # 0.5 a call in three traces in a row), so a count below the
        # design's is printed as a drop, one above fails
        want = want_names[name]
        check(len(names) == len(want) and all(w in n for w, n in zip(want, names))
              and 0 < k <= len(want),
              f"phase 25 {name}: {k} CUDA kernels per call ({names})")
        drop = "" if k == len(want) else f" (the trace dropped events: {len(want)} by design)"
        print(f"phase 25 {name}: {k:g} CUDA kernels per call{drop} (torch.profiler: "
              f"{', '.join(names)})")
    floor = launch_floor(probe, probe_dll)
    print(f"phase 25 launch floor (an empty kernel of one warp, tools/maxsplat_probe.py): "
          f"{fmt_times(floor)}")
    res = {"err": err, "per_call": per_call, "floor": floor["ms"]}
    res.update(max_splat_times(dev, "phase 25", f"(1, {H}, {W}, 1)", z4, fl_mid, floor["ms"]))
    z768, fl768 = pair_inputs(dev, CROP_W)
    res[f"{CROP_W}"] = max_splat_times(dev, "phase 25", f"(1, {CROP_W}, {CROP_W}, 1)", z768,
                                       fl768, floor["ms"])
    del z768, fl768
    res["decoder"] = decoder_tables_phase(dev)
    res["seconds"] = time.perf_counter() - t_phase
    print(f"phase 25 wall {res['seconds']:.1f} s")
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_main = time.perf_counter()
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
    probe = tool_module("chase_probe")  # K1's and K4's latency bound
    probe_job = probe.start_build()
    ms_probe = tool_module("maxsplat_probe")  # the launch floor
    ms_probe_job = ms_probe.start_build()
    times = kernels.build_all()
    probe_dll = probe.finish_build(probe_job)
    ms_probe_dll = ms_probe.finish_build(ms_probe_job)
    print(f"phase 1 build: {time.perf_counter() - t0:.1f} s wall (with "
          f"tools/chase_probe.cu and tools/maxsplat_probe.cu), "
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
    print(f"phase 2 start: {time.perf_counter() - t_main:.1f} s into the script")
    lat = euler_latency(probe_dll, probe, flow, positions)
    print(f"phase 2 latency bounds (tools/chase_probe.py, {N_FRAMES} dependent "
          f"gathers a trajectory, no stores): K1's rows {lat['K1']:.4f} ms, K4's "
          f"grid {lat['K4']:.4f} ms")
    quarter = torch.round(flow * 4.0) / 4.0  # half-integer rounding ties
    leaving = leaving_flow(dev)  # most trajectories leave within a few steps
    k1_err = 0.0
    k1_plain = {}
    for label, m in (("scene", flow), ("quarter-pixel", quarter), ("leaving", leaving)):
        kf, kb = euler_compact_dual(m, positions, N_FRAMES - 1, N_FRAMES)
        pf, pb = euler_compact_dual_plain(m, positions, N_FRAMES - 1, N_FRAMES)
        torch.cuda.synchronize()
        check(torch.equal(kf, pf) and torch.equal(kb, pb),
              f"K1 {label}: kernel differs from plain")
        k1_err = max(k1_err, (kf - pf).abs().max().item(),
                     (kb - pb).abs().max().item())
        n_oob = int((kb[-1, :, 0] > W).sum())
        n_oob4 = int((kb[4, :, 0] > W).sum())
        print(f"phase 2 K1 {label}: P={P} steps={N_FRAMES - 1}/{N_FRAMES} "
              f"bit-exact; {n_oob} backward trajectories left the frame ({n_oob4} "
              f"within 4 steps)")
        k1_plain[label] = (pf, pb)
    del kf, kb, pf, pb
    disp_f, disp_b = k1_plain.pop("quarter-pixel")
    del k1_plain
    special = disp_f[T_MID].clone()  # sentinel, integer shifts, border landings
    special[0::3] = float(max(H, W) + 1)
    special[1::3] = torch.tensor([3.0, -2.0], device=dev)
    special[2::3] = torch.tensor([-0.75, -127.5], device=dev)
    k4 = k4_phase(dev, flow, lat)

    # ---- phase 3: K2, both epilogues, against the plain versions -----
    print(f"phase 3 start: {time.perf_counter() - t_main:.1f} s into the script")
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
                # moves by percents. Each element is held against the f32
                # sums of the same rows by the bound no order can break.
                ref32 = plain(st["u_mov"], positions, valid, da, db, a, b,
                              st["u_static"], torch.float32)
                bnd = k2_bf16_bound(name, ref32, u_mov, st["u_static"].to(acc_dtype),
                                    positions, valid, da, db, a, b, out_dtype)
                cb = bf16_cell_check(f"{name} {label}", o, ref, ref32, bnd)
                del bnd
                # cells no moving tap reaches keep u_static's exact zeros
                reached = softsplat_sum_at_quad_dual_plain(
                    u_mov.abs(), positions, da, db, a, b, H, W)[..., :o.shape[-1]] != 0
                check(torch.equal((o == 0)[~reached], (ref == 0)[~reached]),
                      f"{name} {label}: zeros of unreached cells differ")
                st["err_bf16"] = max(st["err_bf16"], err)
                limit = (f"{fmt_bf16(cb)}; max |out| {ref.float().abs().max().item():.3g}; "
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
    print(f"phase 4 start: {time.perf_counter() - t_main:.1f} s into the script")
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
    print(f"phase 5 start: {time.perf_counter() - t_main:.1f} s into the script")
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
                        sparsify_eps=0.0, crop_decode="off")
    rbf = SceneRenderer(W=W, n_frames=N_FRAMES, dtype="bfloat16", seed=SEED,
                        sparsify_eps=0.0, crop_decode="off")
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
                          sparsify_eps=0.0, crop_decode="off",
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
    print(f"phase 6 start: {time.perf_counter() - t_main:.1f} s into the script")
    slr = {
        "float32": SceneRenderer(W=W, n_frames=N_FRAMES, dtype="float32",
                                 seed=SEED, sparsify_eps=0.0, crop_decode="off",
                                 opt_overrides=SLR_OPTS),
        "bfloat16": SceneRenderer(W=W, n_frames=N_FRAMES, dtype="bfloat16",
                                  seed=SEED, sparsify_eps=0.0, crop_decode="off",
                                  opt_overrides=SLR_OPTS),
        "float32 v2": SceneRenderer(W=W, n_frames=N_FRAMES, dtype="float32",
                                    seed=SEED, sparsify_eps=0.0, crop_decode="off",
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
    print(f"phase 7 start: {time.perf_counter() - t_main:.1f} s into the script")
    k1_cases = [c for m, label in ((flow, "scene"), (leaving, "leaving"))
                for c in euler_cases(m, positions, label) if c["name"] == "K1"]
    k1_lat = {"K1": lat["K1"]}  # the leaving flow's chains end early: no latency bound
    k1_t = euler_times(k1_cases[:1], k1_lat, "phase 7")
    k1_t.update(euler_times(k1_cases[1:], {}, "phase 7"))
    ms_k1 = k1_t["K1 scene"]["ms"]
    k1_bound = k1_t["K1 scene"]["bound"]
    ms_k1_plain = cuda_time(lambda: euler_compact_dual_plain(
        flow, positions, N_FRAMES - 1, N_FRAMES), reps=3, warmup=1)
    print(f"phase 7 K1 plain {ms_k1_plain:.3f} ms (as called)")
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
        pack = rollout._slr_pack_fn(
            mv2.opt, fs, z, a_fl, torch.sigmoid(a_bg), positions, valid, static,
            plain=False)[0]
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
    print(f"phases 8-11 start: {time.perf_counter() - t_main:.1f} s into the script")
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

    # ---- phases 12-14: crop decode at 768², the sweep, stages, trace ---
    print(f"phases 12-14 start: {time.perf_counter() - t_main:.1f} s into the script")
    gc.collect()
    torch.cuda.empty_cache()
    crop = crop_phase(dev, probe, probe_dll)
    sweep = sweep_phase()
    staged = stages_phase(crop)
    del crop["renderer"]
    gc.collect()
    torch.cuda.empty_cache()

    # ---- phase 15: motion from hints at 768² ---------------------------
    print(f"phase 15 start: {time.perf_counter() - t_main:.1f} s into the script")
    motion = motion_phase(dev, probe, probe_dll)

    # ---- phase 16: the CLAW evaluation at 768² -------------------------
    print(f"phase 16 start: {time.perf_counter() - t_main:.1f} s into the script")
    gc.collect()
    torch.cuda.empty_cache()
    ev = eval_phase(sweep["scenes_dir"], smi)

    # ---- phase 17: the SLR stage-3 step at full width -----------------
    print(f"phase 17 start: {time.perf_counter() - t_main:.1f} s into the script")
    gc.collect()
    torch.cuda.empty_cache()
    slr_train = slr_training_phase(dev)

    # ---- phases 18-21: the embedded-motion stages, K7's backward, the
    print(f"phases 18-21 start: {time.perf_counter() - t_main:.1f} s into the script")
    # ---- motion GAN and bg stage 2, the CLI chains ----------------------
    gc.collect()
    torch.cuda.empty_cache()
    emb = embedded_phase(dev)
    k7b = k7_bwd_phase(dev, emb.pop("k7_in"))
    jt = emb["joint"]
    k3k7 = jt["k7"]["ms"] + k7b["ms"] + 2 * jt["k3_fwd"]["ms"] + 2 * jt["k3_bwd"]["ms"]
    print(f"phase 19 joint step with the kernels (B={TRAIN_B}): G forward "
          f"{jt['stages']['G forward']:.1f} ms, of which K7 {jt['k7']['ms']:.4f} ms and K3 "
          f"forward x2 {2 * jt['k3_fwd']['ms']:.3f} ms; G backward "
          f"{jt['stages']['G backward']:.1f} ms, of which K7 backward {k7b['ms']:.4f} ms and "
          f"K3 backward x2 {2 * jt['k3_bwd']['ms']:.3f} ms; K3 and both K7s "
          f"{100 * k3k7 / jt['step_ms']:.2f} % of the step")
    others = other_stages_phase(dev)
    gc.collect()
    torch.cuda.empty_cache()
    stage_chains_phase(scene_dir, img_path, flow_path)

    # ---- phase 23: the rest of training ---------------------------------
    print(f"phase 23 start: {time.perf_counter() - t_main:.1f} s into the script")
    gc.collect()
    torch.cuda.empty_cache()
    rest = rest_of_training_phase(dev)

    # ---- phase 24: Multi-GPU on one card ------------------------------
    print(f"phase 24 start: {time.perf_counter() - t_main:.1f} s into the script")
    gc.collect()
    torch.cuda.empty_cache()
    multi = multi_gpu_phase(dev, img, flow_np, region)

    # ---- phase 25: K6's two halves, the plain ResNetDecoder -------------
    print(f"phase 25 start: {time.perf_counter() - t_main:.1f} s into the script")
    gc.collect()
    torch.cuda.empty_cache()
    halves = max_splat_phase(dev, z4, fl_mid, ms_probe, ms_probe_dll)

    # ---- phase 22: summary -------------------------------------------
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
        *[row(name, "slrsfs_tpu_torch/csrc/maxsplat.cu", f"slrsfs_tpu/ops/splat.py:{line}",
              launches[name], halves["err"], halves[key]["ms"], halves[key]["plain_ms"],
              halves[key]["bound"], None if halves[key]["lib"] is None
              else halves[key]["lib"]["ms"])
          for name, key, line in (("max_splat", "K6a", 214),
                                  ("inverse_max_gather", "K6b", 236))],
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
        row(f"splat_dense_fwd (SLR stage 3, C={SLR_TRAIN_C})",
            "slrsfs_tpu_torch/csrc/splat_dense.cu", "slrsfs_tpu/ops/splat.py:139",
            slr_train["launches"]["splat_dense_fwd"], slr_train["fwd_err"],
            slr_train["ms_fwd"], slr_train["plain_fwd"], slr_train["bound_fwd"],
            slr_train["lib_fwd"]),
        row(f"splat_dense_bwd (SLR stage 3, C={SLR_TRAIN_C})",
            "slrsfs_tpu_torch/csrc/splat_dense.cu", "slrsfs_tpu/ops/splat.py:111",
            slr_train["launches"]["splat_dense_bwd"], slr_train["bwd_err"],
            slr_train["ms_bwd"], slr_train["plain_bwd"], slr_train["bound_bwd"], None),
        row("euler_phased (SLR stage 3, 50 % moving)", "slrsfs_tpu_torch/csrc/euler_phased.cu",
            "slrsfs_tpu/ops/euler.py:249", slr_train["launches"]["euler_phased"], 0.0,
            slr_train["k7"]["ms"], slr_train["k7"]["plain_ms"], slr_train["k7"]["bound"],
            None),
        row("euler_phased_bwd", "slrsfs_tpu_torch/csrc/euler_phased.cu",
            "slrsfs_tpu/ops/euler.py:249", jt["launches"]["euler_phased_bwd"], k7b["err"],
            k7b["ms"], k7b["plain_ms"], k7b["bound"], None),
        row("splat_dense_fwd (joint motion step)", "slrsfs_tpu_torch/csrc/splat_dense.cu",
            "slrsfs_tpu/ops/splat.py:139", jt["launches"]["splat_dense_fwd"], jt["fwd_err"],
            jt["k3_fwd"]["ms"], jt["k3_fwd"]["plain_ms"], jt["k3_fwd"]["bound"],
            jt["k3_fwd"]["lib_ms"]),
        row("splat_dense_bwd (joint motion step)", "slrsfs_tpu_torch/csrc/splat_dense.cu",
            "slrsfs_tpu/ops/splat.py:111", jt["launches"]["splat_dense_bwd"], jt["bwd_err"],
            jt["k3_bwd"]["ms"], jt["k3_bwd"]["plain_ms"], jt["k3_bwd"]["bound"], None),
        row("euler_phased (joint motion step, predicted motion)",
            "slrsfs_tpu_torch/csrc/euler_phased.cu", "slrsfs_tpu/ops/euler.py:249",
            jt["launches"]["euler_phased"], jt["k7"]["err"], jt["k7"]["ms"],
            jt["k7"]["plain_ms"], jt["k7"]["bound"], None),
        *[row(f"splat_dense_{d}_bf16 ({label})", "slrsfs_tpu_torch/csrc/splat_dense.cu",
              f"slrsfs_tpu/ops/splat.py:{79 if d == 'fwd' else 111}",
              r["launches"][f"splat_dense_{d}_bf16"], r["k3"][f"{d}_err"], r["k3"][d]["ms"],
              r["k3"][f"plain_{d}"], r["k3"][f"bound_{d}"],
              r["k3"]["lib_fwd"] if d == "fwd" else None)
          for label, r in ((f"bf16 stage 1, C={TRAIN_C}", rest["bf16"]),
                           (f"bf16 SLR stage 3, C={SLR_TRAIN_C}", rest["bf16_slr"]))
          for d in ("fwd", "bwd")],
        row("fused_conv3x3_relu_conv3x3", "slrsfs_tpu_torch/csrc/fused_conv.cu",
            "tools/pallas_conv_prototype.py:118", k9["launches"], k9["err"],
            k9["ms"], k9["plain_ms"], k9["bound"], k9["lib_ms"]),
    ]
    c, ck = crop["crop"], crop["kernels"]
    window = f"crop window {c.hc}x{c.wc} at {CROP_W}^2"
    rows_out += [
        row(f"euler_compact_dual ({CROP_W}^2 grid, P={crop['P']}, crop render)",
            "slrsfs_tpu_torch/csrc/euler.cu", "slrsfs_tpu/ops/euler.py:145",
            crop["launches"]["float32"]["euler_compact_dual"], ck["K1"]["err"],
            ck["K1"]["ms"], ck["K1"]["plain_ms"], ck["K1"]["bound"], None),
        row(f"splat_dual_normalize ({window})", "slrsfs_tpu_torch/csrc/splat.cu",
            "slrsfs_tpu/ops/splat.py:390",
            crop["launches"]["float32"]["splat_dual_normalize"], ck["K2"]["err"],
            ck["K2"]["ms"], ck["K2"]["plain_ms"], ck["K2"]["bound"],
            ck["K2"]["lib"]["ms"]),
        row(f"maximum_warp_norm_sparse ({window}; SLR v2 crop render)",
            "slrsfs_tpu_torch/csrc/maxwarp.cu", "slrsfs_tpu/ops/splat.py:492",
            crop["launches"]["SLR float32 v2"]["maximum_warp_norm_sparse"],
            ck["K5"]["err"], ck["K5"]["ms"], ck["K5"]["plain_ms"], ck["K5"]["bound"],
            ck["K5"]["lib"]["ms"]),
    ]
    mk, grid = motion["kernels"], f"{CROP_W}^2 grid, P={motion['P']}, motion from hints"
    rows_out += [
        row(f"euler_compact_dual ({grid})", "slrsfs_tpu_torch/csrc/euler.cu",
            "slrsfs_tpu/ops/euler.py:145", motion["launches"]["euler_compact_dual"],
            mk["K1"]["err"], mk["K1"]["ms"], mk["K1"]["plain_ms"], mk["K1"]["bound"], None),
        row(f"splat_dual_normalize ({grid})", "slrsfs_tpu_torch/csrc/splat.cu",
            "slrsfs_tpu/ops/splat.py:390", motion["launches"]["splat_dual_normalize"],
            mk["K2"]["err"], mk["K2"]["ms"], mk["K2"]["plain_ms"], mk["K2"]["bound"],
            mk["K2"]["lib"]["ms"]),
    ]
    print("phase 22 render fps: " + ", ".join(f"{k} {v:.2f}" for k, v in fps.items())
          + f"; training step {train['step_ms']:.1f} ms at B={train['B']} "
          f"({train['B'] / train['step_ms'] * 1e3:.2f} samples/s); SLR stage-3 step "
          f"{slr_train['step_ms']:.1f} ms at B={slr_train['B']} "
          f"({slr_train['B'] / slr_train['step_ms'] * 1e3:.2f} samples/s; compact "
          f"{slr_train['step_ms_compact']:.1f} ms), peak {slr_train['peak'] / 2**30:.2f} GiB")
    print(f"phase 22 training steps (B={TRAIN_B}, 256^2): joint {jt['step_ms']:.1f} ms "
          f"({TRAIN_B / jt['step_ms'] * 1e3:.2f} samples/s, peak {jt['peak'] / 2**30:.2f} "
          f"GiB), fix-motion {emb['fix-motion']['step_ms']:.1f} ms "
          f"({TRAIN_B / emb['fix-motion']['step_ms'] * 1e3:.2f} samples/s, peak "
          f"{emb['fix-motion']['peak'] / 2**30:.2f} GiB), bg stage 2 "
          f"{others['bg']['step_ms']:.1f} ms (peak {others['bg']['peak'] / 2**30:.2f} GiB), "
          f"motion GAN {others['SPADE_unet_mask_motion']['step_ms']:.1f} ms (peak "
          f"{others['SPADE_unet_mask_motion']['peak'] / 2**30:.2f} GiB)")
    print(f"phase 22 {CROP_W}^2 frames/s: " + ", ".join(
        f"{k} {v:.2f}" for k, v in {**crop["fps"], **motion["fps"]}.items())
        + f"; sweep {sweep['scenes_per_hour']:.1f} scenes/hour; device busy "
        f"{100.0 * staged['busy_share']:.1f} % of a traced crop render")
    print(f"phase 22 phase 24 (1 NCCL rank): sharded renders baseline "
          f"{multi['baseline']['fps']['sharded']:.2f} / SLR {multi['SLR']['fps']['sharded']:.2f} "
          f"frames/s (unsharded {multi['baseline']['fps']['unsharded']:.2f} / "
          f"{multi['SLR']['fps']['unsharded']:.2f}); data-parallel step "
          f"{multi['step_ms']:.1f} ms (unsharded {multi['step_ms_unsharded']:.1f}, all-reduce "
          f"{multi['allreduce_ms']:.2f}); phase wall {multi['seconds']:.1f} s")
    print(f"phase 22 phase 25: K6a {halves['K6a']['ms']:.4f} + K6b {halves['K6b']['ms']:.4f} "
          f"ms against K6's one launch {halves['K6']['ms']:.4f} ms at (1, {H}, {W}, 1) "
          f"(launch floor {halves['floor']:.5f} ms); {CROP_W}^2 K6a "
          f"{halves[f'{CROP_W}']['K6a']['ms']:.4f} + K6b {halves[f'{CROP_W}']['K6b']['ms']:.4f}"
          f" ms; ResNetDecoder card vs CPU {halves['decoder']:.3g} of max; phase wall "
          f"{halves['seconds']:.1f} s")
    print(f"phase 22 CLAW eval of {len(SWEEP_SCENES)} {CROP_W}^2 scenes (--rawsize render "
          f"{ev['render_fps']:.2f} frames/s): plain {ev['runs']['plain']['s']:.2f} s, fluid "
          f"{ev['runs']['fluid']['s']:.2f} s; all checks passed")
    print(f"phase 22 whole script {time.perf_counter() - t_main:.1f} s (build included)")
    print(smi)
    print(json.dumps({"kernels": rows_out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    modes = {"--maxwarp-in": maxwarp_in, "--k2-in": k2_in, "--k3-in": k3_in,
             "--k1-in": k1_in, "--k7bwd-in": k7bwd_in, "--maxsplat-in": maxsplat_in}
    if len(sys.argv) == 3 and sys.argv[1] in modes:
        sys.exit(modes[sys.argv[1]](sys.argv[2]))
    check(len(sys.argv) == 1,
          f"usage: {sys.argv[0]} [--maxwarp-in TREE | --k2-in TREE | --k3-in TREE "
          f"| --k1-in TREE | --k7bwd-in TREE | --maxsplat-in TREE]")
    sys.exit(main())
