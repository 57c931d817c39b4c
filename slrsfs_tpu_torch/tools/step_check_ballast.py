"""``chip_smoke.py``'s kernel-vs-plain step checks (phases 10, 17, 18 and
24) run again with part of the card's memory held back, to show whether
what they compare depends on the device memory free.

    python -m slrsfs_tpu_torch.tools.step_check_ballast [--ballast-gib 0 16 32]
        [--design off|deterministic]                  # from the repository root

Each phase's trainers are built as ``chip_smoke.py`` builds them
(``Options()`` widths, B = 16, 256², T = 60, the seed; phase 10's and
17's dense and 50 %-moving batches, phase 18's joint and fix-motion
steps, phase 24's data-parallel step on a 1-rank NCCL group against the
unsharded step). For each ballast size, in the order given, a tensor of
that many GiB is allocated and ``chip_smoke.kernel_vs_plain_steps`` runs
with it held; each run prints its checks, the device memory free before
it, its seconds, and PASSED, FAILED with the failed check, or that the
steps did not fit beside the ballast.

``--design off`` (the default) runs the checks as ``chip_smoke.py`` does,
the convolutions off cuDNN. ``--design deterministic`` runs them with
cuDNN on in its deterministic mode (benchmark off) instead, the design
whose losses parted by one ulp when the memory free changed. A missing
card raises.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import os
import time

import numpy as np
import torch


def _cudnn_deterministic_steps(cs):
    """``chip_smoke.deterministic_steps`` with cuDNN on, deterministic."""

    @contextlib.contextmanager
    def steps():
        from slrsfs_tpu_torch.models import motion
        from slrsfs_tpu_torch.nn import blocks

        cudnn = torch.backends.cudnn
        prev = (cudnn.deterministic, cudnn.benchmark, blocks.upsample_bilinear_2x,
                motion.upsample_bilinear_2x)
        cudnn.deterministic, cudnn.benchmark = True, False
        blocks.upsample_bilinear_2x = motion.upsample_bilinear_2x = \
            cs.upsample_bilinear_2x_deterministic
        try:
            yield
        finally:
            (cudnn.deterministic, cudnn.benchmark, blocks.upsample_bilinear_2x,
             motion.upsample_bilinear_2x) = prev

    return steps


def _phases(cs, dev):
    """(phase, label, build) for each check: ``build()`` returns the
    arguments of ``kernel_vs_plain_steps`` after its phase and label."""
    from slrsfs_tpu_torch.cli.train import (
        MODEL_TYPE,
        attach_moving_sets,
        build,
        stage_options,
        to_device_batch,
    )
    from slrsfs_tpu_torch.config import Options
    from slrsfs_tpu_torch.parallel.mesh import make_mesh, shard_batch

    def two_batches(options, make_batch):
        _, tr = build(options, train_max_steps=cs.TRAIN_T, device=dev, seed=cs.SEED)
        batch = to_device_batch(make_batch(np.random.default_rng(cs.SEED), cs.TRAIN_B,
                                           cs.W), dev)
        sparse = to_device_batch(attach_moving_sets(make_batch(
            np.random.default_rng(cs.SEED + 1), cs.TRAIN_B, cs.W, moving_frac=0.5)), dev)
        return (tr, {"dense": batch, "compact": sparse}), {}

    def stage1():
        return two_batches(Options(W=cs.W, batch_size=cs.TRAIN_B), cs.make_train_batch)

    def slr():
        slr_type = cs.SLR_OPTS["model_type"]
        return two_batches(Options(W=cs.W, batch_size=cs.TRAIN_B, model_type=slr_type,
                                   **stage_options(slr_type)), cs.make_slr_batch)

    def embedded(frozen):
        def make():
            opt = Options(W=cs.W, batch_size=cs.TRAIN_B, freeze_motion=frozen,
                          **stage_options(MODEL_TYPE, True))
            _, tr = build(opt, train_max_steps=cs.TRAIN_T, device=dev, seed=cs.SEED)
            batch = to_device_batch(cs.make_motion_train_batch(
                np.random.default_rng(cs.SEED), cs.TRAIN_B, cs.W), dev)
            return (tr, {"dense": batch}), {"own_limit": 1e-3}
        return make

    def data_parallel():
        mesh = make_mesh(1)
        opt = Options(W=cs.W, batch_size=cs.TRAIN_B)
        _, tr_dp = build(opt, train_max_steps=cs.TRAIN_T, device=dev, seed=cs.SEED,
                         mesh=mesh)
        _, tr = build(opt, train_max_steps=cs.TRAIN_T, device=dev, seed=cs.SEED)
        batch_np = cs.make_train_batch(np.random.default_rng(cs.SEED), cs.TRAIN_B, cs.W)
        mine = to_device_batch(shard_batch(batch_np, mesh, batch_size=cs.TRAIN_B), dev)
        return (tr_dp, {"dense": mine}), {"ref": tr}

    return [(10, "training", stage1), (17, "SLR", slr), (18, "joint", embedded(False)),
            (18, "fix-motion", embedded(True)), (24, "data-parallel", data_parallel)]


def main() -> int:
    import torch.distributed as dist

    import chip_smoke as cs
    from slrsfs_tpu_torch import kernels

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ballast-gib", type=float, nargs="+", default=[0.0, 16.0, 32.0])
    ap.add_argument("--design", choices=("off", "deterministic"), default="off")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("step_check_ballast needs a CUDA device")
    kernels.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.design == "deterministic":
        cs.deterministic_steps = _cudnn_deterministic_steps(cs)
    dev = torch.device("cuda")
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    rdzv = os.path.join(cs.OUT_DIR, "step_check_ballast_rendezvous")
    if os.path.exists(rdzv):
        os.remove(rdzv)
    dist.init_process_group("nccl", init_method=f"file://{rdzv}", rank=0, world_size=1,
                            device_id=torch.device("cuda", torch.cuda.current_device()))
    failed = 0
    try:
        for phase, label, make in _phases(cs, dev):
            (tr, batches), kw = make()
            for gib in args.ballast_gib:
                t0, free = time.perf_counter(), float("nan")
                try:
                    ballast = torch.empty(int(gib * 2 ** 30), dtype=torch.uint8, device=dev)
                    gc.collect()
                    free = torch.cuda.mem_get_info()[0] / 2 ** 30
                    t0 = time.perf_counter()
                    cs.kernel_vs_plain_steps(phase, label, tr, batches, **kw)
                    verdict = "PASSED"
                except torch.cuda.OutOfMemoryError:
                    verdict = "did not fit beside the ballast"
                except RuntimeError as e:
                    if not str(e).startswith("check failed"):
                        raise
                    verdict, failed = f"FAILED: {e}", failed + 1
                torch.cuda.synchronize()
                print(f"step_check_ballast design {args.design}, phase {phase} {label}, "
                      f"ballast {gib:g} GiB ({free:.2f} GiB free before): {verdict} in "
                      f"{time.perf_counter() - t0:.1f} s", flush=True)
                ballast = None
                gc.collect()
                torch.cuda.empty_cache()
            del tr, batches, kw
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    print(f"step_check_ballast design {args.design}: {failed} failed")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
