"""Data-parallel training steps over n ranks (the port of
``__graft_entry__.py:_dryrun_multichip_impl``):

    python -m slrsfs_tpu_torch.parallel.dryrun --ranks N [--device cpu]

starts N gloo processes on the CPU, or N NCCL ranks, one a card, and runs
in each the baseline step (ngf 16, 32², 2 samples a rank), the SLR stage-3
step (the stage's losses) and the motion-GAN step (the 8-down SPADE
regressor at 256², ``motion_num_filters`` 4, one sample a rank), each on
its rank's rows of one seeded global batch through ``Trainer(mesh=...)``.
Each step's total loss must be finite and its logs must hold the step's
keys; rank 0 prints one line a step.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

H = W = 32
MOTION_W = 256


def _imgs(rng, B: int, size: int = W):
    return (rng.standard_normal((B, size, size, 3)) * 0.25).astype(np.float32)


def _index(rng, B: int):
    idx = np.zeros((B, 3), np.int32)
    idx[:, 1] = rng.integers(1, 4, size=B)
    idx[:, 2] = 4
    return idx


def _step(mesh, opt, batch, keys, label: str) -> dict:
    """One data-parallel step of ``opt``'s stage on this rank's rows of
    ``batch``: the logs as floats, checked finite and holding ``keys``."""
    from slrsfs_tpu_torch.cli.train import build, to_device_batch
    from slrsfs_tpu_torch.parallel.mesh import shard_batch

    _, tr = build(opt, train_max_steps=4, device=mesh.device, seed=0, mesh=mesh)
    mine = to_device_batch(shard_batch(batch, mesh, batch_size=opt.batch_size),
                           mesh.device)
    logs = {k: float(v) for k, v in tr.train_step(mine).items()}
    total = logs["Total Loss"]
    if not np.isfinite(total):
        raise RuntimeError(f"{label} step: Total Loss {total}")
    missing = [k for k in keys if k not in logs]
    if missing:
        raise RuntimeError(f"{label} step: logs lack {missing}: {sorted(logs)}")
    if mesh.rank == 0:
        print(f"dryrun ({mesh.world} ranks, {mesh.backend}): OK: {label} step, "
              f"Total Loss {total:.4f}, logs: {sorted(logs)}", flush=True)
    return logs


def baseline_step(mesh) -> dict:
    """The stage-1 step at ngf 16, 32², two samples a rank."""
    from slrsfs_tpu_torch.config import Options

    B = 2 * mesh.world
    rng = np.random.default_rng(0)
    batch = {"images": [_imgs(rng, B) for _ in range(3)], "index": _index(rng, B),
             "motions": (rng.standard_normal((B, H, W, 2)) * 0.5).astype(np.float32)}
    return _step(mesh, Options(ngf=16, W=W, batch_size=B), batch,
                 ("L1", "Perceptual", "GAN", "GAN_Feat", "D_Fake", "D_real",
                  "psnr", "ssim", "Total Loss"), "baseline")


def slr_step(mesh) -> dict:
    """The SLR stage-3 step (fluid, alpha and background; the alpha,
    rock- and fluid-region and ADC losses) at ngf 16, 32²."""
    from slrsfs_tpu_torch.config import Options

    B = 2 * mesh.world
    rng = np.random.default_rng(1)
    opt = Options(ngf=16, W=W, batch_size=B,
                  model_type="softmax_splating_2layers_alpha_seperate",
                  use_alpha0_as_blending_weight=True, ATVloss=0.3, ADCloss=1.0,
                  FluidRegionloss=3.0, RockRegionloss=30.0, MVloss=1.0, AlphaL1loss=1.0)
    batch = {"images": [_imgs(rng, B) for _ in range(3)], "index": _index(rng, B),
             "motions": (rng.standard_normal((B, H, W, 2)) * 0.5).astype(np.float32),
             "mask_rock": (rng.random((B, H, W, 1)) < 0.2).astype(np.float32),
             "mean_video": _imgs(rng, B)}
    return _step(mesh, opt, batch,
                 ("AlphaL1loss", "FluidRegionLoss", "RockRegionLoss", "L1_bg"), "SLR stage-3")


def motion_step(mesh) -> dict:
    """The motion-GAN step: the SPADE regressor (8 downs, 4 filters) and a
    2-channel D at 256², one sample a rank."""
    from slrsfs_tpu_torch.config import Options

    B = mesh.world
    rng = np.random.default_rng(2)
    opt = Options(W=MOTION_W, motionH=MOTION_W, motionW=MOTION_W, batch_size=B,
                  model_type="SPADE_unet_mask_motion",
                  motion_losses=("10.0_EndPointError",), div_flow=1.0,
                  motion_num_filters=4, ndf=8, num_D=1, n_layers_D=2)
    motion = np.zeros((B, MOTION_W, MOTION_W, 2), np.float32)
    motion[:, MOTION_W // 2:, :, 0] = 1.0
    batch = {"images": [_imgs(rng, B, MOTION_W)], "motions": motion,
             "hints": np.zeros((B, MOTION_W, MOTION_W, 2), np.float32)}
    return _step(mesh, opt, batch, ("EndPointError", "GAN"), "motion-GAN")


STEPS = {"baseline": baseline_step, "slr": slr_step, "motion": motion_step}


def _rank(rank: int, world: int, init_file: str, device: str) -> None:
    import torch.distributed as dist

    from slrsfs_tpu_torch.parallel.mesh import make_mesh

    os.environ["LOCAL_RANK"] = str(rank)
    if device == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    backend = "gloo" if device == "cpu" else "nccl"
    dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        mesh = make_mesh(world, device=device)
        for step in STEPS.values():
            step(mesh)
    finally:
        dist.destroy_process_group()


def run(ranks: int, device: str = "cuda") -> None:
    """Spawn ``ranks`` processes and run the three steps in each; raises
    when a rank fails."""
    import torch.multiprocessing as mp

    if device != "cpu" and torch.cuda.device_count() < ranks:
        raise RuntimeError(f"{ranks} NCCL ranks need {ranks} cards, "
                           f"{torch.cuda.device_count()} are visible")
    with tempfile.TemporaryDirectory() as d:
        mp.start_processes(_rank, args=(ranks, os.path.join(d, "rendezvous"), device),
                           nprocs=ranks, join=True, start_method="spawn")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ranks", type=int, default=2)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="'cuda': one NCCL rank a card; 'cpu': gloo ranks")
    a = p.parse_args(argv)
    run(a.ranks, a.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
