"""Training entry point (port of ``slrsfs_tpu/cli/train.py``), every
shipped stage of the reference (JAX ``build`` :145-176):

* stage 1, ``--model-type softmax_splating`` (``train_animating.py``);
* bg stage 2, ``--model-type bg`` (``train_bg.sh``: the background network
  on ``eulerian_data_bg``, the mean video as target, MVloss 1);
* SLR stage 3, ``--model-type softmax_splating_2layers_alpha_seperate``
  (``train_animating_alpha_2layers_joint_*.py``: the joint two-layer
  fine-tune with the SLR loss set, on ``eulerian_data_balanced1_mask``);
* the motion GAN, ``--model-type SPADE_unet_mask_motion`` or
  ``unet_motion`` (``train_motion_EPE_MotionGAN.sh``: the regressor against
  the ground-truth motion on ``eulerian_data_motion_hint`` with online
  hints, ``10.0_EndPointError``);
* the embedded-motion stages, ``--embed-motion`` on stage 1's model type:
  the splat flow from an embedded regressor on ``eulerian_data_hint``, its
  motion losses (``1.0_EndPointError``) joining the total; with
  ``--freeze-motion`` the fix-motion finetune
  (``train_animating_fixmotion.py``), without it the unfrozen joint stage
  (``train_animating_motion_IGANonly.py``), whose gradient reaches the
  regressor through K7's backward.

Epochs of ``--steps-per-epoch`` G+D steps (each over
``--num-accumulations`` micro-batches), a validation pass on the validation
split after each, scalars as JSON lines in ``<out>/scalars.jsonl``, the
validation prediction's images as PNG grids under ``<out>/images/``, and a
reference-style checkpoint ``<out>/checkpoint.pth`` after each epoch (the
port's and the JAX package's loaders read it). It is also the resume file:
both Adam states in torch Adam's layout (``optimizerG``, ``optimizerD``;
the JAX ``import_optimizer_states`` reads them), the update count, the
BN-noise generator's state, the epoch, the best validation Perceptual loss
and the validation means. ``checkpoint_best.pth`` is the epoch with the
lowest validation Perceptual loss (Total Loss without one), copied to
``checkpoint_best{epoch}.pth`` every 25 epochs from epoch 50
(train_animating.py:350-359).

Preemption (train_animating.py:27-83): SIGUSR1 sets a flag polled every
step; the run then saves the resume file at epoch - 1 (the interrupted
epoch runs again on resume, from the saved weights, optimizer states and
count), runs ``scontrol requeue $SLURM_JOB_ID`` when ``SLURM_JOB_ID`` is
set and ``SLURM_PROCID`` is 0, and exits. ``--resume`` continues from
``<out>/checkpoint.pth`` when it holds the resume metadata, at its epoch +
1, with the best value restored. A finished run writes ``<out>/HALT``; a
run that finds it returns at once.

    python -m slrsfs_tpu_torch.cli.train --data-root DATA --out RUNDIR \\
        [--device cpu] ...
    python -m slrsfs_tpu_torch.cli.train ... --model-type bg
    python -m slrsfs_tpu_torch.cli.train ... \\
        --model-type softmax_splating_2layers_alpha_seperate \\
        --init-from STAGE1.pth --init-bg-from BG.pth
    python -m slrsfs_tpu_torch.cli.train ... --model-type SPADE_unet_mask_motion
    python -m slrsfs_tpu_torch.cli.train ... --embed-motion --freeze-motion \\
        --init-from STAGE1.pth --init-motion-from MOTION.pth
    python -m slrsfs_tpu_torch.cli.train ... --embed-motion --init-from FIXMOTION.pth

``--init-from`` takes G (and D, the perceptual loss's VGG19 and both Adam
states with the update count when the checkpoint holds them) from a
reference-style checkpoint; for stage 3
``--init-bg-from`` overlays a stage-2 checkpoint's ``net_bg`` and the alpha
nets keep their seeded initial weights; for the embedded-motion stages
``--init-motion-from`` overlays a motion checkpoint's regressor, which
otherwise comes from ``--init-from`` when it holds one and keeps its seeded
initial weights when not.

``--train-compute-dtype bfloat16`` runs G in bf16 (engine/trainer.py); with
``--embed-motion`` the trainer raises a ``ValueError``: the JAX package
cannot run that combination either (ROADMAP §1, "The rest of training",
the struck last sub-item). ``--random-ff-mask`` adds the
free-form occlusion mask to the training batches (data/augment.py).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

from slrsfs_tpu_torch.engine.rollout import geometric_bucket
from slrsfs_tpu_torch.models.motion import MOTION_MODEL_TYPES
from slrsfs_tpu_torch.models.slr import BG_MODEL_TYPE, SLR_MODEL_TYPE

MODEL_TYPE = "softmax_splating"
MODEL_TYPES = (MODEL_TYPE, SLR_MODEL_TYPE, BG_MODEL_TYPE) + MOTION_MODEL_TYPES
DEFAULT_DATASETS = {MODEL_TYPE: "eulerian_data",
                    SLR_MODEL_TYPE: "eulerian_data_balanced1_mask",
                    BG_MODEL_TYPE: "eulerian_data_bg",
                    **{t: "eulerian_data_motion_hint" for t in MOTION_MODEL_TYPES}}
# the embedded-motion stages train on the precomputed sparse hints
# (train_animating_scripts/train_animating_fixedMotion_*.sh:16)
EMBEDDED_DATASET = "eulerian_data_hint"


_SIGNAL_RECEIVED = False


def _handle_preempt(signum, frame):
    global _SIGNAL_RECEIVED
    _SIGNAL_RECEIVED = True
    print("preemption signal received; will checkpoint and requeue", file=sys.stderr,
          flush=True)


def trigger_job_requeue() -> None:
    """``scontrol requeue $SLURM_JOB_ID`` from rank 0 of a SLURM job
    (reference train_animating.py:49-75); nothing outside one."""
    job_id = os.environ.get("SLURM_JOB_ID")
    if job_id and os.environ.get("SLURM_PROCID", "0") == "0":
        subprocess.run(["scontrol", "requeue", job_id], check=False)


RESUME_KEYS = ("optimizerG", "step", "epoch", "best_perceptual")


def load_resume(path: str, model, trainer) -> Optional[Dict]:
    """Restore a run from the resume file ``path`` (``save_checkpoint`` with
    the trainer): G and D weights and buffers, both Adam states and the
    count, the noise generator's state. Returns its metadata (epoch,
    best_perceptual, ...), or None when the file is missing or is not a
    resume file (weights only)."""
    from slrsfs_tpu_torch.io.checkpoint import load_trainer_adam_states

    if not os.path.exists(path):
        return None
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if not all(k in ckpt for k in RESUME_KEYS):
        return None
    sd = ckpt["state_dict"]
    g_head, d_head = "model.module.", "netD.netD."
    model.load_state_dict({k[len(g_head):]: v for k, v in sd.items()
                           if k.startswith(g_head)})
    trainer.d_model.load_state_dict({k[len(d_head):]: v for k, v in sd.items()
                                     if k.startswith(d_head)})
    load_trainer_adam_states(trainer, ckpt)
    if "noise_state" in ckpt:
        trainer.noise.set_state(ckpt["noise_state"].to(trainer.noise.get_state().device))
    return {k: v for k, v in ckpt.items()
            if k not in ("state_dict", "opts", "optimizerG", "optimizerD", "noise_state")}


def image_grids(pred: Dict, normalize_image: bool = True, n: int = 4) -> Dict:
    """The validation prediction's images (reference train_animating.py:
    101-138): each 4-D entry with 1 to 3 channels as one uint8 (h, n·w, 3)
    row of its first ``n`` samples; 2-channel flows through
    ``utils/flow_viz.py:flow_to_image``, images ("Img" in the key) mapped
    from [-1, 1] when ``normalize_image``, everything clipped to [0, 1]."""
    from slrsfs_tpu_torch.utils.flow_viz import flow_to_image

    out = {}
    for k, v in pred.items():
        if not torch.is_tensor(v) or v.ndim != 4 or v.shape[-1] not in (1, 2, 3):
            continue
        tiles = []
        for a in v[:n].detach().float().cpu().numpy():
            if a.shape[-1] == 2:
                a = flow_to_image(a).astype(np.float32) / 255.0
            elif normalize_image and "Img" in k:
                a = a * 0.5 + 0.5
            if a.shape[-1] == 1:
                a = np.repeat(a, 3, axis=-1)
            tiles.append(np.clip(a, 0.0, 1.0))
        out[k] = (np.concatenate(tiles, axis=1) * 255.0 + 0.5).astype(np.uint8)
    return out


def write_image_grids(out_dir: str, epoch: int, pred: Dict, normalize_image: bool) -> None:
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    for k, grid in image_grids(pred, normalize_image).items():
        Image.fromarray(grid).save(os.path.join(out_dir, f"epoch{epoch:04d}_{k}.png"))


def default_dataset(model_type: str, embed_motion: bool = False) -> str:
    """The dataset a stage trains on unless ``--dataset`` says otherwise."""
    return EMBEDDED_DATASET if embed_motion else DEFAULT_DATASETS[model_type]


def stage_options(model_type: str, embed_motion: bool = False) -> Dict:
    """The options the JAX CLI sets for a stage (:286-319): stage 3's SLR
    loss weights and blending weight, MVloss 1 for stages 2 and 3, online
    hints for the motion types, and the shipped motion-loss defaults:
    ``10.0_EndPointError`` for the motion GAN
    (train_motion_EPE_MotionGAN.sh:17), ``1.0_EndPointError`` for embedded
    motion (train_animating_fixedMotion_finetuneFluid_IGANonly.sh:22)."""
    slr = model_type == SLR_MODEL_TYPE
    out = dict(MVloss=1.0 if slr or model_type == BG_MODEL_TYPE else 0.0,
               use_alpha0_as_blending_weight=slr,
               ATVloss=0.3 if slr else 0.0, ADCloss=1.0 if slr else 0.0,
               FluidRegionloss=3.0 if slr else 0.0,
               RockRegionloss=30.0 if slr else 0.0,
               RockRegionlossDecay=20.0 if slr else 0.0,
               use_online_hint=("motion" in model_type.lower()
                                or "unet" in model_type.lower()),
               train_motion=embed_motion)
    if model_type in MOTION_MODEL_TYPES:
        out["motion_losses"] = ("10.0_EndPointError",)
    elif embed_motion:
        out["motion_losses"] = ("1.0_EndPointError",)
    return out


def attach_moving_sets(batch: Dict, max_frac: float = 0.5,
                       state: Optional[Dict] = None, eps: float = 0.0,
                       n_steps: Optional[int] = None) -> Dict:
    """Host-side moving-pixel sets for the compact training integration
    (port of the JAX ``attach_moving_sets``).

    Adds ``mov_pos`` (B, P, 2) int32 [x, y] and ``mov_valid`` (B, P) float32,
    P on the ×1.25 geometric series from 1024, and returns the batch
    unchanged when the largest sample's moving fraction exceeds
    ``max_frac``. ``eps`` > 0 first zeroes motion slower than ``eps``
    (a zeroed pixel drifts at most T·eps over a T-step integration).
    ``state``, a dict kept across batches, makes the choice sticky for a
    run: the first batch picks sparse or dense and P only grows."""
    m = np.asarray(batch["motions"])
    flow = m[..., :2] * m[..., 2:3] if m.shape[-1] == 3 else m
    if eps > 0.0:
        speed = np.sqrt(flow[..., 0] ** 2 + flow[..., 1] ** 2)
        sub = speed < eps
        if sub.any():
            zeroed = sub & (speed > 0)
            if zeroed.any() and not (state or {}).get("eps_logged"):
                T = n_steps if n_steps else round(0.5 / eps)
                print(f"train sparsify eps={eps:g}: zeroed "
                      f"{zeroed.mean():.1%} of pixels (max trajectory drift "
                      f"{speed[zeroed].max() * T:.2f}px over the "
                      f"{T}-step integration)", flush=True)
                if state is not None:
                    state["eps_logged"] = True
            m = np.where(sub[..., None], 0.0, m).astype(m.dtype)
            flow = np.where(sub[..., None], 0.0, flow)
            batch = dict(batch)
            batch["motions"] = m
    moving = np.any(flow != 0.0, axis=-1)
    B, H, W = moving.shape
    need = int(moving.reshape(B, -1).sum(1).max())
    if state is not None and "mode" not in state:
        state["mode"] = "dense" if need > max_frac * H * W else "sparse"
    if state is not None:
        if state["mode"] == "dense":
            return batch
    elif need > max_frac * H * W:
        return batch
    P = max(geometric_bucket(need, 1024, 1.25, H * W),
            state.get("P", 0) if state is not None else 0)
    if state is not None:
        state["P"] = P
    pos = np.zeros((B, P, 2), np.int32)
    val = np.zeros((B, P), np.float32)
    for b in range(B):
        ys, xs = np.nonzero(moving[b])
        n = len(xs)
        pos[b, :n, 0] = xs
        pos[b, :n, 1] = ys
        val[b, :n] = 1.0
    out = dict(batch)
    out["mov_pos"] = pos
    out["mov_valid"] = val
    return out


def to_device_batch(batch: Dict, device) -> Dict:
    """numpy batch → tensors on ``device`` (images stay a list of three)."""
    def t(a):
        return torch.from_numpy(np.array(a, copy=True, order="C")).to(device)

    return {k: [t(x) for x in v] if k == "images" else t(v)
            for k, v in batch.items()}


def build(opt, train_max_steps: int = 60, device="cuda", seed: int = 0,
          steps_per_epoch: int = 500, vgg=None):
    """The model and trainer of ``opt``'s stage on ``device`` with seeded
    random weights (LeCun-normal kernels, zero biases, spectral vectors from
    power iterations), in JAX ``build``'s order: ``bg`` (``BackgroundModel``,
    task 'bg'), the motion types (``MotionRegressor``, task 'motion', a
    2-channel D), stage 3 (``SLRTrainable`` with ``slr_extra_losses``),
    ``opt.train_motion`` (``BaselineMotionTrainable`` with
    ``baseline_motion_extra_losses``), else stage 1
    (``BaselineTrainable``). An unknown model type is a ``ValueError``."""
    from slrsfs_tpu_torch.engine.trainer import Trainer, make_discriminator
    from slrsfs_tpu_torch.models.baseline import (
        BaselineMotionTrainable,
        BaselineTrainable,
        baseline_motion_extra_losses,
        init_random_weights,
    )
    from slrsfs_tpu_torch.models.motion import MotionRegressor
    from slrsfs_tpu_torch.models.slr import (
        BackgroundModel,
        SLRTrainable,
        slr_extra_losses,
    )
    if opt.model_type not in MODEL_TYPES:
        raise ValueError(f"unknown model_type {opt.model_type!r}: the train CLI "
                         f"builds {', '.join(MODEL_TYPES)}")
    task, extra, d_in = "synthesis", None, 3
    if opt.model_type == BG_MODEL_TYPE:
        model, task = BackgroundModel(opt), "bg"
    elif opt.model_type in MOTION_MODEL_TYPES:
        model, task, d_in = MotionRegressor(opt), "motion", 2
    elif opt.model_type == SLR_MODEL_TYPE:
        model = SLRTrainable(opt, train_max_steps=train_max_steps)
        extra = slr_extra_losses
    elif opt.train_motion:
        model = BaselineMotionTrainable(opt, train_max_steps=train_max_steps)
        extra = baseline_motion_extra_losses
    else:
        model = BaselineTrainable(opt, train_max_steps=train_max_steps)
    init_random_weights(model, seed)
    d_model = make_discriminator(opt, d_in)
    init_random_weights(d_model, seed + 1)
    trainer = Trainer(opt, model, steps_per_epoch=steps_per_epoch, vgg=vgg,
                      d_model=d_model, seed=seed, device=device,
                      extra_losses_fn=extra, task=task)
    return model, trainer


def warm_start(model, trainer, init_from: str, init_bg_from: str = None,
               init_motion_from: str = None) -> None:
    """``--init-from`` (with ``--init-bg-from`` for stage 3 and
    ``--init-motion-from`` for the embedded-motion stages): G from a
    reference-style checkpoint, D when it holds ``netD.*`` keys, and the
    perceptual loss's VGG19 when it holds the reference loss's slices (JAX
    cli/train.py:378-447). Stage 3 merges the bg checkpoint's ``net_bg``
    and leaves the alpha nets at their initial weights; the embedded-motion
    stages merge the motion checkpoint's regressor and load by
    ``load_embedded_baseline``; a motion regressor loads the
    ``motion_predictor.*`` keys of a motion or embedded checkpoint. A
    checkpoint with ``optimizerG`` (a resume file of this CLI or of the
    reference) also restores both Adam states and the update count (JAX
    :426-441); one whose states do not fit the model is skipped with a
    message, as in JAX: both Adam states stay as they were and the
    weights stay loaded."""
    from slrsfs_tpu_torch.io.checkpoint import (
        clean_state_dict,
        import_vgg_from_checkpoint,
        load_embedded_baseline,
        load_model_state,
        load_model_state_with_fallback,
        merge_stage3_state_dict,
        motion_state,
    )

    def state_dict(path):
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
        return ckpt.get("state_dict", ckpt)

    opt = model.opt
    ckpt = torch.load(init_from, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    if opt.model_type == SLR_MODEL_TYPE:
        sd = merge_stage3_state_dict(
            sd, state_dict(init_bg_from) if init_bg_from else None)
        kept = load_model_state_with_fallback(model, clean_state_dict(sd))
        print(f"warm start from {init_from}; kept at init: {kept}", flush=True)
    elif opt.model_type in MOTION_MODEL_TYPES:
        load_model_state(model, motion_state(sd))
    elif opt.train_motion:
        sd = merge_stage3_state_dict(
            sd, sd_motion=state_dict(init_motion_from) if init_motion_from else None)
        loaded = load_embedded_baseline(model, clean_state_dict(sd))
        print(f"warm start from {init_from}; motion regressor "
              + ("loaded" if loaded else "kept at init"), flush=True)
    else:
        load_model_state(model, clean_state_dict(sd))
    d_sd = {k[len("netD.netD."):]: v for k, v in sd.items()
            if k.startswith("netD.netD.")}
    if d_sd:
        load_model_state(trainer.d_model, d_sd)
    vgg = import_vgg_from_checkpoint(sd)
    if vgg is not None and trainer.vgg is not None:
        trainer.vgg.load_state_dict(vgg)
        print("harvested the pretrained VGG19 from the init checkpoint", flush=True)
    if "optimizerG" in ckpt:
        from slrsfs_tpu_torch.io.checkpoint import load_trainer_adam_states

        try:
            count = load_trainer_adam_states(trainer, ckpt)
            print(f"restored torch Adam states (step {count})", flush=True)
        except (KeyError, ValueError) as e:  # the weights alone still help
            print(f"optimizer-state import skipped: {e}", flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data-root", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--model-type", default=MODEL_TYPE, choices=list(MODEL_TYPES))
    p.add_argument("--dataset", default=None,
                   help="dataset variant (default: eulerian_data for stage 1, "
                        "eulerian_data_bg for bg, eulerian_data_balanced1_mask "
                        "for stage 3, eulerian_data_motion_hint for the motion "
                        "types, eulerian_data_hint with --embed-motion)")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--W", type=int, default=256)
    p.add_argument("--ngf", type=int, default=64)
    p.add_argument("--niter", type=int, default=100)
    p.add_argument("--niter-decay", type=int, default=10)
    p.add_argument("--steps-per-epoch", type=int, default=500)
    p.add_argument("--val-steps", type=int, default=8)
    p.add_argument("--lr-g", type=float, default=5e-4 / 2)
    p.add_argument("--lr-d", type=float, default=1e-3 * 2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--vgg-pth", default=None,
                   help="torchvision vgg19 state_dict for the content loss "
                        "(default: seeded random VGG weights)")
    p.add_argument("--init-from", default=None,
                   help="reference-style .pth to warm-start G (and D, when "
                        "it holds netD.* keys, and the VGG19, when it holds "
                        "the perceptual loss's slices) from")
    p.add_argument("--init-bg-from", default=None,
                   help="stage-2 .pth whose net_bg.* keys overlay --init-from "
                        "for SLR stage 3 (reference --load_bg_model)")
    p.add_argument("--init-motion-from", default=None,
                   help="motion-regressor .pth whose motion_predictor.* keys "
                        "overlay --init-from as motion_regressor.* (reference "
                        "--load_motion_regressor; needs --embed-motion)")
    p.add_argument("--embed-motion", action="store_true",
                   help="embed the motion regressor in the fluid model: the "
                        "splat flow comes from it instead of the ground truth "
                        "(the fix-motion and joint stages)")
    p.add_argument("--freeze-motion", action="store_true",
                   help="freeze the embedded regressor (the fix-motion finetune, "
                        "reference train_animating_fixmotion.py:448-450)")
    p.add_argument("--motion-losses", nargs="+", default=None,
                   help="motion loss spec, e.g. 10.0_EndPointError (default: "
                        "the shipped 10.0_EndPointError for the motion GAN, "
                        "1.0_EndPointError with --embed-motion)")
    p.add_argument("--train-sparse-motion", choices=["auto", "off"],
                   default="auto",
                   help="integrate only each sample's moving pixels (compact "
                        "K7) when at most half of them move")
    p.add_argument("--train-sparsify-eps", type=float, default=None,
                   help="zero training motion below this speed; default "
                        "0.5/train_max_steps; 0 disables")
    p.add_argument("--train-max-steps", type=int, default=60,
                   help="bound on the per-sample Euler steps (T)")
    p.add_argument("--resume", action="store_true",
                   help="continue from <out>/checkpoint.pth (weights, both Adam "
                        "states and the count, epoch + 1, the best value)")
    p.add_argument("--random-ff-mask", action="store_true",
                   help="free-form occlusion augmentation (reference --random_ff_mask)")
    p.add_argument("--random-ff-mask-rate", type=float, default=0.5)
    p.add_argument("--num-accumulations", type=int, default=1,
                   help="micro-batches per optimizer step (reference "
                        "base_model.py:95-163)")
    p.add_argument("--accum-scale", choices=["mean", "reference"], default="mean",
                   help="'mean' averages the micro-batches' gradients; 'reference' "
                        "repeats the reference's loss/weight quirk (the summed "
                        "gradients times num_accumulations)")
    p.add_argument("--train-compute-dtype", choices=["float32", "bfloat16"],
                   default="float32",
                   help="G's forward and backward dtype: 'bfloat16' keeps float32 "
                        "parameters, Adam states and losses")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu' for the plain path")
    # architecture overrides (reference --refine_model_type etc.)
    p.add_argument("--refine-model-type", default=None)
    p.add_argument("--alpha-refine-model-type", default=None)
    p.add_argument("--bg-refine-model-type", default=None)
    p.add_argument("--out-channel", type=int, default=None)
    p.add_argument("--ndf", type=int, default=None)
    p.add_argument("--num-D", type=int, default=None)
    p.add_argument("--n-layers-D", type=int, default=None)
    a = p.parse_args(argv)
    if (a.init_bg_from or a.init_motion_from) and not a.init_from:
        p.error("--init-bg-from/--init-motion-from overlay --init-from and "
                "require it")
    if a.init_motion_from and not a.embed_motion:
        p.error("--init-motion-from needs --embed-motion (only the embedded-motion "
                "fluid model has a motion_regressor)")
    if a.freeze_motion and not a.embed_motion:
        p.error("--freeze-motion needs --embed-motion")

    from slrsfs_tpu_torch.config import Options
    from slrsfs_tpu_torch.data.datasets import get_dataset
    from slrsfs_tpu_torch.io.checkpoint import save_checkpoint
    from slrsfs_tpu_torch.nn.vgg import VGG19Features, import_vgg19

    opt = Options(model_type=a.model_type,
                  dataset=a.dataset or default_dataset(a.model_type, a.embed_motion),
                  batch_size=a.batch_size, W=a.W, ngf=a.ngf, niter=a.niter,
                  niter_decay=a.niter_decay, lr_g=a.lr_g, lr_d=a.lr_d,
                  seed=a.seed, freeze_motion=a.freeze_motion,
                  random_ff_mask=a.random_ff_mask,
                  random_ff_mask_rate=a.random_ff_mask_rate,
                  num_accumulations=a.num_accumulations,
                  accum_scale=a.accum_scale,
                  train_compute_dtype=a.train_compute_dtype,
                  **stage_options(a.model_type, a.embed_motion))
    if a.motion_losses:
        opt = opt.replace(motion_losses=tuple(a.motion_losses))
    arch = {"refine_model_type": a.refine_model_type,
            "alpha_refine_model_type": a.alpha_refine_model_type,
            "bg_refine_model_type": a.bg_refine_model_type,
            "out_channel": a.out_channel, "ndf": a.ndf, "num_D": a.num_D,
            "n_layers_D": a.n_layers_D}
    opt = opt.replace(**{k: v for k, v in arch.items() if v is not None})
    os.makedirs(a.out, exist_ok=True)
    with open(os.path.join(a.out, "options.json"), "w") as f:
        f.write(opt.to_json())
    halt_file = os.path.join(a.out, "HALT")
    ckpt_path = os.path.join(a.out, "checkpoint.pth")
    if os.path.exists(halt_file):
        print("HALT marker present; training already finished", flush=True)
        return ckpt_path
    global _SIGNAL_RECEIVED
    _SIGNAL_RECEIVED = False
    signal.signal(signal.SIGUSR1, _handle_preempt)

    vgg = None
    if a.vgg_pth:
        vgg = VGG19Features()
        vgg.load_state_dict(import_vgg19(
            torch.load(a.vgg_pth, map_location="cpu", weights_only=False)))
    model, trainer = build(opt, a.train_max_steps, a.device, a.seed,
                           a.steps_per_epoch, vgg)
    start_epoch, best = 0, float("inf")
    meta = load_resume(ckpt_path, model, trainer) if a.resume else None
    if meta is not None:
        start_epoch, best = meta["epoch"] + 1, meta["best_perceptual"]
        print(f"resumed from epoch {meta['epoch']} (step {trainer.step_count})",
              flush=True)
    elif a.init_from:
        warm_start(model, trainer, a.init_from, a.init_bg_from, a.init_motion_from)

    dataset = get_dataset(opt, a.data_root, split="train", seed=a.seed)
    # the compact moving-set integration applies where the splat flow is the
    # dataset's (GT motion with exact zeros); predicted motion and the
    # non-fluid stages integrate dense fields or nothing (JAX :459-463)
    sparse = (a.train_sparse_motion != "off" and not a.embed_motion
              and a.model_type in (MODEL_TYPE, SLR_MODEL_TYPE))
    eps = a.train_sparsify_eps
    if eps is None:
        eps = 0.5 / a.train_max_steps if sparse else 0.0
    mov_state: Dict = {}
    dev = trainer.device
    accum = opt.num_accumulations
    log_path = os.path.join(a.out, "scalars.jsonl")
    best_path = os.path.join(a.out, "checkpoint_best.pth")

    def micro_batches(stream):
        """The batch stream grouped into steps of ``accum`` micro-batches
        (JAX :472-484)."""
        group = []
        for b in stream:
            if sparse:
                b = attach_moving_sets(b, state=mov_state, eps=eps,
                                       n_steps=a.train_max_steps)
            group.append(to_device_batch(b, dev))
            if len(group) == accum:
                yield group if accum > 1 else group[0]
                group = []

    def save(path, epoch, **extra):
        save_checkpoint(path, model, trainer.d_model, opt, epoch=epoch, trainer=trainer,
                        meta={"best_perceptual": best, **extra})

    with open(log_path, "a") as log:
        for epoch in range(start_epoch, a.niter + a.niter_decay):
            dataset.totrain(epoch)
            t0 = time.time()
            for it, batch in enumerate(micro_batches(dataset.batches(
                    a.batch_size, num_batches=a.steps_per_epoch * accum))):
                logs = trainer.train_step(batch)
                row = {k: float(v) for k, v in logs.items()}
                log.write(json.dumps({"split": "train", "epoch": epoch,
                                      "step": trainer.step_count, **row}) + "\n")
                log.flush()
                if it % 100 == 0:
                    print(f"epoch {epoch} it {it}: " + " ".join(
                        f"{k}={row[k]:.4f}" for k in
                        ("Total Loss", "L1", "Perceptual", "psnr", "GAN",
                         "L1_bg", "EndPointError")
                        if k in row), flush=True)
                if _SIGNAL_RECEIVED:
                    save(ckpt_path, epoch - 1)
                    print(f"preempted in epoch {epoch} at step {trainer.step_count}; "
                          f"saved {ckpt_path}", flush=True)
                    trigger_job_requeue()
                    return ckpt_path
            dataset.toval(epoch)
            val: Dict = {}
            for batch in dataset.batches(a.batch_size, num_batches=a.val_steps):
                for k, v in trainer.eval_step(to_device_batch(batch, dev)).items():
                    val.setdefault(k, []).append(float(v))
            val_means = {k: float(np.mean(v)) for k, v in val.items()}
            log.write(json.dumps({"split": "val", "epoch": epoch,
                                  "step": trainer.step_count, **val_means}) + "\n")
            log.flush()
            write_image_grids(os.path.join(a.out, "images"), epoch, trainer.last_pred,
                              opt.normalize_image)
            perceptual = val_means.get("Perceptual", val_means.get("Total Loss", 0.0))
            improved = perceptual < best
            best = min(best, perceptual)
            save(ckpt_path, epoch, val=val_means)
            if improved:
                shutil.copyfile(ckpt_path, best_path)
            if epoch % 25 == 0 and epoch >= 50 and os.path.exists(best_path):
                # an epoch-numbered copy of the best so far, so that a late
                # regression cannot overwrite the only good weights
                # (train_animating.py:357-359)
                shutil.copyfile(best_path, os.path.join(a.out, f"checkpoint_best{epoch}.pth"))
            print(f"epoch {epoch} done in {time.time() - t0:.0f}s; val "
                  f"{val_means}; saved {ckpt_path}", flush=True)
    with open(halt_file, "w") as f:
        f.write("done")
    return ckpt_path


if __name__ == "__main__":
    main()
