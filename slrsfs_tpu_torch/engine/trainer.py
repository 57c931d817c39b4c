"""Two-optimizer GAN trainer (PyTorch port of ``slrsfs_tpu/engine/trainer.py``).

Reference semantics (``models/base_model.py:9-163``): Adam(lr_g, betas
(0, 0.9)) for the generator and Adam(lr_d) for the discriminator; one
generator step (synthesis loss + GAN-G loss, the discriminator in eval mode
with its stored spectral vectors and no gradient into its weights) and one
discriminator step on the same fake images, detached, whose train-mode
forward runs the discriminator's power iterations; the learning rate decays
linearly after ``niter`` epochs (base_model.py:80-93).

The generator's BN statistics and spectral vectors update in place during
its forward (two encodes, then the decode), as the JAX step threads them.
Adam is written out as optax's ``adam`` computes it: the first update of a
parameter is lr·g/(|g| + 1e-8), and the schedule is evaluated at the
update count, so the first update uses ``schedule(0)``.

``task`` picks the reconstruction target and loss (JAX
``engine/trainer.py:61-77, 152-176``): 'synthesis' (stages 1 and 3 and the
embedded-motion stages: the middle image), 'bg' (stage 2: the mean video,
the loss keys suffixed ``_bg`` and the total weighted by MVloss) and
'motion' (the motion GAN: ``MotionLoss`` against the ground-truth motion,
no VGG, a 2-channel discriminator). With ``opt.freeze_motion`` the
embedded regressor's parameters stay out of G's Adam, as optax's
``multi_transform`` with ``set_to_zero`` leaves them; its spectral vectors
still run their power iterations in train mode.

``opt.num_accumulations`` = k > 1 takes a list of k micro-batches a step
(reference base_model.py:95-163, JAX ``make_train_step(accum)``): each
micro-batch's G and D gradients are summed, BN statistics and spectral
vectors carry from one micro-batch to the next (they update in place), and
each optimizer steps once, on the sum times 1/k (``accum_scale`` 'mean') or
times k (``'reference'``, the reference's literal loss/weight quirk); the
logged losses are the micro-batches' means.

``opt.train_compute_dtype`` 'bfloat16' runs G's forward and backward in
bf16 (JAX ``engine/trainer.py:197-236``): G's parameters, BN statistics,
spectral vectors and the batch's float fields except the motion (and the
moving sets) are cast to bf16 inside the autograd graph, so the gradients
that reach Adam are float32; the prediction is cast back to float32 before
the losses, VGG and D, which run in float32; the updated statistics and
vectors are stored back in float32. Every persistent tensor (parameters,
both Adam states, statistics, vectors) stays float32. The dense splat then
takes bf16 features and an f32 flow: K3's bf16 mode on the card. bf16
with an embedded motion regressor (``opt.train_motion``) raises a
``ValueError``: the JAX package does not run it either (its step raises a
``TypeError`` where the regressor's bf16 weights meet the f32
moving-region mask in a convolution).

``mesh`` (``parallel/mesh.py``) makes the step data-parallel, as the JAX
step over a sharded batch: each rank passes its own rows
(``shard_batch``), G, D and the VGG start from rank 0's weights
(``replicate``), the BN layers take the global batch's moments and draw
its noise (``nn/norm.py``), the summed (accumulated) G and D gradients are
averaged over the ranks by bucketed all-reduces before the Adam updates,
and so are the logged losses. Every loss is a mean over equal shards (the
SSIM divides per sample), so the mean of the ranks' gradients is the
global batch's. Parameters, statistics, spectral vectors and both Adam
states then stay equal on every rank; ``io/checkpoint.py:
save_checkpoint`` writes from rank 0 only. Without a mesh none of this
runs.

``opt.discriminator_losses`` 'pix2pixHDorigin' trains against the
reference's instance-norm pix2pixHD discriminator (``nn/pix2pixhd.py``,
ndf 64, 3 layers, 2 scales; JAX :78-85), which returns no intermediate
features, so ``GAN_Feat`` is 0.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from slrsfs_tpu_torch.config import Options
from slrsfs_tpu_torch.engine.init_utils import no_tf32, resolve_device
from slrsfs_tpu_torch.engine.profiler import count
from slrsfs_tpu_torch.losses.gan import (
    discriminator_losses,
    generator_gan_losses,
)
from slrsfs_tpu_torch.losses.synthesis import SynthesisLoss
from slrsfs_tpu_torch.models.motion import motion_losses
from slrsfs_tpu_torch.nn.discriminators import MultiscaleDiscriminator
from slrsfs_tpu_torch.nn.vgg import VGG19Features, init_random_vgg

Tensor = torch.Tensor


def make_lr_schedule(base_lr: float, niter: int, niter_decay: int,
                     steps_per_epoch: int) -> Callable[[int], float]:
    """Linear decay from base_lr to 0 over the decay epochs, continuous in
    the step (reference base_model.py:80-93)."""

    def schedule(step: int) -> float:
        epoch = step / steps_per_epoch
        frac = min(max((epoch - niter) / max(niter_decay, 1), 0.0), 1.0)
        return base_lr * (1.0 - frac)

    return schedule


class Adam:
    """optax ``adam(schedule, b1, b2)`` (eps 1e-8, eps_root 0) over a list
    of tensors: mu = (1-b1)·g + b1·mu, nu = (1-b2)·g² + b2·nu, the update
    -lr(count)·mu_hat / (sqrt(nu_hat) + eps) with bias corrections at
    count + 1. Gradients are passed in, not read from ``.grad``."""

    def __init__(self, params: List[Tensor], schedule: Callable[[int], float],
                 b1: float, b2: float, eps: float = 1e-8):
        self.params = list(params)
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: List[Tensor]) -> None:
        lr = self.schedule(self.count)
        self.count += 1
        b1, b2 = self.b1, self.b2
        # the bias corrections in float32, as optax computes them
        bc1 = float(np.float32(1.0) - np.float32(b1) ** self.count)
        bc2 = float(np.float32(1.0) - np.float32(b2) ** self.count)
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.copy_((1.0 - b1) * g + b1 * mu)
            nu.copy_((1.0 - b2) * (g * g) + b2 * nu)
            upd = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            p.add_(upd * -lr)


COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# batch fields that stay float32 in a bf16 step: the motion (bf16 would
# quantise the integrated pixel coordinates; JAX keeps it f32 too) and the
# moving sets
KEEP_F32 = ("motions", "mov_pos", "mov_valid")


def make_discriminator(opt: Options, in_channels: int) -> nn.Module:
    """The discriminator ``opt.discriminator_losses`` names: the reference's
    pix2pixHD origin D for 'pix2pixHDorigin' (ndf 64, 3 layers, 2 scales,
    reference gan_loss.py:127-144), else the spectral multiscale D."""
    if opt.discriminator_losses == "pix2pixHDorigin":
        from slrsfs_tpu_torch.nn.pix2pixhd import OriginMultiscaleDiscriminator

        return OriginMultiscaleDiscriminator(in_channels, ndf=64, n_layers=3, num_D=2)
    return MultiscaleDiscriminator(opt, in_channels=in_channels)


class _ForwardTrain(nn.Module):
    """``model.forward_train`` as a module's forward, for
    ``torch.func.functional_call`` with substituted (bf16) tensors."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, batch, **kw):
        return self.model.forward_train(batch, **kw)


def _grads(loss: Tensor, params: List[Tensor]) -> List[Tensor]:
    """d loss / d params; a parameter the loss does not reach gets zeros."""
    gs = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(params, gs)]


class Trainer:
    """G+D training of a model with ``forward_train`` (stage 1: the
    baseline; stage 2: the background model; stage 3: the SLR model; the
    motion GAN: the regressor; the embedded-motion stages: the baseline
    with a regressor) on ``device`` (the card unless the
    caller asks for the CPU; the model, discriminator and VGG move there).
    ``noise`` is the step's BN-noise generator; ``deterministic`` runs with
    zero noise instead.

    ``extra_losses_fn(opt, pred, synth, epoch=...)`` returns the model's
    losses beyond synthesis and GAN with their weighted sum under ``Total
    Extra`` (stage 3: ``models/slr.py:slr_extra_losses``); epoch is the G
    optimiser's step count before the update // ``steps_per_epoch``, as the
    JAX trainer reads ``state.step``. The sum joins G's total, the terms
    the logs; ``eval_step`` keeps the reconstruction losses alone.

    ``task`` is 'synthesis', 'bg' or 'motion' (the module docstring); the
    motion task builds no VGG."""

    TASKS = ("synthesis", "bg", "motion")

    def __init__(self, opt: Options, model: nn.Module,
                 steps_per_epoch: int = 500, vgg: VGG19Features = None,
                 d_model: nn.Module = None, seed: int = 0,
                 deterministic: bool = False, device="cuda",
                 extra_losses_fn: Optional[Callable] = None,
                 task: str = "synthesis", mesh=None):
        if task not in self.TASKS:
            raise ValueError(f"unknown task {task!r}: one of {self.TASKS}")
        if opt.num_accumulations < 1:
            raise ValueError(f"num_accumulations must be at least 1, got "
                             f"{opt.num_accumulations}")
        if opt.accum_scale not in ("mean", "reference"):
            raise ValueError(f"accum_scale must be 'mean' or 'reference', got "
                             f"{opt.accum_scale!r}")
        if opt.train_compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"train_compute_dtype must be one of "
                             f"{tuple(COMPUTE_DTYPES)}, got {opt.train_compute_dtype!r}")
        if opt.train_compute_dtype == "bfloat16" and opt.train_motion:
            raise ValueError(
                "bfloat16 training with an embedded motion regressor is not "
                "supported: the JAX package does not run it either (its step "
                "raises a TypeError: the regressor's bf16 weights meet the f32 "
                "moving-region mask in a convolution)")
        dev = resolve_device(device if mesh is None else mesh.device)
        self.mesh = mesh
        self.opt = opt
        self.model = model.to(dev)
        self.steps_per_epoch = steps_per_epoch
        self.extra_losses_fn = extra_losses_fn
        self.task = task
        self.deterministic = deterministic
        self.device = dev
        self.use_discriminator = opt.discriminator_losses != "0"
        if d_model is None:
            d_model = make_discriminator(opt, 2 if task == "motion" else 3)
        self.d_model = d_model.to(dev)
        self.vgg = self.synth = None
        if task != "motion":  # the motion task's loss is MotionLoss alone
            if vgg is None:
                vgg = init_random_vgg(VGG19Features(), seed)
            self.vgg = vgg.to(dev).requires_grad_(False)
            self.synth = SynthesisLoss(opt.losses, self.vgg)
        if mesh is not None:
            from slrsfs_tpu_torch.parallel.mesh import attach, replicate

            for m in (self.model, self.d_model, self.vgg):
                if m is not None:
                    replicate(m, mesh)
            attach(self.model, mesh)
            attach(self.d_model, mesh)
        self.accum = opt.num_accumulations
        self.compute_dtype = COMPUTE_DTYPES[opt.train_compute_dtype]
        self.noise = torch.Generator(device=dev)
        self.noise.manual_seed(seed)
        frozen = "motion_regressor." if opt.freeze_motion else None
        named = [(n, p) for n, p in model.named_parameters()
                 if p.requires_grad and not (frozen and n.startswith(frozen))]
        # G's Adam parameters and their names (``last_grads["g"]``' order)
        self.g_names = [n for n, _ in named]
        self.g_params = [p for _, p in named]
        self.d_params = [p for p in self.d_model.parameters()]
        self.opt_g = Adam(self.g_params, make_lr_schedule(
            opt.lr_g, opt.niter, opt.niter_decay, steps_per_epoch),
            opt.beta1, opt.beta2)
        self.opt_d = Adam(self.d_params, make_lr_schedule(
            opt.lr_d, opt.niter, opt.niter_decay, steps_per_epoch),
            opt.beta1, opt.beta2)
        # filled by each step: the G and D gradients, for checks; by each
        # eval_step: its prediction dict
        self.last_grads: Dict[str, List[Tensor]] = {}
        self.last_pred: Dict[str, Tensor] = {}

    @property
    def step_count(self) -> int:
        return self.opt_g.count

    def target(self, batch: Dict) -> Tensor:
        """The reconstruction target: the middle image, the mean video (bg)
        or the ground-truth motion (motion)."""
        if self.task == "bg":
            return batch["mean_video"]
        if self.task == "motion":
            return batch["motions"]
        return batch["images"][1]

    def recon_losses(self, gen: Tensor, target: Tensor) -> Dict[str, Tensor]:
        """The task's reconstruction losses and metrics with "Total Loss"
        (JAX ``_recon_losses``)."""
        if self.task == "motion":
            return motion_losses(self.opt, gen, target)
        losses = self.synth(gen, target)
        if self.task == "bg":
            # stage 2: the total is the MV-weighted synthesis loss
            # (reference 2layers BackgroundNetwork :1196-1203)
            losses = {**{k + "_bg": v for k, v in losses.items()
                         if "Perceptual" in k or "L1" in k},
                      "Total Loss": losses["Total Loss"] * self.opt.MVloss,
                      "psnr": losses["psnr"], "ssim": losses["ssim"]}
        return losses

    def forward_train(self, batch: Dict, plain: bool = False):
        """G's training forward in the compute dtype: (gen_img, pred), both
        float32. In bf16 the parameters, statistics, vectors and float batch
        fields (not the motion or the moving sets) are cast to bf16 inside
        the graph, and the statistics and vectors the forward updated are
        stored back in float32."""
        if self.compute_dtype == torch.float32:
            return self.model.forward_train(batch, train=True,
                                            deterministic=self.deterministic,
                                            noise=self.noise, plain=plain)
        cd = self.compute_dtype

        def cast(v):
            if isinstance(v, (list, tuple)):
                return [cast(x) for x in v]
            return v.to(cd) if torch.is_floating_point(v) else v

        state = {n: p.to(cd) for n, p in self.model.named_parameters()}
        buffers = {n: cast(b) for n, b in self.model.named_buffers()}
        state.update(buffers)
        batch_c = {k: v if k in KEEP_F32 else cast(v) for k, v in batch.items()}
        gen_img, pred = torch.func.functional_call(
            _ForwardTrain(self.model), {"model." + n: t for n, t in state.items()},
            (batch_c,), dict(train=True, deterministic=self.deterministic,
                             noise=self.noise, plain=plain))
        with torch.no_grad():
            for n, b in self.model.named_buffers():
                b.copy_(buffers[n])
        f32 = torch.float32
        return gen_img.to(f32), {k: v.to(f32) if torch.is_floating_point(v) else v
                                 for k, v in pred.items()}

    def g_losses(self, batch: Dict, plain: bool = False):
        """Generator forward and losses: (total, logs, gen_img)."""
        gen_img, pred = self.forward_train(batch, plain)
        middle = self.target(batch)
        losses = self.recon_losses(gen_img, middle)
        total = losses["Total Loss"]
        logs = dict(losses)
        if self.extra_losses_fn is not None:
            extra = self.extra_losses_fn(
                self.opt, pred, self.synth,
                epoch=self.opt_g.count // self.steps_per_epoch)
            total = total + extra.pop("Total Extra")
            logs.update(extra)
        if self.use_discriminator:
            g_gan = generator_gan_losses(
                self.d_model, gen_img, middle, self.opt.gan_mode,
                self.opt.lambda_feat, train=False)
            total = total + g_gan["Total Loss"]
            logs.update({k: v for k, v in g_gan.items() if k != "Total Loss"})
        logs["Total Loss"] = total
        return total, logs, gen_img

    def _micro_step(self, batch: Dict, plain: bool, mark):
        """G and D gradients and the logs of one micro-batch."""
        self.d_model.requires_grad_(False)
        total, logs, gen_img = self.g_losses(batch, plain)
        mark("G forward")
        g_grads = _grads(total, self.g_params)
        mark("G backward")
        self.d_model.requires_grad_(True)
        d_grads = None
        if self.use_discriminator:
            d = discriminator_losses(self.d_model, gen_img, self.target(batch),
                                     self.opt.gan_mode, train=True)
            d_grads = _grads(d["Total Loss"], self.d_params)
            logs["D_Fake"], logs["D_real"] = d["D_Fake"], d["D_real"]
            mark("D step")
        return g_grads, d_grads, {k: v.detach() for k, v in logs.items()}

    def train_step(self, batch, plain: bool = False,
                   timer: Optional[Callable[[str], None]] = None
                   ) -> Dict[str, Tensor]:
        """One optimizer step of G and D on ``batch`` (tensors on the
        model's device), or on a list of ``opt.num_accumulations``
        micro-batches. ``plain`` runs the K3/K7 plain versions. ``timer``,
        when given, is called with a stage name after each stage (G forward,
        G backward, D step, per micro-batch; with a mesh all-reduce;
        updates). Each step adds one to the counter ``train.steps``
        (``engine.profiler.count``). Returns the logged losses, detached
        (with accumulation, the micro-batches' means; with a mesh, the
        ranks' means)."""
        mark = timer or (lambda _name: None)
        micro = list(batch) if isinstance(batch, (list, tuple)) else [batch]
        if len(micro) != self.accum:
            raise ValueError(f"a step takes {self.accum} micro-batches, got {len(micro)}")
        count("train.steps")
        with no_tf32():
            g_grads, d_grads, logs = self._micro_step(micro[0], plain, mark)
            for b in micro[1:]:
                g, d, l = self._micro_step(b, plain, mark)
                g_grads = [a + x for a, x in zip(g_grads, g)]
                if d_grads is not None:
                    d_grads = [a + x for a, x in zip(d_grads, d)]
                logs = {k: logs[k] + l[k] for k in logs}
            if self.accum > 1:
                k = float(self.accum)
                w = k if self.opt.accum_scale == "reference" else 1.0 / k
                g_grads = [g * w for g in g_grads]
                if d_grads is not None:
                    d_grads = [d * w for d in d_grads]
                logs = {n: v * (1.0 / k) for n, v in logs.items()}
            if self.mesh is not None:
                logs = self._reduce(g_grads, d_grads or [], logs)
                mark("all-reduce")
            self.opt_g.step(g_grads)
            if d_grads is not None:
                self.opt_d.step(d_grads)
            mark("updates")
        self.last_grads = {"g": g_grads, "d": d_grads or []}
        return logs

    def _reduce(self, g_grads, d_grads, logs):
        """The gradients averaged over the ranks in place, and the logs'
        means."""
        from slrsfs_tpu_torch.parallel.mesh import all_reduce_mean

        keys = list(logs)
        stacked = torch.stack([logs[k].to(torch.float32) for k in keys])
        all_reduce_mean(g_grads + d_grads + [stacked], self.mesh)
        return dict(zip(keys, stacked.unbind()))

    def snapshot(self) -> Dict:
        """Copies of all that a step changes: G and D weights and buffers,
        both Adam states and the noise generator's state."""
        def copy(ts):
            return [t.clone() for t in ts]

        return {"g": {k: v.clone() for k, v in self.model.state_dict().items()},
                "d": {k: v.clone() for k, v in self.d_model.state_dict().items()},
                "adam": [(o.count, copy(o.mu), copy(o.nu))
                         for o in (self.opt_g, self.opt_d)],
                "noise": self.noise.get_state()}

    @torch.no_grad()
    def restore(self, snap: Dict) -> None:
        """Return to a ``snapshot``."""
        self.model.load_state_dict(snap["g"])
        self.d_model.load_state_dict(snap["d"])
        for o, (count, mu, nu) in zip((self.opt_g, self.opt_d), snap["adam"]):
            o.count = count
            for dst, src in zip(o.mu + o.nu, mu + nu):
                dst.copy_(src)
        self.noise.set_state(snap["noise"])

    @torch.no_grad()
    def eval_step(self, batch: Dict) -> Dict[str, Tensor]:
        """Validation forward (reference base_model.py:106-116): eval-mode
        BN and spectral weights, noise drawn unless deterministic, in
        float32. Keeps the prediction dict in ``last_pred`` (the CLI's
        validation images)."""
        with no_tf32():
            gen_img, self.last_pred = self.model.forward_train(
                batch, train=False, deterministic=self.deterministic,
                noise=self.noise)
            return self.recon_losses(gen_img, self.target(batch))
