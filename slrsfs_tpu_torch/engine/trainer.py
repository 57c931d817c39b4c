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

This port supports one micro-batch per step and float32 compute; the
reference's accumulation and the bf16 training mode raise.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from slrsfs_tpu_torch.config import Options
from slrsfs_tpu_torch.engine.init_utils import no_tf32, resolve_device
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
                 task: str = "synthesis"):
        if task not in self.TASKS:
            raise ValueError(f"unknown task {task!r}: one of {self.TASKS}")
        if opt.num_accumulations != 1:
            raise NotImplementedError(
                "num_accumulations > 1 is not ported yet (ROADMAP §1, \"The rest "
                "of training\")")
        if opt.train_compute_dtype != "float32":
            raise NotImplementedError(
                "bfloat16 training is not ported yet (ROADMAP §1, \"The rest of "
                "training\")")
        if opt.discriminator_losses == "pix2pixHDorigin":
            raise NotImplementedError(
                "the pix2pixHDorigin discriminator is not ported yet (ROADMAP §1, "
                "\"The rest of training\")")
        dev = resolve_device(device)
        self.opt = opt
        self.model = model.to(dev)
        self.steps_per_epoch = steps_per_epoch
        self.extra_losses_fn = extra_losses_fn
        self.task = task
        self.deterministic = deterministic
        self.device = dev
        self.use_discriminator = opt.discriminator_losses != "0"
        if d_model is None:
            d_model = MultiscaleDiscriminator(opt, in_channels=2 if task == "motion" else 3)
        self.d_model = d_model.to(dev)
        self.vgg = self.synth = None
        if task != "motion":  # the motion task's loss is MotionLoss alone
            if vgg is None:
                vgg = init_random_vgg(VGG19Features(), seed)
            self.vgg = vgg.to(dev).requires_grad_(False)
            self.synth = SynthesisLoss(opt.losses, self.vgg)
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
        # filled by each step: the G and D gradients, for checks
        self.last_grads: Dict[str, List[Tensor]] = {}

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

    def g_losses(self, batch: Dict, plain: bool = False):
        """Generator forward and losses: (total, logs, gen_img)."""
        gen_img, pred = self.model.forward_train(
            batch, train=True, deterministic=self.deterministic,
            noise=self.noise, plain=plain)
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

    def train_step(self, batch: Dict, plain: bool = False,
                   timer: Optional[Callable[[str], None]] = None
                   ) -> Dict[str, Tensor]:
        """One optimizer step of G and D on ``batch`` (tensors on the
        model's device). ``plain`` runs the K3/K7 plain versions. ``timer``,
        when given, is called with a stage name after each stage (G forward,
        G backward, D step, updates). Returns the logged losses, detached."""
        mark = timer or (lambda _name: None)
        with no_tf32():
            self.d_model.requires_grad_(False)
            total, logs, gen_img = self.g_losses(batch, plain)
            mark("G forward")
            g_grads = _grads(total, self.g_params)
            mark("G backward")
            self.d_model.requires_grad_(True)
            d_grads = None
            if self.use_discriminator:
                d = discriminator_losses(self.d_model, gen_img,
                                         self.target(batch),
                                         self.opt.gan_mode, train=True)
                d_grads = _grads(d["Total Loss"], self.d_params)
                logs["D_Fake"], logs["D_real"] = d["D_Fake"], d["D_real"]
                mark("D step")
            self.opt_g.step(g_grads)
            if d_grads is not None:
                self.opt_d.step(d_grads)
            mark("updates")
        self.last_grads = {"g": g_grads, "d": d_grads or []}
        return {k: v.detach() for k, v in logs.items()}

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
        BN and spectral weights, noise drawn unless deterministic."""
        with no_tf32():
            gen_img, _ = self.model.forward_train(
                batch, train=False, deterministic=self.deterministic,
                noise=self.noise)
            return self.recon_losses(gen_img, self.target(batch))
