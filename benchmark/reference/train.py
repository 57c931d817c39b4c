"""The G+D training step, plain, frozen for the benchmark's reference: one
generator step (synthesis, GAN-G and the model type's own losses, such as
SLR stage 3's; D in eval mode) and one discriminator step on the same fake
images, each followed by an optax-style Adam update, in float32 on one
process, as ``slrsfs_tpu_torch/engine/trainer.py:Trainer.train_step``
computes it (no accumulation, no mesh, no bf16). The splat and the
integration are the plain versions of ``benchmark/reference/ops.py``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from benchmark.reference.config import Options
from benchmark.reference.init_utils import no_tf32, tf32
from benchmark.reference.losses.gan import discriminator_losses, generator_gan_losses
from benchmark.reference.losses.synthesis import SynthesisLoss
from benchmark.reference.nn.discriminators import MultiscaleDiscriminator
from benchmark.reference.nn.vgg import VGG19Features

Tensor = torch.Tensor


def make_lr_schedule(base_lr: float, niter: int, niter_decay: int,
                     steps_per_epoch: int) -> Callable[[int], float]:
    """Linear decay from base_lr to 0 over the decay epochs."""

    def schedule(step: int) -> float:
        epoch = step / steps_per_epoch
        frac = min(max((epoch - niter) / max(niter_decay, 1), 0.0), 1.0)
        return base_lr * (1.0 - frac)

    return schedule


class Adam:
    """optax ``adam(schedule, b1, b2)``, eps 1e-8, bias corrections in
    float32 at count + 1."""

    def __init__(self, params: List[Tensor], schedule, b1: float, b2: float,
                 eps: float = 1e-8):
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
        bc1 = float(np.float32(1.0) - np.float32(b1) ** self.count)
        bc2 = float(np.float32(1.0) - np.float32(b2) ** self.count)
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.copy_((1.0 - b1) * g + b1 * mu)
            nu.copy_((1.0 - b2) * (g * g) + b2 * nu)
            p.add_((mu / bc1) / (torch.sqrt(nu / bc2) + self.eps) * -lr)


def geometric_bucket(n: int, pad_multiple: int, bucket_ratio: float,
                     cap: int) -> int:
    """Round ``n`` up onto the series {pad_multiple·⌈ratio^k⌉} capped at
    ``cap``, so a sweep sees a bounded set of moving-set sizes."""
    target = max(pad_multiple, -(-n // pad_multiple) * pad_multiple)
    cap = max(pad_multiple, -(-cap // pad_multiple) * pad_multiple)
    b = pad_multiple
    while b < min(target, cap):
        # max(..., b + pad_multiple) forces progress for ratios close to 1
        b = min(cap, max(b + pad_multiple,
                         -(-int(b * bucket_ratio) // pad_multiple)
                         * pad_multiple))
    return b


def attach_moving_sets(batch: Dict, max_frac: float = 0.5,
                       state: Optional[Dict] = None, eps: float = 0.0) -> Dict:
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


def to_device(batch: Dict, device) -> Dict:
    """numpy batch → tensors on ``device`` (images a list of three)."""
    def t(a):
        return torch.from_numpy(np.array(a, copy=True, order="C")).to(device)

    return {k: [t(x) for x in v] if k == "images" else t(v) for k, v in batch.items()}


def build_models(opt: Options, g):
    """(G, D, VGG19 features): the generator ``g`` of ``opt``'s model type
    with the discriminator and loss network every stage shares, on the CPU
    with uninitialised weights."""
    return g, MultiscaleDiscriminator(opt, in_channels=3), VGG19Features()


def _grads(loss: Tensor, params: List[Tensor]) -> List[Tensor]:
    gs = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(params, gs)]


class ReferenceTrainer:
    """The step of ``Trainer`` for the 'synthesis' task in float32, on
    models whose weights the caller loaded. The BN-noise generator is
    seeded with ``seed``, as the port's trainer seeds its own; with
    ``seed`` None the noise is zero (to count operations on the meta
    device). ``allow_tf32`` runs the convolutions and products in TF32:
    the control. ``extra_losses(opt, pred, synth, epoch)``, where the model
    type has one, adds its losses to the generator's (SLR's set)."""

    def __init__(self, opt: Options, model, d_model, vgg, seed: Optional[int],
                 steps_per_epoch: int, device, allow_tf32: bool = False,
                 extra_losses: Optional[Callable] = None):
        self.opt = opt
        self.model, self.d_model = model, d_model
        self.vgg = vgg.requires_grad_(False)
        self.synth = SynthesisLoss(opt.losses, self.vgg)
        self.allow_tf32 = allow_tf32
        self.extra = extra_losses
        self.steps_per_epoch = steps_per_epoch
        self.noise = None
        if seed is not None:
            self.noise = torch.Generator(device=device)
            self.noise.manual_seed(seed)
        self.g_names = [n for n, p in model.named_parameters() if p.requires_grad]
        self.g_params = [p for p in model.parameters() if p.requires_grad]
        self.d_params = list(d_model.parameters())
        self.opt_g = Adam(self.g_params, make_lr_schedule(
            opt.lr_g, opt.niter, opt.niter_decay, steps_per_epoch), opt.beta1, opt.beta2)
        self.opt_d = Adam(self.d_params, make_lr_schedule(
            opt.lr_d, opt.niter, opt.niter_decay, steps_per_epoch), opt.beta1, opt.beta2)

    def step(self, batch: Dict) -> Dict[str, Tensor]:
        """One G and D update on ``batch``; returns the logged losses."""
        opt = self.opt
        with tf32() if self.allow_tf32 else no_tf32():
            self.d_model.requires_grad_(False)
            gen_img, pred = self.model.forward_train(
                batch, train=True, deterministic=self.noise is None, noise=self.noise)
            middle = batch["images"][1]
            losses = self.synth(gen_img, middle)
            total = losses["Total Loss"]
            logs = dict(losses)
            if self.extra is not None:
                extra = self.extra(opt, pred, self.synth,
                                   epoch=self.opt_g.count // self.steps_per_epoch)
                total = total + extra.pop("Total Extra")
                logs.update(extra)
            g_gan = generator_gan_losses(self.d_model, gen_img, middle, opt.gan_mode,
                                         opt.lambda_feat, train=False)
            total = total + g_gan["Total Loss"]
            logs["Total Loss"] = total
            g_grads = _grads(total, self.g_params)
            self.d_model.requires_grad_(True)
            d = discriminator_losses(self.d_model, gen_img, middle, opt.gan_mode, train=True)
            d_grads = _grads(d["Total Loss"], self.d_params)
            self.opt_g.step(g_grads)
            self.opt_d.step(d_grads)
        return {k: v.detach() for k, v in logs.items()}
