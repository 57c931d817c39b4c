"""Reconstruction and perceptual losses (PyTorch port of
``slrsfs_tpu/losses/synthesis.py``; reference ``models/losses/synthesis.py``).

``SynthesisLoss`` parses the reference's ``--losses '1.0_l1' '10.0_content'``
strings and adds the PSNR and SSIM metrics. Images are NHWC in [-1, 1].
``MotionLoss`` parses ``--motion-losses '10.0_EndPointError'`` (the motion
stages' loss on flow, NHWC).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from benchmark.reference.losses.ssim import ssim
from benchmark.reference.nn.vgg import VGG19Features

Tensor = torch.Tensor

PERCEPTUAL_WEIGHTS = (1.0 / 32, 1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0)


def l1(pred: Tensor, gt: Tensor) -> Tensor:
    return torch.mean(torch.abs(pred - gt))


def psnr(pred: Tensor, gt: Tensor) -> Tensor:
    """Reference PSNR (synthesis.py:113-122): the MSE sums the channels."""
    bs = pred.shape[0]
    mse = torch.square(pred - gt).sum(dim=-1).reshape(bs, -1).mean(dim=1)
    return torch.mean(10.0 * torch.log10(1.0 / mse))


def perceptual(vgg: VGG19Features, pred: Tensor, gt: Tensor) -> Tensor:
    """VGG19 five-slice weighted L1 (synthesis.py:166-185); no gradient
    reaches ``gt``."""
    pf = vgg(pred)
    with torch.no_grad():
        gf = vgg(gt)
    loss = 0.0
    for w, p, g in zip(PERCEPTUAL_WEIGHTS, pf, gf):
        loss = loss + w * torch.mean(torch.abs(p - g))
    return loss


def _gram(x: Tensor) -> Tensor:
    """(B, C, C) Gram matrix of NCHW features over (C·H·W)."""
    b, c, h, w = x.shape
    f = x.reshape(b, c, h * w)
    return torch.bmm(f, f.transpose(1, 2)) / (c * h * w)


def style(vgg: VGG19Features, pred: Tensor, gt: Tensor) -> Tensor:
    """Gram-matrix MSE over the five VGG19 slices with the perceptual
    weights (synthesis.py:187-233); the target's Gram matrices carry no
    gradient."""
    pf = vgg(pred)
    with torch.no_grad():
        gf = vgg(gt)
    loss = 0.0
    for w, p, g in zip(PERCEPTUAL_WEIGHTS, pf, gf):
        loss = loss + w * torch.mean(torch.square(_gram(p) - _gram(g).detach()))
    return loss


class SynthesisLoss:
    """Combiner for '--losses λ_name' strings (l1, content, style) plus
    PSNR/SSIM metrics."""

    NAMES = ("l1", "content", "style")

    def __init__(self, losses: Sequence[str],
                 vgg: Optional[VGG19Features] = None, subname: str = ""):
        self.pairs: list[Tuple[float, str]] = []
        for s in losses:
            lam, name = s.split("_")
            if name not in self.NAMES:
                raise ValueError(f"unknown synthesis loss: {name}")
            self.pairs.append((float(lam), name))
        self.vgg = vgg
        self.subname = subname

    def __call__(self, pred: Tensor, gt: Tensor) -> Dict[str, Tensor]:
        out: Dict[str, Tensor] = {}
        total = None
        for lam, name in self.pairs:
            if name == "l1":
                v = l1(pred, gt)
                out["L1" + self.subname] = v
            elif name == "content":
                v = perceptual(self.vgg, pred, gt)
                out["Perceptual" + self.subname] = v
            else:
                v = style(self.vgg, pred, gt)
                out["Style" + self.subname] = v
            # reference quirk kept: the FIRST loss enters Total without its
            # lambda (synthesis.py:98-105)
            total = v if total is None else total + lam * v
        if total is None:
            total = torch.zeros((), device=pred.device)
        with torch.no_grad():  # metrics only
            out["psnr" + self.subname] = psnr(pred, gt)
            out["ssim" + self.subname] = ssim(pred, gt)
        out["Total Loss"] = total
        return out


def end_point_error(pred_motion: Tensor, gt_motion: Tensor) -> Tensor:
    """The mean L2 norm of the difference; 3-channel uv·m motion folded
    first (synthesis.py:147-160). NHWC. At an exactly zero difference the
    norm's gradient is 0 here and NaN in JAX."""

    def fold(m):
        return m[..., :2] * m[..., 2:3] if m.shape[-1] == 3 else m

    d = fold(pred_motion) - fold(gt_motion)
    return torch.mean(torch.linalg.vector_norm(d, dim=-1))


class MotionLoss:
    """Reference MotionLoss (synthesis.py:11-58): 'λ_MotionL1' and
    'λ_EndPointError', each weighted by its λ into "Total Loss"."""

    NAMES = ("MotionL1", "EndPointError")

    def __init__(self, losses: Sequence[str]):
        self.pairs: list[Tuple[float, str]] = []
        for s in losses:
            lam, name = s.split("_")
            if name not in self.NAMES:
                raise ValueError(f"unknown motion loss: {name}")
            self.pairs.append((float(lam), name))

    def __call__(self, pred_motion: Tensor, gt_motion: Tensor) -> Dict[str, Tensor]:
        out: Dict[str, Tensor] = {}
        total = torch.zeros((), device=pred_motion.device)
        for lam, name in self.pairs:
            if name == "MotionL1":
                v = l1(pred_motion, gt_motion)
            else:
                v = end_point_error(pred_motion, gt_motion)
            out[name] = v
            total = total + lam * v
        out["Total Loss"] = total
        return out
