"""Evaluation metrics of the CLAW protocol (PyTorch port of
``slrsfs_tpu/eval/metrics.py``; reference ``evaluation/animation/
metrics.py`` and ``models/networks/pretrained_networks.py:34-95``).

* PSNR: images in [0, 1], the MSE over pixels and channels, 10·log10(1/mse);
* SSIM: the Gaussian-window SSIM of ``losses/ssim.py``;
* Perceptual: PNet, the sum over the VGG16 slices of 1 − cosine similarity
  over channels, spatially averaged; inputs scaled to [-1, 1], then the
  LPIPS shift/scale;
* LPIPS: alex v0.1, unit-normalised channel features, learned linear
  weights, spatial mean, summed over the slices.

Perceptual and LPIPS need the user's weight files (torchvision and lpips
``.pth``); without them ``PerceptualMetrics`` gives PSNR and SSIM only. The
networks run in float32 with TF32 off on the card.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from slrsfs_tpu_torch.engine.init_utils import no_tf32, resolve_device
from slrsfs_tpu_torch.eval.feature_nets import (
    AlexNetFeatures,
    VGG16Features,
    load_lpips_alex,
)
from slrsfs_tpu_torch.losses.ssim import ssim as _ssim

Tensor = torch.Tensor

# LPIPS input normalisation (pretrained_networks.py:45-46)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def psnr01(pred: Tensor, gt: Tensor, mask: Optional[Tensor] = None) -> Tensor:
    """metrics.py:11-23; images (B, H, W, 3) in [0, 1], mask (B, H, W, 1)."""
    b = pred.shape[0]
    if mask is not None:
        err = torch.square(pred - gt) * mask
        mse = err.reshape(b, -1).sum(1) / (
            3 * mask.reshape(b, -1).sum(1).clamp(min=1))
    else:
        mse = torch.square(pred - gt).reshape(b, -1).mean(1)
    return torch.mean(10.0 * torch.log10(1.0 / mse))


def ssim01(pred: Tensor, gt: Tensor, mask: Optional[Tensor] = None) -> Tensor:
    return torch.mean(_ssim(pred, gt, mask=mask))


def _unit(a: Tensor) -> Tensor:
    """``a`` over its channel norm (NCHW), as LPIPS normalises."""
    return a / (torch.linalg.vector_norm(a, dim=1, keepdim=True) + 1e-10)


def _cos_dist(a: Tensor, b: Tensor) -> Tensor:
    """1 − cosine similarity over channels (NCHW), averaged spatially."""
    return torch.mean(1.0 - torch.sum(_unit(a) * _unit(b), dim=1))


def _load(path: str, net: torch.nn.Module, dev: torch.device) -> torch.nn.Module:
    """A torchvision ``.pth`` (the whole model's or its features') into
    ``net``'s ``features``, every key required."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    net.load_state_dict({k: v for k, v in sd.items() if k.startswith("features.")})
    return net.to(dev).eval()


class PerceptualMetrics:
    """PSNR, SSIM and the weight-gated PNet-VGG16 'Perceptual' and
    LPIPS-alex metrics on ``device`` (default the card; a missing card
    raises)."""

    def __init__(self, vgg16_pth: Optional[str] = None,
                 alexnet_pth: Optional[str] = None,
                 lpips_pth: Optional[str] = None, device="cuda"):
        self.device = resolve_device(device)
        self.vgg = self.alex = None
        self.lpips_w: Optional[List[Tensor]] = None
        if vgg16_pth:
            self.vgg = _load(vgg16_pth, VGG16Features(), self.device)
        if alexnet_pth:
            self.alex = _load(alexnet_pth, AlexNetFeatures(), self.device)
            if lpips_pth:
                sd = torch.load(lpips_pth, map_location="cpu", weights_only=False)
                self.lpips_w = [w.to(self.device)[None, :, None, None]
                                for w in load_lpips_alex(sd)]
        self._shift = torch.tensor(_SHIFT, device=self.device)
        self._scale = torch.tensor(_SCALE, device=self.device)

    @property
    def has_perceptual(self) -> bool:
        return self.vgg is not None

    @property
    def has_lpips(self) -> bool:
        return self.alex is not None and self.lpips_w is not None

    def _norm_input(self, img01: Tensor) -> Tensor:
        return (img01 * 2.0 - 1.0 - self._shift) / self._scale

    def perceptual(self, pred01: Tensor, gt01: Tensor) -> Tensor:
        """PNet forward (pretrained_networks.py:68-95)."""
        fa = self.vgg(self._norm_input(pred01))
        fb = self.vgg(self._norm_input(gt01))
        return sum(_cos_dist(a, b) for a, b in zip(fa, fb))

    def lpips(self, pred01: Tensor, gt01: Tensor) -> Tensor:
        """LPIPS v0.1 alex: unit-norm features, linear weights, mean."""
        fa = self.alex(self._norm_input(pred01))
        fb = self.alex(self._norm_input(gt01))
        return sum(torch.mean(torch.sum(torch.square(_unit(a) - _unit(b)) * w, dim=1))
                   for w, a, b in zip(self.lpips_w, fa, fb))

    @torch.no_grad()
    def all_metrics(self, pred01, gt01) -> Dict[str, float]:
        """(B, H, W, 3) float arrays or tensors in [0, 1] → the metrics the
        weights allow, as floats (SSIM's mean runs over the batch: the
        protocol scores one frame a call)."""
        pred = torch.as_tensor(pred01, dtype=torch.float32, device=self.device)
        gt = torch.as_tensor(gt01, dtype=torch.float32, device=self.device)
        with no_tf32():
            out = {"PSNR": float(psnr01(pred, gt)), "SSIM": float(ssim01(pred, gt))}
            if self.has_perceptual:
                out["Perceptual"] = float(self.perceptual(pred, gt))
            if self.has_lpips:
                out["LPIPS"] = float(self.lpips(pred, gt))
        return out
