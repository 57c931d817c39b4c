"""pix2pixHD-style multiscale PatchGAN discriminator (PyTorch port of
``slrsfs_tpu/nn/discriminators.py``).

``NLayerDiscriminator`` (4x4 convs, spectral norm plus affine-free instance
norm per ``--norm_D spectralinstance``, intermediate features returned) and
``MultiscaleDiscriminator`` (``num_D`` scales with count-exclude-pad average
pooling between them). Children are named as in the reference
(``discriminator_{i}.model{n}``; the norm wrapper nests the spectral conv
as ``model{n}.0.0``), so the reference checkpoint's ``netD.netD.*`` keys
load as they are (``slrsfs_tpu/io/checkpoint.py:215-238``). Images go in
NHWC; the per-group outputs come back NCHW. ``train`` runs the spectral
power iterations (``nn/norm.py``).
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.config import Options
from benchmark.reference.nn.conv import Conv

Tensor = torch.Tensor


def instance_norm(x: Tensor, eps: float = 1e-5) -> Tensor:
    """torch InstanceNorm2d(affine=False): per-sample, per-channel spatial
    normalisation with the biased variance."""
    m = x.mean(dim=(2, 3), keepdim=True)
    v = torch.square(x - m).mean(dim=(2, 3), keepdim=True)
    return (x - m) * torch.rsqrt(v + eps)


class NLayerDiscriminator(nn.Module):
    """Reference discriminators.py:78-139."""

    def __init__(self, opt: Options, in_channels: int = 3):
        super().__init__()
        kw, padw = 4, 2
        nf = opt.ndf
        self.n_layers = opt.n_layers_D
        self.model0 = nn.Sequential(Conv(in_channels, nf, kw, 2, padw))
        for n in range(1, self.n_layers):
            nf_prev, nf = nf, min(nf * 2, 512)
            stride = 1 if n == self.n_layers - 1 else 2
            # norm_D 'spectralinstance': a bias-free spectral conv, then
            # instance norm (reference normalization.py:95-130)
            setattr(self, f"model{n}", nn.Sequential(nn.Sequential(
                Conv(nf_prev, nf, kw, stride, padw, use_bias=False,
                     spectral=True))))
        setattr(self, f"model{self.n_layers}",
                nn.Sequential(Conv(nf, 1, kw, 1, padw)))

    def forward(self, x: Tensor, train: bool = True) -> List[Tensor]:
        h = F.leaky_relu(self.model0[0](x, train), 0.2)
        results = [h]
        for n in range(1, self.n_layers):
            h = getattr(self, f"model{n}")[0][0](h, train)
            h = F.leaky_relu(instance_norm(h), 0.2)
            results.append(h)
        results.append(getattr(self, f"model{self.n_layers}")[0](h, train))
        return results


def downsample_d(x: Tensor) -> Tensor:
    """avg_pool2d(3, 2, padding 1, count_include_pad=False)."""
    return F.avg_pool2d(x, 3, 2, 1, count_include_pad=False)


class MultiscaleDiscriminator(nn.Module):
    """Reference discriminators.py:142-207."""

    def __init__(self, opt: Options, in_channels: int = 3):
        super().__init__()
        self.num_D = opt.num_D
        for i in range(self.num_D):
            setattr(self, f"discriminator_{i}",
                    NLayerDiscriminator(opt, in_channels))

    def forward(self, x: Tensor, train: bool = True) -> List[List[Tensor]]:
        """x (B, H, W, C) → per scale, the per-group outputs."""
        h = x.permute(0, 3, 1, 2)
        out = []
        for i in range(self.num_D):
            out.append(getattr(self, f"discriminator_{i}")(h, train))
            h = downsample_d(h)
        return out
