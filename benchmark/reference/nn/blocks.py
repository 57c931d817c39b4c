"""BigGAN-style ResNet blocks (PyTorch port of ``slrsfs_tpu/nn/blocks.py``).
Child names follow the reference's ``models/layers/blocks.py`` so the
``state_dict`` keys are the reference's: ``ResNetBlock`` keeps the ``ch_a``
(0 = bn_noise1, 2 = conv_aa, 3 = bn_noise2, 5 = conv_ab) and ``ch_b``
(0 = conv_b) sequences. ``train`` and ``noise`` are the switches of
``nn/norm.py``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.nn.conv import (
    Conv,
    PartialConv,
    avg_pool_3x3s2,
    max_pool_3x3s2,
    upsample_bilinear_2x,
    upsample_nearest_2x,
)
from benchmark.reference.nn.norm import NoiseBN

Tensor = torch.Tensor


def _activation(name: Optional[str]):
    if name == "LRelu":
        return lambda x: F.leaky_relu(x, 0.2)
    if name == "PRelu":  # reference option; PReLU init slope 0.25
        return lambda x: torch.where(x >= 0, x, 0.25 * x)
    return F.relu  # 'Relu', None, and unknown all fall back to ReLU


def _resample_feat(x: Tensor, mode) -> Tensor:
    if mode == "Up":
        return upsample_bilinear_2x(x)
    if mode:  # True or "Down"
        return avg_pool_3x3s2(x)
    return x


class ResNetBlock(nn.Module):
    """(noise-BN → ReLU → 3x3 conv) ×2 plus a 1x1 shortcut when the shape
    changes; Down = AvgPool(3,2,1), Up = bilinear 2x (reference blocks.py:47-87)."""

    def __init__(self, in_channels: int, features: int, downsample=False,
                 spectral: bool = True):
        super().__init__()
        self.downsample = downsample
        self.ch_a = nn.Sequential(
            NoiseBN(in_channels, spectral),
            nn.ReLU(),
            Conv(in_channels, features, 3, 1, 1, spectral=spectral),
            NoiseBN(features, spectral),
            nn.ReLU(),
            Conv(features, features, 3, 1, 1, spectral=spectral),
        )
        self.ch_b = None
        if downsample or in_channels != features:
            self.ch_b = nn.Sequential(
                Conv(in_channels, features, 1, 1, 0, spectral=spectral))

    def forward(self, x: Tensor, train: bool = False,
                noise: Optional[torch.Generator] = None) -> Tensor:
        a = self.ch_a
        h = a[2](F.relu(a[0](x, train=train, noise=noise)), train)
        h = a[5](F.relu(a[3](h, train=train, noise=noise)), train)
        h = _resample_feat(h, self.downsample)
        sc = x if self.ch_b is None else _resample_feat(self.ch_b[0](x, train),
                                                        self.downsample)
        return h + sc


class ResNetBlockPconv2(nn.Module):
    """Partial-conv block: separate feature/mask resampling (Down: AvgPool
    feature / MaxPool mask; Up: bilinear feature / nearest mask), mask-aware
    noise-BN ('pbn'), optionally bias-free shortcut ('woresbias')
    (reference blocks.py:173-248)."""

    def __init__(self, in_channels: int, features: int, downsample=False,
                 activation: Optional[str] = "Relu", spectral: bool = True,
                 partial_bn: bool = True, shortcut_bias: bool = False):
        super().__init__()
        self.downsample = downsample
        self.act = _activation(activation)
        self.bn_noise1 = NoiseBN(in_channels, spectral, partial=partial_bn)
        self.conv_aa = PartialConv(in_channels, features, 3, 1, 1,
                                   spectral=spectral)
        self.bn_noise2 = NoiseBN(features, spectral, partial=partial_bn)
        self.conv_ab = PartialConv(features, features, 3, 1, 1,
                                   spectral=spectral)
        self.conv_b = None
        if downsample or in_channels != features:
            self.conv_b = Conv(in_channels, features, 1, 1, 0,
                               use_bias=shortcut_bias, spectral=spectral)

    def _resample_mask(self, m: Tensor) -> Tensor:
        if self.downsample == "Down":
            return max_pool_3x3s2(m)
        if self.downsample == "Up":
            return upsample_nearest_2x(m)
        return m

    def forward(self, x: Tensor, mask: Tensor, train: bool = False,
                noise: Optional[torch.Generator] = None
                ) -> Tuple[Tensor, Tensor]:
        h = self.act(self.bn_noise1(x, mask, train, noise))
        h, m = self.conv_aa(h, mask, train)
        h = self.act(self.bn_noise2(h, m, train, noise))
        h, m = self.conv_ab(h, m, train)
        h = _resample_feat(h, self.downsample)
        m = self._resample_mask(m)
        sc = x if self.conv_b is None else _resample_feat(self.conv_b(x, train),
                                                          self.downsample)
        return h + sc, m
