"""NCHW convolutions: plain or spectral, and partial (mask-aware); pools and
2x upsampling (PyTorch port of ``slrsfs_tpu/nn/conv.py``).

Partial convolution follows the NVIDIA semantics the decoder uses: the mask
count under each window rescales the output by ``winsize / count`` and the
propagated mask is ``clamp(count, 0, 1)``. As in the JAX package the mask is
kept single-channel after the first layer (the reference's per-channel mask
is channel-constant there); the first layer's mask may be per-channel, and
its channel sum is what the count needs. The mask carries no gradient.

``train`` runs a spectral weight's power iteration (``nn/norm.py``).
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from slrsfs_tpu_torch.nn.norm import effective_weight, register_weight

Tensor = torch.Tensor


class Conv(nn.Module):
    """Plain or spectrally normalised conv (reference blocks.py:5-11)."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1, use_bias: bool = True,
                 spectral: bool = False):
        super().__init__()
        self.stride, self.padding = stride, padding
        register_weight(self, (features, in_channels, kernel_size, kernel_size),
                        spectral)
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None

    def forward(self, x: Tensor, train: bool = False) -> Tensor:
        return F.conv2d(x, effective_weight(self, train), self.bias,
                        self.stride, self.padding)


class PartialConv(Conv):
    """Mask-aware conv; ``forward(x, mask) -> (out, update_mask (B,1,H,W))``.

    Reference ``PartialConv2d`` with multi_channel=True, return_mask=True and
    a bias (models/layers/partialconv2d.py)."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1, spectral: bool = False):
        super().__init__(in_channels, features, kernel_size, stride, padding,
                         use_bias=True, spectral=spectral)
        self.kernel_size = kernel_size

    def forward(self, x: Tensor, mask: Tensor, train: bool = False
                ) -> Tuple[Tensor, Tensor]:
        in_c = x.shape[1]
        k = self.kernel_size
        mask = mask.detach()
        m = mask.to(x.dtype)
        if m.shape[1] > 1:
            m = m.sum(1, keepdim=True)
        # windowed sum of the mask: an average pool without the division
        msum = F.avg_pool2d(m, k, self.stride, self.padding,
                            count_include_pad=True, divisor_override=1)
        if mask.shape[1] == 1:
            msum = msum * in_c
        ratio = (in_c * k * k) / (msum + 1e-8)
        update_mask = msum.clamp(0.0, 1.0)
        ratio = ratio * update_mask
        b = self.bias[:, None, None]
        raw = F.conv2d(x * mask.to(x.dtype), effective_weight(self, train),
                       self.bias, self.stride, self.padding)
        out = (raw - b) * ratio + b
        return out * update_mask, update_mask


def avg_pool_3x3s2(x: Tensor) -> Tensor:
    """AvgPool2d(kernel=3, stride=2, padding=1), count_include_pad=True."""
    return F.avg_pool2d(x, 3, 2, 1, count_include_pad=True)


def max_pool_3x3s2(x: Tensor) -> Tensor:
    """MaxPool2d(kernel=3, stride=2, padding=1)."""
    return F.max_pool2d(x, 3, 2, 1)


def upsample_nearest_2x(x: Tensor) -> Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


def upsample_bilinear_2x(x: Tensor) -> Tensor:
    """Upsample(scale_factor=2, mode='bilinear', align_corners=False)."""
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=False)


@functools.lru_cache(maxsize=None)
def _bilinear_taps(out_size: int, in_size: int, device: torch.device
                   ) -> Tuple[Tensor, Tensor, Tensor]:
    """(low index, high index, weight of the high tap) of each output row
    or column: the source coordinate ``(i + 0.5) · in/out − 0.5`` in f32,
    floored and clamped to the input, its fraction clipped to [0, 1] (the
    edge clamp where the coordinate is below 0). Made on ``device`` from
    ``arange`` and host scalars (a scalar copied to the card would stall the
    host on every call) and kept per (out, in, device): SPADE resizes its
    segmap to the same few sizes in every layer of every step."""
    i = torch.arange(out_size, dtype=torch.float32, device=device)
    # in/out rounded to f32 first, as JAX's weakly typed scalar is
    scale = torch.tensor(in_size / out_size, dtype=torch.float32).item()
    src = (i + 0.5) * scale - 0.5
    lo = torch.floor(src).clamp(0, in_size - 1)
    frac = (src - lo).clamp(0.0, 1.0)
    lo_i = lo.to(torch.int64)
    return lo_i, (lo_i + 1).clamp(max=in_size - 1), frac


def resize_bilinear(x: Tensor, h: int, w: int) -> Tensor:
    """torch F.interpolate(mode='bilinear', align_corners=False,
    antialias=False) to (h, w): two taps at half-pixel-centred source
    coordinates, no antialiasing on a downscale. Written out as the JAX
    ``resize_bilinear`` writes it, with its f32 steps (rows first, then
    columns, each ``a · (1 − f) + b · f``), so that the two packages give
    the same bits; ``F.interpolate`` rounds the source coordinate in
    another step."""
    if tuple(x.shape[-2:]) == (h, w):
        return x
    ylo, yhi, fy = _bilinear_taps(h, x.shape[-2], x.device)
    xlo, xhi, fx = _bilinear_taps(w, x.shape[-1], x.device)
    fy = fy[:, None]
    top = x[..., ylo, :] * (1.0 - fy) + x[..., yhi, :] * fy
    return top[..., xlo] * (1.0 - fx) + top[..., xhi] * fx


def resize_nearest(x: Tensor, h: int, w: int) -> Tensor:
    """torch F.interpolate(mode='nearest') to (h, w): the legacy grid, source
    floor(i · in/out), not 'nearest-exact'."""
    return F.interpolate(x, size=(h, w), mode="nearest")
