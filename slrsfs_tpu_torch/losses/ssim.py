"""Gaussian-window SSIM (PyTorch port of ``slrsfs_tpu/losses/ssim.py``;
reference ``models/losses/ssim.py:31-124``).

Window size 11, sigma 1.5, per-channel depthwise convolution with 'same'
padding, C1 = 0.01², C2 = 0.03² (applied to [-1, 1] images, as the
reference does). Images are NHWC.

The window's convolutions run in full float32 on the card (TF32 off, as
the JAX package pins them to ``HIGHEST``): sigma = E[x²] − mu² cancels
values near 0.25 down to ~1e-3, below the error of a 10-bit mantissa.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from slrsfs_tpu_torch.engine.init_utils import no_tf32

Tensor = torch.Tensor


def _gaussian_window(window_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    g = np.exp(-((np.arange(window_size) - window_size // 2) ** 2)
               / (2 * sigma ** 2))
    g = g / g.sum()
    return np.outer(g, g).astype(np.float32)


def _depthwise_filter(x: Tensor, w2d: np.ndarray) -> Tensor:
    """Per-channel 'same' convolution with the window; x NCHW."""
    C = x.shape[1]
    k = torch.from_numpy(w2d).to(x.device, x.dtype)[None, None].expand(C, 1, -1, -1)
    return F.conv2d(x, k, padding=w2d.shape[0] // 2, groups=C)


def ssim(img1: Tensor, img2: Tensor, mask: Tensor = None,
         window_size: int = 11) -> Tensor:
    """Mean SSIM of two NHWC image batches; with a (B, H, W, 1) ``mask``,
    each image's channel-mean SSIM map summed under the mask over the mask's
    sum (at least 1), (B,), as JAX reduces it."""
    w2d = _gaussian_window(window_size)
    a = img1.permute(0, 3, 1, 2)
    b = img2.permute(0, 3, 1, 2)
    with no_tf32():
        mu1 = _depthwise_filter(a, w2d)
        mu2 = _depthwise_filter(b, w2d)
        mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
        sigma1_sq = _depthwise_filter(a * a, w2d) - mu1_sq
        sigma2_sq = _depthwise_filter(b * b, w2d) - mu2_sq
        sigma12 = _depthwise_filter(a * b, w2d) - mu1_mu2
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))
    if mask is not None:
        n = mask.shape[0]
        m = ssim_map.mean(1)[..., None] * mask
        return m.reshape(n, -1).sum(1) / mask.reshape(n, -1).sum(1).clamp(min=1.0)
    return ssim_map.mean()
