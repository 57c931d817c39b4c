"""Normalisation layers, eval mode (PyTorch port of ``slrsfs_tpu/nn/norm.py``).

The port renders only, so BN uses its stored statistics and the BigGAN noise
vector is zero (the reference's ``bn_noise_misc``): gain = 1 and bias = 0.
The noise layers' ``gain``/``bias`` linear maps are still held, so the
``state_dict`` keeps the reference's key names and a reference ``.pth``
loads as it is. Layout is NCHW inside the modules.
"""

from __future__ import annotations

import torch
from torch import nn

Tensor = torch.Tensor

BN_EPS = 1e-5


def fused_bn(x: Tensor, mean: Tensor, var: Tensor, gain=None, bias=None,
             eps: float = BN_EPS) -> Tensor:
    """Reference ``fused_bn``: x*scale - shift with scale = rsqrt(var+eps)*gain
    and shift = mean*scale - bias. Per-channel vectors broadcast over NCHW."""
    scale = torch.rsqrt(var + eps)
    if gain is not None:
        scale = scale * gain
    shift = mean * scale
    if bias is not None:
        shift = shift - bias
    return x * scale[:, None, None] - shift[:, None, None]


def register_weight(module: nn.Module, shape, spectral: bool) -> None:
    """Register a weight as torch's spectral norm stores it (``weight_orig``
    plus the power-iteration buffers ``weight_u`` (out,) and ``weight_v``
    (in·kh·kw,)), or as a plain ``weight``."""
    if spectral:
        module.weight_orig = nn.Parameter(torch.empty(shape))
        module.register_buffer("weight_u", torch.empty(shape[0]))
        rest = 1
        for s in shape[1:]:
            rest *= s
        module.register_buffer("weight_v", torch.empty(rest))
    else:
        module.weight = nn.Parameter(torch.empty(shape))


def effective_weight(module: nn.Module) -> Tensor:
    """The weight a layer applies: ``weight_orig / sigma`` with the eval-mode
    sigma = u·(W v) from the stored vectors (torch ``spectral_norm`` at eval),
    or the plain ``weight``."""
    if hasattr(module, "weight_orig"):
        w = module.weight_orig
        sigma = torch.dot(module.weight_u, torch.mv(w.reshape(w.shape[0], -1),
                                                    module.weight_v))
        return w / sigma
    return module.weight


class Linear(nn.Module):
    """Weights of a bias-free, optionally spectral linear layer (reference
    get_linear_layer). Only the noise maps use it, and with zero noise their
    output is zero, so it holds weights and has no forward."""

    def __init__(self, in_features: int, out_features: int, spectral: bool):
        super().__init__()
        register_weight(self, (out_features, in_features), spectral)


class ManualBN(nn.Module):
    """BN statistics holder (reference ``bn``/``pbn``), applied with the
    stored statistics."""

    def __init__(self, features: int):
        super().__init__()
        self.register_buffer("stored_mean", torch.zeros(features))
        self.register_buffer("stored_var", torch.ones(features))

    def forward(self, x: Tensor) -> Tensor:
        return fused_bn(x, self.stored_mean, self.stored_var)


class NoiseBN(nn.Module):
    """Reference ``LinearNoiseLayer`` / ``PartialLinearNoiseLayer`` with zero
    noise. The partial form's mask only changes training-time moments, so at
    eval both normalise with the stored statistics; they differ only in the
    name of the statistics child (``pbn`` for the partial form)."""

    noise_sz = 20

    def __init__(self, features: int, spectral: bool = True,
                 partial: bool = False):
        super().__init__()
        self.partial = partial
        self.gain = Linear(self.noise_sz, features, spectral)
        self.bias = Linear(self.noise_sz, features, spectral)
        if partial:
            self.pbn = ManualBN(features)
        else:
            self.bn = ManualBN(features)

    def forward(self, x: Tensor) -> Tensor:
        return (self.pbn if self.partial else self.bn)(x)
