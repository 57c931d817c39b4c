"""Normalisation layers: BigGAN-style noise-conditioned BN and spectral
norm (PyTorch port of ``slrsfs_tpu/nn/norm.py``). Layout is NCHW inside
the modules.

Every layer takes the JAX modules' two switches as arguments:

* ``train``: BN normalises with the batch moments and updates its running
  statistics; spectral weights run one power iteration and store (u, v).
  Otherwise the stored statistics and vectors are used unchanged.
* ``noise``: the ``torch.Generator`` the BigGAN noise vectors are drawn
  from, or ``None`` for zero noise (the JAX ``deterministic``, the
  reference's ``bn_noise_misc``): gain = 1 and bias = 0.

The state updates are in place, in call order, as the reference's torch
buffers update: a module called twice in one step (the two encodes of the
training pass) runs its second call from the state its first call left.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

Tensor = torch.Tensor

BN_EPS = 1e-5
BN_MOMENTUM = 0.1


def _per_channel(v: Tensor) -> Tensor:
    """(C,) or (B, C) → broadcastable against NCHW."""
    return v[..., None, None]


def fused_bn(x: Tensor, mean: Tensor, var: Tensor, gain=None, bias=None,
             eps: float = BN_EPS) -> Tensor:
    """Reference ``fused_bn``: x*scale - shift with scale = rsqrt(var+eps)*gain
    and shift = mean*scale - bias. mean/var are per channel (C,); gain/bias
    per channel or per sample (B, C)."""
    scale = torch.rsqrt(var + eps)
    if gain is not None:
        scale = scale * gain
    shift = mean * scale
    if bias is not None:
        shift = shift - bias
    return x * _per_channel(scale) - _per_channel(shift)


def l2_normalize(v: Tensor, eps: float = 1e-12) -> Tensor:
    return v / (v.norm() + eps)


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


def effective_weight(module: nn.Module, train: bool = False) -> Tensor:
    """The weight a layer applies: ``weight_orig / sigma`` with
    sigma = u·(W v), or the plain ``weight``. In ``train`` one power
    iteration first sets v = W^T u / |.|, then u = W v / |.| (on the
    detached weight) and stores both (``norm.py:136-169``); otherwise the
    stored vectors are used. The gradient reaches W through sigma with
    (u, v) held constant."""
    if not hasattr(module, "weight_orig"):
        return module.weight
    w = module.weight_orig
    w_mat = w.reshape(w.shape[0], -1)
    if train:
        with torch.no_grad():
            v = l2_normalize(torch.mv(w_mat.t(), module.weight_u))
            u = l2_normalize(torch.mv(w_mat, v))
            module.weight_u.copy_(u)
            module.weight_v.copy_(v)
    else:
        u, v = module.weight_u, module.weight_v
        if torch.is_grad_enabled() and w.requires_grad:
            # autograd keeps (u, v); a later train-mode call updates the
            # buffers in place
            u, v = u.clone(), v.clone()
    return w / torch.dot(u, torch.mv(w_mat, v))


class Linear(nn.Module):
    """Bias-free, optionally spectral linear layer (reference
    get_linear_layer): the noise maps of ``NoiseBN``."""

    def __init__(self, in_features: int, out_features: int, spectral: bool):
        super().__init__()
        register_weight(self, (out_features, in_features), spectral)

    def forward(self, x: Tensor, train: bool = False) -> Tensor:
        return x @ effective_weight(self, train).t()


class ManualBN(nn.Module):
    """BN with manual moments and running statistics (reference ``bn`` /
    ``pbn``, normalization.py:157-215).

    In ``train`` the batch moments are E[x] and E[x²] − E[x]² in f32 over
    (B, H, W), or, given per-channel mask ``counts``, the sums divided by
    ``counts + BN_EPS`` (reference ``partial_manual_bn``); the stored
    statistics move towards them with momentum 0.1. Otherwise the stored
    statistics normalise."""

    def __init__(self, features: int):
        super().__init__()
        self.register_buffer("stored_mean", torch.zeros(features))
        self.register_buffer("stored_var", torch.ones(features))

    def forward(self, x: Tensor, gain=None, bias=None, train: bool = False,
                counts: Optional[Tensor] = None) -> Tensor:
        if not train:
            return fused_bn(x, self.stored_mean, self.stored_var, gain, bias)
        xf = x.to(torch.float32)
        if counts is None:
            m = xf.mean(dim=(0, 2, 3))
            m2 = torch.square(xf).mean(dim=(0, 2, 3))
        else:
            m = xf.sum(dim=(0, 2, 3)) / (counts + BN_EPS)
            m2 = torch.square(xf).sum(dim=(0, 2, 3)) / (counts + BN_EPS)
        var = (m2 - torch.square(m)).to(x.dtype)
        m = m.to(x.dtype)
        with torch.no_grad():
            self.stored_mean.copy_(self.stored_mean * (1 - BN_MOMENTUM)
                                   + m * BN_MOMENTUM)
            self.stored_var.copy_(self.stored_var * (1 - BN_MOMENTUM)
                                  + var * BN_MOMENTUM)
        return fused_bn(x, m, var, gain, bias)


class NoiseBN(nn.Module):
    """Reference ``LinearNoiseLayer`` / ``PartialLinearNoiseLayer``
    (normalization.py:19-90): per-sample BN gain = 1 + Wg·n and bias = Wb·n
    for a 20-dim noise vector n. The partial form normalises its batch
    moments by the mask's per-channel pixel count; its statistics child is
    named ``pbn``, as in the reference checkpoint.

    The noise maps run whenever the layer trains (their spectral vectors
    update even with zero noise, as in JAX) or the noise is drawn; at eval
    with zero noise gain = 1 and bias = 0 exactly, so they are skipped."""

    noise_sz = 20

    def __init__(self, features: int, spectral: bool = True,
                 partial: bool = False):
        super().__init__()
        self.features = features
        self.partial = partial
        self.gain = Linear(self.noise_sz, features, spectral)
        self.bias = Linear(self.noise_sz, features, spectral)
        if partial:
            self.pbn = ManualBN(features)
        else:
            self.bn = ManualBN(features)

    def forward(self, x: Tensor, mask: Optional[Tensor] = None,
                train: bool = False,
                noise: Optional[torch.Generator] = None) -> Tensor:
        gain = bias = None
        if train or noise is not None:
            if noise is None:
                n = torch.zeros((x.shape[0], self.noise_sz), dtype=x.dtype,
                                device=x.device)
            else:
                n = torch.randn((x.shape[0], self.noise_sz), generator=noise,
                                dtype=x.dtype, device=x.device)
            gain = 1.0 + self.gain(n, train)
            bias = self.bias(n, train)
        counts = None
        if self.partial and train:
            if mask is None:
                raise ValueError("the partial noise-BN needs the mask to train")
            counts = mask.to(torch.float32).sum(dim=(0, 2, 3))
            if mask.shape[1] == 1:
                counts = counts.expand(self.features)
        bn = self.pbn if self.partial else self.bn
        return bn(x, gain, bias, train, counts)
