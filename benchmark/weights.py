"""Seeded random weights, made on the device by the benchmark in a few large
calls: LeCun-normal kernels (one ``randn`` for all of a model's kernels),
zero biases, BN statistics (0, 1), and spectral vectors set by power
iterations on each kernel, as the port's ``init_random_weights`` sets them.
They are made in the reference's modules, whose state_dict keys are the
port's, and the same state_dict is loaded into both sides.

A render also needs settled BN statistics: random weights with statistics
(0, 1) give frames that saturate. ``settle`` runs the reference's
train-mode passes with zero noise at 64², as the port's random-weight
renderer does, so that the statistics are the benchmark's and not the
program's.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

POWER_ITERS = 30


def _l2n(v: torch.Tensor) -> torch.Tensor:
    return v / (v.norm() + 1e-12)


@torch.no_grad()
def fill(model: nn.Module, gen: torch.Generator) -> None:
    """Seeded weights for every conv and dense layer of ``model`` (on the
    generator's device)."""
    kernels, spectral = [], []
    for mod in model.modules():
        params = mod._parameters
        w = params.get("weight_orig", params.get("weight"))
        if w is None:
            continue
        kernels.append(w)
        if params.get("bias") is not None:
            params["bias"].zero_()
        if "weight_orig" in params:
            spectral.append(mod)
    if not kernels:
        return
    dev = kernels[0].device
    flat = torch.randn(sum(w.numel() for w in kernels), generator=gen, device=dev)
    at = 0
    for w in kernels:
        n = w.numel()
        w.copy_(flat[at:at + n].view_as(w) / w[0].numel() ** 0.5)
        at += n
    if spectral:
        us = torch.randn(sum(m.weight_u.numel() for m in spectral), generator=gen, device=dev)
        at = 0
        for mod in spectral:
            w_mat = mod.weight_orig.reshape(mod.weight_orig.shape[0], -1)
            u = _l2n(us[at:at + w_mat.shape[0]])
            at += w_mat.shape[0]
            for _ in range(POWER_ITERS):
                v = _l2n(w_mat.t() @ u)
                u = _l2n(w_mat @ v)
            mod.weight_u.copy_(u)
            mod.weight_v.copy_(v)


@torch.no_grad()
def settle(model: nn.Module, gen: torch.Generator, n: int = 6) -> None:
    """``n`` train-mode passes with zero noise on a (1, 64, 64, 3) input
    drawn from ``gen``: power iterations and BN statistics move, the
    parameters do not (the port's ``engine/init_utils.py:settle``)."""
    from benchmark.reference.init_utils import no_tf32

    dev = next(model.parameters()).device
    x = torch.randn((1, 64, 64, 3), generator=gen, device=dev) * 0.25
    with no_tf32():
        for _ in range(n):
            model(x, train=True, noise=None)


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A torch generator on ``device`` for one named use of the seed."""
    g = torch.Generator(device=device)
    g.manual_seed((seed * 1_000_003 + stream) % (1 << 63))
    return g


def state_of(model: nn.Module) -> Dict[str, torch.Tensor]:
    """A detached copy of ``model``'s state_dict on the host."""
    return {k: v.detach().to("cpu", copy=True) for k, v in model.state_dict().items()}
