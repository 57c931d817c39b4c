"""Initialisation helpers (PyTorch port of ``slrsfs_tpu/engine/init_utils.py``).

Freshly initialised spectral-norm layers have random (u, v) whose sigma is
far from the true spectral norm, and BN statistics of (0, 1). ``settle``
runs a few train-mode passes with zero noise that update only the spectral
vectors and the BN statistics, as the JAX ``settle`` does for random-weight
renders, benchmarks and smoke tests.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. A missing card raises: there is
    no silent CPU path; pass device='cpu' for the plain PyTorch path."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch path on the CPU")
    return dev


@contextlib.contextmanager
def no_tf32():
    """Float32 convolutions and matrix products in full float32 on the card:
    cuDNN runs convolutions in TF32 by default, which keeps about three
    decimal digits."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


@torch.no_grad()
def settle(model: nn.Module, example_args: tuple, n: int = 8) -> nn.Module:
    """``n`` train-mode forward passes of ``model(*example_args, train=True)``
    with zero noise: each runs one power iteration per spectral weight and
    one BN-statistics update per BN layer, in place. Parameters do not
    change."""
    with no_tf32():
        for _ in range(n):
            model(*example_args, train=True, noise=None)
    return model
