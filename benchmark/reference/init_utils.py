"""``no_tf32`` and ``settle``, frozen for the benchmark's reference (copied
from ``slrsfs_tpu_torch/engine/init_utils.py``)."""

from __future__ import annotations

import contextlib

import torch
from torch import nn


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


@contextlib.contextmanager
def tf32():
    """Float32 convolutions and matrix products in TF32: the precision
    below float32 that the training control runs in."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev
