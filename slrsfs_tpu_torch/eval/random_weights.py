"""Seeded random weights for the eval networks, in the layouts of the
user's files: torchvision's VGG16 and AlexNet ``features``, LPIPS v0.1's
``lins`` and pytorch-i3d's ``InceptionI3d``. The repository holds no
pretrained weights and fetches none; smoke runs and tests score with these.
Convolutions are He-scaled (activations keep their size through the deep
stacks), biases small, BatchNorm statistics var in [0.5, 1.5] and the
LPIPS weights non-negative, as trained ones are."""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch
from torch import nn


def random_state_dict(model: nn.Module, rng: np.random.Generator) -> Dict[str, torch.Tensor]:
    """A state_dict for ``model`` drawn from ``rng``."""
    sd = {}
    for key, ref in model.state_dict().items():
        shape, leaf = tuple(ref.shape), key.rsplit(".", 1)[-1]
        if leaf == "num_batches_tracked":
            sd[key] = torch.tensor(0)
            continue
        if leaf == "weight" and len(shape) > 1:  # a convolution
            arr = rng.standard_normal(shape) * np.sqrt(2.0 / np.prod(shape[1:]))
        elif leaf in ("weight", "running_var"):  # a BatchNorm scale or variance
            arr = rng.uniform(0.5, 1.5, shape)
        else:  # biases and running means
            arr = rng.normal(0.0, 0.05, shape)
        sd[key] = torch.tensor(arr, dtype=torch.float32)
    return sd


def write_random_weights(out_dir: str, seed: int) -> Dict[str, str]:
    """``vgg16.pth``, ``alexnet.pth``, ``lpips_alex.pth`` and ``i3d.pt``
    under ``out_dir``, drawn from ``seed``; returns their paths by name."""
    from slrsfs_tpu_torch.eval.feature_nets import _ALEX_CONVS, AlexNetFeatures, VGG16Features
    from slrsfs_tpu_torch.eval.i3d import InceptionI3D

    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    with torch.device("meta"):
        nets = {"vgg16": VGG16Features(), "alexnet": AlexNetFeatures(),
                "i3d": InceptionI3D()}
    sds = {name: random_state_dict(net, rng) for name, net in nets.items()}
    sds["lpips_alex"] = {
        f"lins.{i}.model.1.weight": torch.tensor(
            rng.uniform(0.0, 0.2, (1, ch, 1, 1)), dtype=torch.float32)
        for i, (_, ch, *_) in enumerate(_ALEX_CONVS)}
    paths = {}
    for name, sd in sds.items():
        paths[name] = os.path.join(out_dir, name + (".pt" if name == "i3d" else ".pth"))
        torch.save(sd, paths[name])
    return paths
