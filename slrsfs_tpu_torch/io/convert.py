"""JAX variables → the port's ``state_dict``.

``from_jax_variables`` is the inverse of ``slrsfs_tpu/io/torch_import.py``
(:55-128) for the baseline and SLR models, the motion regressor (the
inverse of ``io/checkpoint.py:import_motion_model``), the multiscale
discriminator, VGG19Features and the plain ``ResNetDecoder``: it takes the JAX ``{'params', 'batch_stats', 'spectral'}``
tree as numpy arrays and returns a ``state_dict`` under the reference's
(torchvision's, for VGG) key names. Conv kernels go from HWIO to OIHW,
dense kernels from (in, out) to (out, in), and a conv's spectral ``v`` from
the (kh, kw, I) flattening back to torch's (I, kh, kw).

The eval networks' converters (``vgg16_from_jax``, ``alexnet_from_jax``,
``lpips_alex_from_jax``, ``i3d_from_jax``) invert the JAX importers of
``slrsfs_tpu/eval/feature_nets.py`` (:83, :93, :101) and
``slrsfs_tpu/eval/i3d.py:import_i3d`` (:140): torchvision's, lpips' and
pytorch-i3d's keys.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

from slrsfs_tpu_torch.config import Options

# torch module path segments → JAX module names
_RENAMES = (
    (re.compile(r"\bgblocks\.(\d+)\b"), r"gblock_\1"),
    (re.compile(r"\beblocks\.(\d+)\b"), r"eblock_\1"),
    (re.compile(r"\bch_a\.0\b"), "bn_noise1"),
    (re.compile(r"\bch_a\.2\b"), "conv_aa"),
    (re.compile(r"\bch_a\.3\b"), "bn_noise2"),
    (re.compile(r"\bch_a\.5\b"), "conv_ab"),
    (re.compile(r"\bch_b\.0\b"), "conv_b"),
    # discriminator: model{n}.0 (plain conv) or model{n}.0.0 (the spectral
    # conv inside the norm wrapper) is the JAX model{n}_conv
    (re.compile(r"\bmodel(\d+)\.0(\.0)?$"), r"model\1_conv"),
    # VGG19: torchvision features.{i} is the JAX conv_{i}
    (re.compile(r"^features\.(\d+)$"), r"conv_\1"),
    # SPADE: the reference's nn.Sequential(conv, ReLU) is the JAX conv
    (re.compile(r"\bmlp_shared\.0\b"), "mlp_shared"),
)


def _get(tree: Mapping, path) -> np.ndarray:
    node = tree
    for p in path:
        node = node[p]
    return np.asarray(node, dtype=np.float32)


def _jax_leaf(variables: Mapping, key: str, partial: set) -> np.ndarray:
    """The JAX array behind one torch ``state_dict`` key."""
    module, leaf = key.rsplit(".", 1)
    for pat, rep in _RENAMES:
        module = pat.sub(rep, module)
    parts = module.split(".")
    # a partial noise-BN wraps its NoiseBN in 'nbn'; its stats child is
    # 'pbn' in torch and 'bn' in JAX
    for i in range(len(parts), 0, -1):
        if ".".join(parts[:i]) in partial:
            parts = parts[:i] + ["nbn"] + parts[i:]
            break
    parts = ["bn" if p == "pbn" else p for p in parts]
    if leaf in ("weight_orig", "weight"):
        w = _get(variables["params"], parts + ["kernel"])
        return w.transpose(3, 2, 0, 1) if w.ndim == 4 else w.T
    if leaf == "weight_u":
        return _get(variables["spectral"], parts + ["sn", "u"])
    if leaf == "weight_v":
        v = _get(variables["spectral"], parts + ["sn", "v"])
        kernel = _get(variables["params"], parts + ["kernel"])
        if kernel.ndim == 4:
            kh, kw, i, _ = kernel.shape
            v = v.reshape(kh, kw, i).transpose(2, 0, 1).reshape(-1)
        return v
    if leaf == "bias":
        return _get(variables["params"], parts + ["bias"])
    if leaf in ("stored_mean", "stored_var"):
        return _get(variables["batch_stats"], parts + [leaf])
    raise KeyError(f"no JAX counterpart for {key}")


def from_jax_variables(variables_np: Mapping, opt: Options,
                       model: torch.nn.Module = None) -> Dict[str, torch.Tensor]:
    """JAX variables (numpy leaves) → the state_dict of ``model``: by
    default the ``BaselineModel``, ``SLRModel`` or ``MotionRegressor`` that
    ``opt.model_type`` names; pass a ``MultiscaleDiscriminator``,
    ``VGG19Features`` or ``nn.resnets.ResNetDecoder`` (any device, ``meta``
    included) for those."""
    from slrsfs_tpu_torch.models import get_model

    if model is None:
        with torch.device("meta"):
            model = get_model(opt)
    partial = set()
    for name, mod in model.named_modules():
        if getattr(mod, "partial", False):
            module = name
            for pat, rep in _RENAMES:
                module = pat.sub(rep, module)
            partial.add(module)
    sd = {}
    for key, ref in model.state_dict().items():
        arr = _jax_leaf(variables_np, key, partial)
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{key}: JAX shape {arr.shape} != {tuple(ref.shape)}")
        sd[key] = torch.tensor(arr)
    return sd


def vgg16_from_jax(variables_np: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``VGG16Features`` variables (``conv_{i}`` HWIO) → torchvision's
    ``features.{i}.weight`` (OIHW) and ``.bias``."""
    from slrsfs_tpu_torch.eval.feature_nets import VGG16Features

    with torch.device("meta"):
        model = VGG16Features()
    return from_jax_variables(variables_np, Options(), model)


def alexnet_from_jax(variables_np: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``AlexNetFeatures`` variables (``conv_{i}_kernel`` HWIO,
    ``conv_{i}_bias``) → torchvision's ``features.{i}.weight``, ``.bias``."""
    from slrsfs_tpu_torch.eval.feature_nets import _ALEX_CONVS

    params = variables_np["params"]
    sd = {}
    for li, *_ in _ALEX_CONVS:
        sd[f"features.{li}.weight"] = torch.tensor(
            _get(params, [f"conv_{li}_kernel"]).transpose(3, 2, 0, 1))
        sd[f"features.{li}.bias"] = torch.tensor(_get(params, [f"conv_{li}_bias"]))
    return sd


def lpips_alex_from_jax(weights) -> Dict[str, torch.Tensor]:
    """The JAX LPIPS list of five (C,) weights → ``lins.{i}.model.1.weight``,
    (1, C, 1, 1)."""
    return {f"lins.{i}.model.1.weight":
            torch.tensor(np.asarray(w, np.float32).reshape(1, -1, 1, 1))
            for i, w in enumerate(weights)}


_I3D_LEAVES = {"weight": ("params", "scale"), "bias": ("params", "bias"),
               "running_mean": ("batch_stats", "mean"),
               "running_var": ("batch_stats", "var")}


def i3d_from_jax(variables_np: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``InceptionI3D`` variables ``{'params', 'batch_stats'}`` →
    pytorch-i3d's keys: conv kernels (kT, kH, kW, in, out) → (out, in, kT,
    kH, kW), BN scale/bias/mean/var → weight/bias/running_*, and
    ``num_batches_tracked`` 0."""
    from slrsfs_tpu_torch.eval.i3d import InceptionI3D

    with torch.device("meta"):
        model = InceptionI3D()
    sd = {}
    for key in model.state_dict():
        module, leaf = key.rsplit(".", 1)
        parts = module.split(".")
        if leaf == "num_batches_tracked":
            sd[key] = torch.tensor(0)
        elif parts[-1] == "conv3d":
            if leaf == "weight":
                arr = _get(variables_np["params"], parts + ["kernel"]).transpose(4, 3, 0, 1, 2)
            else:
                arr = _get(variables_np["params"], parts + ["bias"])
            sd[key] = torch.tensor(arr)
        else:
            tree, name = _I3D_LEAVES[leaf]
            sd[key] = torch.tensor(_get(variables_np[tree], parts + [name]))
    return sd
