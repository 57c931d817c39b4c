"""Encoders and decoders (PyTorch port of ``slrsfs_tpu/nn/resnets.py``):
the baseline's encoder and partial-conv decoder, the SLR model's plain
encoder (alpha head) and background decoder, and the plain decoder of the
reference's other arch tables. NCHW inside; the children are
named as in the reference (``gblocks.{i}``, ``eblocks.{i}``). ``train`` and
``noise`` are the switches of ``nn/norm.py``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from benchmark.reference.config import Options, partial_bn, spectral, woresbias
from benchmark.reference.nn.archs import get_resnet_arch
from benchmark.reference.nn.blocks import ResNetBlock, ResNetBlockPconv2

Tensor = torch.Tensor


def _block_stack(opt: Options, layers, resample) -> nn.ModuleList:
    return nn.ModuleList(
        ResNetBlock(layers[i - 1], layers[i], downsample=resample[i - 1],
                    spectral=spectral(opt))
        for i in range(1, len(layers)))


class ResNetEncoder(nn.Module):
    """Plain encoder (reference architectures.py:121-153); the SLR alpha
    head."""

    def __init__(self, opt: Options, in_channels: int = 3,
                 model_type: Optional[str] = None):
        super().__init__()
        arch = get_resnet_arch(model_type or opt.refine_model_type, opt,
                               in_channels)
        self.gblocks = _block_stack(opt, arch["layers_enc"], arch["downsample"])

    def forward(self, x: Tensor, train: bool = False,
                noise: Optional[torch.Generator] = None) -> Tensor:
        for blk in self.gblocks:
            x = blk(x, train, noise)
        return x


class ResNetDecoder(nn.Module):
    """Plain (non-pconv) decoder over ``model_type``'s arch table, or
    ``opt.refine_model_type``'s (reference architectures.py:209-230)."""

    def __init__(self, opt: Options, model_type: Optional[str] = None):
        super().__init__()
        arch = get_resnet_arch(model_type or opt.refine_model_type, opt)
        self.eblocks = _block_stack(opt, arch["layers_dec"], arch["upsample"])

    def forward(self, x: Tensor, train: bool = False,
                noise: Optional[torch.Generator] = None) -> Tensor:
        for blk in self.eblocks:
            x = blk(x, train, noise)
        return x


class ResNetBGDecoder(ResNetDecoder):
    """Background ('mean video') network: image in, image out, no output
    nonlinearity (reference architectures.py:233-260, utilities.py:98-101):
    the plain decoder over ``opt.bg_refine_model_type``."""

    def __init__(self, opt: Options):
        super().__init__(opt, opt.bg_refine_model_type)


class ResNetEncoderWithZ(nn.Module):
    """Encoder whose last block emits one extra channel, returned as Z
    (reference architectures.py:155-197)."""

    def __init__(self, opt: Options, in_channels: int = 3,
                 model_type: Optional[str] = None):
        super().__init__()
        arch = get_resnet_arch(model_type or opt.refine_model_type, opt,
                               in_channels)
        layers = list(arch["layers_enc"])
        layers[-1] += 1
        self.gblocks = _block_stack(opt, layers, arch["downsample"])

    def forward(self, x: Tensor, train: bool = False,
                noise: Optional[torch.Generator] = None
                ) -> Tuple[Tensor, Tensor]:
        for blk in self.gblocks:
            x = blk(x, train, noise)
        return x[:, :-1], x[:, -1:]


class ResNetDecoderPconv2(nn.Module):
    """Partial-conv decoder; holes are where the splatted input is exactly 0
    (reference architectures.py:345-375). ``in_channels`` is the live input
    width, the encoder's feature width."""

    def __init__(self, opt: Options, in_channels: int,
                 model_type: Optional[str] = None):
        super().__init__()
        arch = get_resnet_arch(model_type or opt.refine_model_type, opt)
        self.mask_all_ones = "mask1" in opt.pconv
        layers = list(arch["layers_dec"])
        layers[0] = in_channels
        acts = arch.get("activation", ["Relu"] * (len(layers) - 1))
        self.eblocks = nn.ModuleList(
            ResNetBlockPconv2(layers[i - 1], layers[i],
                              downsample=arch["upsample"][i - 1],
                              activation=acts[i - 1],
                              spectral=spectral(opt),
                              partial_bn=partial_bn(opt),
                              shortcut_bias=not woresbias(opt))
            for i in range(1, len(layers)))

    def forward(self, x: Tensor, train: bool = False,
                noise: Optional[torch.Generator] = None) -> Tensor:
        mask = torch.ones_like(x) if self.mask_all_ones else (x != 0).to(x.dtype)
        for blk in self.eblocks:
            x, mask = blk(x, mask, train, noise)
        return x
