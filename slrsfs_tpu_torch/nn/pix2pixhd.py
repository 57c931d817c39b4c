"""pix2pixHD networks: the global generator, the local enhancer and the
'origin' multiscale discriminator (PyTorch port of
``slrsfs_tpu/nn/pix2pixhd.py``; reference ``models/networks/networks.py``).

* ``GlobalGenerator`` (:186-215): reflect-pad 7x7 stem, strided downs, 9
  residual blocks, transposed-conv ups, a 7x7 tanh head; instance norm
  without affine parameters.
* ``LocalEnhancer`` (:132-184, one local enhancer): the global trunk
  without its three head layers on the input pooled once, plus the local
  branch at full resolution.
* ``OriginMultiscaleDiscriminator`` (:295-335 with ``NLayerDiscriminator``
  :337-383, getIntermFeat False, instance norm): one output per scale, so
  the generator's feature-matching term is 0. ``discriminator_losses
  'pix2pixHDorigin'`` selects it (reference gan_loss.py:127-144).

The modules are the reference's ``nn.Sequential`` stacks, so their
state_dict keys are the reference ``define_G``/``define_D`` keys
(``model.{i}...``, ``model1_1.{i}``, ``model1_2.{i}``, ``layer{d}.{i}``)
and the JAX importers (``import_global_generator``,
``import_local_enhancer``, ``import_origin_discriminator``) read them.
Images go in and out NHWC, as in the JAX package; the discriminator's
per-scale outputs come back NCHW, as the port's other discriminator's do.
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

Tensor = torch.Tensor


def _norm(c: int) -> nn.Module:
    return nn.InstanceNorm2d(c, affine=False)


class ResnetBlock(nn.Module):
    """networks.py:217-257 with reflect padding and no dropout."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv_block = nn.Sequential(
            nn.ReflectionPad2d(1), nn.Conv2d(dim, dim, 3), _norm(dim), nn.ReLU(True),
            nn.ReflectionPad2d(1), nn.Conv2d(dim, dim, 3), _norm(dim))

    def forward(self, x: Tensor) -> Tensor:
        return x + self.conv_block(x)


def _global_layers(in_channels: int, out_channels: int, ngf: int,
                   n_downsampling: int, n_blocks: int) -> List[nn.Module]:
    layers = [nn.ReflectionPad2d(3), nn.Conv2d(in_channels, ngf, 7), _norm(ngf),
              nn.ReLU(True)]
    for i in range(n_downsampling):
        mult = 2 ** i
        layers += [nn.Conv2d(ngf * mult, ngf * mult * 2, 3, stride=2, padding=1),
                   _norm(ngf * mult * 2), nn.ReLU(True)]
    mult = 2 ** n_downsampling
    layers += [ResnetBlock(ngf * mult) for _ in range(n_blocks)]
    for i in range(n_downsampling):
        mult = 2 ** (n_downsampling - i)
        layers += [nn.ConvTranspose2d(ngf * mult, ngf * mult // 2, 3, stride=2, padding=1,
                                      output_padding=1),
                   _norm(ngf * mult // 2), nn.ReLU(True)]
    return layers + [nn.ReflectionPad2d(3), nn.Conv2d(ngf, out_channels, 7), nn.Tanh()]


def downsample(x: Tensor) -> Tensor:
    """AvgPool2d(3, stride 2, padding 1, count_include_pad=False), NCHW."""
    return nn.functional.avg_pool2d(x, 3, 2, 1, count_include_pad=False)


class GlobalGenerator(nn.Module):
    """networks.py:186-215. x (B, H, W, in_channels) → (B, H, W,
    out_channels) in [-1, 1]."""

    def __init__(self, in_channels: int = 3, out_channels: int = 3, ngf: int = 64,
                 n_downsampling: int = 3, n_blocks: int = 9):
        super().__init__()
        self.model = nn.Sequential(*_global_layers(in_channels, out_channels, ngf,
                                                   n_downsampling, n_blocks))

    def forward(self, x: Tensor) -> Tensor:
        return self.model(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class LocalEnhancer(nn.Module):
    """networks.py:132-184 with one local enhancer: the headless global trunk
    (``model``, at 2·ngf) on the input pooled once, added to the local
    branch's downsample (``model1_1``) before its blocks, up and head
    (``model1_2``). NHWC in and out."""

    def __init__(self, in_channels: int = 3, out_channels: int = 3, ngf: int = 32,
                 n_downsample_global: int = 3, n_blocks_global: int = 9,
                 n_blocks_local: int = 3):
        super().__init__()
        trunk = _global_layers(in_channels, out_channels, ngf * 2, n_downsample_global,
                               n_blocks_global)
        self.model = nn.Sequential(*trunk[:-3])
        self.model1_1 = nn.Sequential(
            nn.ReflectionPad2d(3), nn.Conv2d(in_channels, ngf, 7), _norm(ngf), nn.ReLU(True),
            nn.Conv2d(ngf, ngf * 2, 3, stride=2, padding=1), _norm(ngf * 2), nn.ReLU(True))
        self.model1_2 = nn.Sequential(
            *[ResnetBlock(ngf * 2) for _ in range(n_blocks_local)],
            nn.ConvTranspose2d(ngf * 2, ngf, 3, stride=2, padding=1, output_padding=1),
            _norm(ngf), nn.ReLU(True),
            nn.ReflectionPad2d(3), nn.Conv2d(ngf, out_channels, 7), nn.Tanh())

    def forward(self, x: Tensor) -> Tensor:
        h = x.permute(0, 3, 1, 2)
        prev = self.model(downsample(h))
        return self.model1_2(self.model1_1(h) + prev).permute(0, 2, 3, 1)


def _nlayer(in_channels: int, ndf: int, n_layers: int) -> nn.Sequential:
    """NLayerDiscriminator's ``model`` (networks.py:337-383): 4x4 convs,
    padding 2, instance norm after every conv but the first and the last."""
    layers = [nn.Conv2d(in_channels, ndf, 4, stride=2, padding=2), nn.LeakyReLU(0.2, True)]
    nf = ndf
    for _ in range(1, n_layers):
        nf_prev, nf = nf, min(nf * 2, 512)
        layers += [nn.Conv2d(nf_prev, nf, 4, stride=2, padding=2), _norm(nf),
                   nn.LeakyReLU(0.2, True)]
    nf_prev, nf = nf, min(nf * 2, 512)
    layers += [nn.Conv2d(nf_prev, nf, 4, stride=1, padding=2), _norm(nf),
               nn.LeakyReLU(0.2, True), nn.Conv2d(nf, 1, 4, stride=1, padding=2)]
    return nn.Sequential(*layers)


class OriginMultiscaleDiscriminator(nn.Module):
    """networks.py:295-335, getIntermFeat False. ``layer{d}`` are the
    scales; the finest, on the full-resolution input, is ``layer{num_D-1}``
    (the reference applies layer num_D-1-i at pooling level i). x (B, H, W,
    C) → [[out]] per scale, each (B, 1, h, w): one output per scale, no
    intermediate features. ``train`` is accepted for the port's
    discriminator protocol; instance norm behaves the same either way."""

    def __init__(self, in_channels: int = 3, ndf: int = 64, n_layers: int = 3,
                 num_D: int = 2):
        super().__init__()
        self.num_D = num_D
        for i in range(num_D):
            setattr(self, f"layer{i}", _nlayer(in_channels, ndf, n_layers))

    def forward(self, x: Tensor, train: bool = True) -> List[List[Tensor]]:
        h = x.permute(0, 3, 1, 2)
        out = []
        for i in range(self.num_D):
            out.append([getattr(self, f"layer{self.num_D - 1 - i}")(h)])
            if i != self.num_D - 1:
                h = downsample(h)
        return out
