"""Feature networks of the perceptual metrics (PyTorch port of
``slrsfs_tpu/eval/feature_nets.py``; reference
``models/networks/pretrained_networks.py``).

VGG16 sliced after relu{1_2, 2_2, 3_3, 4_3, 5_3} (PNet 'vgg') and AlexNet's
five conv-ReLU stages (LPIPS 'alex'), each an ``nn.Sequential`` in
torchvision's ``features`` layout, so that a torchvision ``.pth``
(``features.{i}.weight``) loads with ``load_state_dict(strict=True)``.
Nothing is fetched: weights are the user's own files.
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

Tensor = torch.Tensor

# (torchvision features index, out_channels); 2x2 max pools before 5, 10,
# 17 and 24; the taps are the ReLUs after 2, 7, 14, 21 and 28
_VGG16_CONVS = [
    (0, 64), (2, 64),
    (5, 128), (7, 128),
    (10, 256), (12, 256), (14, 256),
    (17, 512), (19, 512), (21, 512),
    (24, 512), (26, 512), (28, 512),
]
_VGG16_POOL_BEFORE = {5, 10, 17, 24}
_VGG16_TAPS = (3, 8, 15, 22, 29)

# AlexNet features: (index, out_ch, kernel, stride, padding); 3x3/2 VALID
# max pools before 3 and 6; a tap after every ReLU
_ALEX_CONVS = [
    (0, 64, 11, 4, 2),
    (3, 192, 5, 1, 2),
    (6, 384, 3, 1, 1),
    (8, 256, 3, 1, 1),
    (10, 256, 3, 1, 1),
]
_ALEX_POOL_BEFORE = {3, 6}


class _TappedFeatures(nn.Module):
    """``features`` (an ``nn.Sequential``) run on an NHWC batch; returns the
    NCHW outputs of the layers ``taps`` names."""

    def __init__(self, layers: List[nn.Module], taps):
        super().__init__()
        self.features = nn.Sequential(*layers)
        self.taps = tuple(taps)

    def forward(self, x: Tensor) -> List[Tensor]:
        x = x.permute(0, 3, 1, 2)
        outs = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in self.taps:
                outs.append(x)
                if len(outs) == len(self.taps):
                    break
        return outs


def _vgg16_layers() -> List[nn.Module]:
    layers: List[nn.Module] = []
    cin = 3
    for li, ch in _VGG16_CONVS:
        if li in _VGG16_POOL_BEFORE:
            layers.append(nn.MaxPool2d(2, 2))
        layers += [nn.Conv2d(cin, ch, 3, padding=1), nn.ReLU()]
        cin = ch
    return layers


def _alexnet_layers() -> List[nn.Module]:
    layers: List[nn.Module] = []
    cin = 3
    for li, ch, k, s, p in _ALEX_CONVS:
        if li in _ALEX_POOL_BEFORE:
            layers.append(nn.MaxPool2d(3, 2))
        layers += [nn.Conv2d(cin, ch, k, s, p), nn.ReLU()]
        cin = ch
    return layers


class VGG16Features(_TappedFeatures):
    """VGG16's features 0-29 (torchvision keys); input (B, H, W, 3) NHWC,
    output the five slices' ReLU maps, NCHW."""

    def __init__(self):
        super().__init__(_vgg16_layers(), _VGG16_TAPS)


class AlexNetFeatures(_TappedFeatures):
    """AlexNet's features 0-11 (torchvision keys); input (B, H, W, 3) NHWC,
    output the five ReLU maps, NCHW."""

    def __init__(self):
        super().__init__(_alexnet_layers(), (1, 4, 7, 9, 11))


def load_lpips_alex(sd) -> List[Tensor]:
    """LPIPS v0.1 'alex' linear weights (``lins.{i}.model.1.weight`` or
    ``lin{i}.model.1.weight``, (1, C, 1, 1)) → five (C,) float32 tensors."""
    out = []
    for i in range(5):
        for key in (f"lins.{i}.model.1.weight", f"lin{i}.model.1.weight"):
            if key in sd:
                out.append(torch.as_tensor(sd[key], dtype=torch.float32).reshape(-1))
                break
        else:
            raise KeyError(f"LPIPS linear weight {i} not found")
    return out
