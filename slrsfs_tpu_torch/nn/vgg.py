"""VGG19 feature extractor of the perceptual loss (PyTorch port of
``slrsfs_tpu/nn/vgg.py``).

torchvision's ``vgg19().features`` through ReLU 5_1, under its own key
names (``features.{i}.weight``/``bias``), returning the five slices the
reference taps after ReLUs 1_1, 2_1, 3_1, 4_1 and 5_1
(models/networks/architectures.py:82-115). Images in [-1, 1] go in as they
are, without ImageNet normalisation, as in the reference. Without
pretrained weights the module runs on seeded random weights; quality parity
needs the real ones (``import_vgg19``).
"""

from __future__ import annotations

from typing import List, Mapping

import torch
import torch.nn.functional as F
from torch import nn

Tensor = torch.Tensor

# torchvision vgg19.features conv layer indices and widths, through 5_1
_CONVS = ((0, 64), (2, 64), (5, 128), (7, 128), (10, 256), (12, 256),
          (14, 256), (16, 256), (19, 512), (21, 512), (23, 512), (25, 512),
          (28, 512))
_SLICE_ENDS = (0, 5, 10, 19, 28)  # convs whose ReLU output is returned
_POOL_BEFORE = (5, 10, 19, 28)  # a 2x2 max pool precedes these convs


class VGG19Features(nn.Module):
    def __init__(self):
        super().__init__()
        self.features = nn.ModuleDict()
        c_in = 3
        for li, ch in _CONVS:
            self.features[str(li)] = nn.Conv2d(c_in, ch, 3, padding=1)
            c_in = ch

    def forward(self, x: Tensor) -> List[Tensor]:
        """x (B, H, W, 3) → the five slices, NCHW."""
        h = x.permute(0, 3, 1, 2)
        outs = []
        for li, _ in _CONVS:
            if li in _POOL_BEFORE:
                h = F.max_pool2d(h, 2, 2)
            h = F.relu(self.features[str(li)](h))
            if li in _SLICE_ENDS:
                outs.append(h)
        return outs


@torch.no_grad()
def init_random_vgg(vgg: VGG19Features, seed: int) -> VGG19Features:
    """Seeded LeCun-normal kernels and zero biases (flax ``nn.Conv``'s
    initialisers), for runs without the ImageNet weights."""
    g = torch.Generator().manual_seed(seed)
    for conv in vgg.features.values():
        w = conv.weight
        w.copy_(torch.randn(w.shape, generator=g) / w[0].numel() ** 0.5)
        conv.bias.zero_()
    return vgg


def import_vgg19(sd: Mapping) -> dict:
    """A torchvision ``vgg19`` state_dict → ``VGG19Features``'s state_dict
    (the ``features.{i}`` keys through conv 28; the classifier is dropped)."""
    out = {}
    for li, _ in _CONVS:
        for leaf in ("weight", "bias"):
            out[f"features.{li}.{leaf}"] = torch.as_tensor(
                sd[f"features.{li}.{leaf}"], dtype=torch.float32)
    return out
