"""I3D features and the Fréchet Video Distance (PyTorch port of
``slrsfs_tpu/eval/i3d.py``).

FVD (Unterthiner et al., 2018): the 400-d logits of an Inflated-3D
Inception network pretrained on Kinetics-400, videos resized to 224² and
scaled to [-1, 1], and the Fréchet distance between Gaussian fits of the
real and generated feature sets. The network has the module names of the
community port piergiaj/pytorch-i3d ``InceptionI3d``, so its released
state_dicts load with ``load_state_dict(strict=True)``; the weights are
the user's own file. Padding is TensorFlow's SAME, as the JAX package's
flax convolutions and pools have it: asymmetric (lo = total // 2), and
the pools pad with −inf.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from slrsfs_tpu_torch.engine.init_utils import no_tf32, resolve_device

Tensor = torch.Tensor

_MIXED = {
    "Mixed_3b": (64, 96, 128, 16, 32, 32),
    "Mixed_3c": (128, 128, 192, 32, 96, 64),
    "Mixed_4b": (192, 96, 208, 16, 48, 64),
    "Mixed_4c": (160, 112, 224, 24, 64, 64),
    "Mixed_4d": (128, 128, 256, 24, 64, 64),
    "Mixed_4e": (112, 144, 288, 32, 64, 64),
    "Mixed_4f": (256, 160, 320, 32, 128, 128),
    "Mixed_5b": (256, 160, 320, 32, 128, 128),
    "Mixed_5c": (384, 192, 384, 48, 128, 128),
}


def same_pad(x: Tensor, kernel: Sequence[int], stride: Sequence[int],
             value: float = 0.0) -> Tensor:
    """TF-SAME padding of the trailing ``len(kernel)`` dims of ``x``: each
    side's output is ceil(n / stride), the total pad is split with
    total // 2 before and the rest after (flax's ``padding="SAME"``)."""
    pads: List[int] = []
    for n, k, s in reversed(list(zip(x.shape[-len(kernel):], kernel, stride))):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]  # F.pad: last dim first
    return F.pad(x, pads, value=value)


def max_pool_same(x: Tensor, kernel: Sequence[int], stride: Sequence[int]) -> Tensor:
    """flax ``nn.max_pool(padding="SAME")``: the pad is −inf."""
    return F.max_pool3d(same_pad(x, kernel, stride, float("-inf")), kernel, stride)


class Unit3D(nn.Module):
    """Conv3d (no bias unless asked) with SAME padding, then BatchNorm with
    eps 1e-3 and frozen statistics, then ReLU."""

    def __init__(self, cin: int, cout: int, kernel: Tuple[int, int, int] = (1, 1, 1),
                 stride: Tuple[int, int, int] = (1, 1, 1), use_bn: bool = True,
                 relu: bool = True, use_bias: bool = False):
        super().__init__()
        self.kernel, self.stride, self.relu = kernel, stride, relu
        self.conv3d = nn.Conv3d(cin, cout, kernel, stride, padding=0, bias=use_bias)
        self.bn = nn.BatchNorm3d(cout, eps=1e-3, momentum=0.01) if use_bn else None

    def forward(self, x: Tensor) -> Tensor:
        x = self.conv3d(same_pad(x, self.kernel, self.stride))
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.relu else x


class InceptionModule(nn.Module):
    """Four-branch Inception block; ``out`` = the six branch widths."""

    def __init__(self, cin: int, out: Tuple[int, ...]):
        super().__init__()
        self.b0 = Unit3D(cin, out[0])
        self.b1a = Unit3D(cin, out[1])
        self.b1b = Unit3D(out[1], out[2], (3, 3, 3))
        self.b2a = Unit3D(cin, out[3])
        self.b2b = Unit3D(out[3], out[4], (3, 3, 3))
        self.b3b = Unit3D(cin, out[5])
        self.cout = out[0] + out[2] + out[4] + out[5]

    def forward(self, x: Tensor) -> Tensor:
        return torch.cat([
            self.b0(x), self.b1b(self.b1a(x)), self.b2b(self.b2a(x)),
            self.b3b(max_pool_same(x, (3, 3, 3), (1, 1, 1)))], dim=1)


class InceptionI3D(nn.Module):
    """I3D → per-video 400-d features: input (B, T, H, W, 3) in [-1, 1],
    T >= 9 and H = W = 224 for the protocol; output (B, num_classes), the
    logits averaged over T, H and W."""

    def __init__(self, num_classes: int = 400):
        super().__init__()
        self.Conv3d_1a_7x7 = Unit3D(3, 64, (7, 7, 7), (2, 2, 2))
        self.Conv3d_2b_1x1 = Unit3D(64, 64)
        self.Conv3d_2c_3x3 = Unit3D(64, 192, (3, 3, 3))
        cin = 192
        for name, out in _MIXED.items():
            block = InceptionModule(cin, out)
            self.add_module(name, block)
            cin = block.cout
        # VALID (2, 7, 7) average pool, then a 1x1x1 conv with bias and
        # neither BN nor ReLU
        self.logits = Unit3D(cin, num_classes, use_bn=False, relu=False,
                             use_bias=True)

    def forward(self, x: Tensor) -> Tensor:
        x = x.permute(0, 4, 1, 2, 3)
        x = self.Conv3d_1a_7x7(x)
        x = max_pool_same(x, (1, 3, 3), (1, 2, 2))
        x = self.Conv3d_2c_3x3(self.Conv3d_2b_1x1(x))
        x = max_pool_same(x, (1, 3, 3), (1, 2, 2))
        x = self.Mixed_3c(self.Mixed_3b(x))
        x = max_pool_same(x, (3, 3, 3), (2, 2, 2))
        for k in ("Mixed_4b", "Mixed_4c", "Mixed_4d", "Mixed_4e", "Mixed_4f"):
            x = getattr(self, k)(x)
        x = max_pool_same(x, (2, 2, 2), (2, 2, 2))
        x = self.Mixed_5c(self.Mixed_5b(x))
        x = F.avg_pool3d(x, (2, 7, 7), stride=1)
        return self.logits(x).mean(dim=(2, 3, 4))


def frechet_distance(feats_a: np.ndarray, feats_b: np.ndarray) -> float:
    """Fréchet distance between Gaussian fits of two feature sets (N, D), in
    float64 on the host: ``tr sqrt(S_a S_b)`` by scipy's ``sqrtm``; a
    rank-deficient pair (N << D, the usual CLAW set) retries with eps·I
    added to both covariances, and last with the clipped eigenvalues."""
    feats_a = np.asarray(feats_a, np.float64)
    feats_b = np.asarray(feats_b, np.float64)
    mu_a, mu_b = feats_a.mean(0), feats_b.mean(0)
    s_a = np.cov(feats_a, rowvar=False)
    s_b = np.cov(feats_b, rowvar=False)
    diff = mu_a - mu_b

    def _tr_sqrt(sa, sb):
        prod = sa @ sb
        try:
            from scipy import linalg

            covmean = linalg.sqrtm(prod)
            if not np.isfinite(covmean).all():
                return float("nan")  # the caller retries regularised
            if np.iscomplexobj(covmean):
                # a singular product gives complex noise without raising;
                # more than float error means sqrtm failed
                if np.abs(covmean.imag).max() > 1e-3:
                    return float("nan")
                covmean = covmean.real
            return float(np.trace(covmean))
        except Exception:
            eig = np.linalg.eigvals(prod)
            return float(np.sqrt(np.clip(eig.real, 0.0, None)).sum())

    tr = _tr_sqrt(s_a, s_b)
    if not np.isfinite(tr):
        eps = 1e-6
        eye = np.eye(s_a.shape[0])
        tr = _tr_sqrt(s_a + eps * eye, s_b + eps * eye)
        if not np.isfinite(tr):
            eig = np.linalg.eigvals((s_a + eps * eye) @ (s_b + eps * eye))
            tr = float(np.sqrt(np.clip(eig.real, 0.0, None)).sum())
    return float(diff @ diff + np.trace(s_a) + np.trace(s_b) - 2.0 * tr)


def preprocess_video(frames01: np.ndarray, size: int = 224) -> np.ndarray:
    """(T, H, W, 3) float in [0, 1] → (T, size, size, 3) in [-1, 1], each
    frame quantised to u8 and resized by PIL's bilinear filter."""
    from PIL import Image

    out = np.empty((frames01.shape[0], size, size, 3), np.float32)
    for t, f in enumerate(frames01):
        img = Image.fromarray((np.clip(f, 0, 1) * 255).astype(np.uint8))
        out[t] = np.asarray(img.resize((size, size), Image.BILINEAR),
                            np.float32) / 255.0
    return out * 2.0 - 1.0


class FVD:
    """Weight-gated FVD scorer on ``device`` (default the card; a missing
    card raises). ``i3d_pth``: a pytorch-i3d ``.pt`` holding a state_dict
    or the module itself; without it :meth:`available` is False and callers
    skip the metric."""

    def __init__(self, i3d_pth: str = None, device="cuda"):
        self.device = resolve_device(device)
        self.model = None
        if i3d_pth:
            sd = torch.load(i3d_pth, map_location="cpu", weights_only=False)
            if hasattr(sd, "state_dict"):
                sd = sd.state_dict()
            self.model = InceptionI3D()
            self.model.load_state_dict(sd)
            self.model.to(self.device).eval()

    def available(self) -> bool:
        return self.model is not None

    @torch.no_grad()
    def features(self, videos: List[np.ndarray]) -> np.ndarray:
        """Videos, each (T, H, W, 3) float in [0, 1] → (N, 400) float32."""
        feats = []
        with no_tf32():
            for v in videos:
                x = torch.from_numpy(preprocess_video(v))[None].to(self.device)
                feats.append(self.model(x)[0].cpu().numpy())
        return np.stack(feats)

    def score(self, real: List[np.ndarray], gen: List[np.ndarray]) -> float:
        return frechet_distance(self.features(real), self.features(gen))
