"""Single-layer animating model, inference pieces (PyTorch port of
``slrsfs_tpu/models/baseline.py``): encoder → symmetric double-ended softmax
splat → partial-conv decoder. Public tensors are NHWC, as in the JAX package.
"""

from __future__ import annotations

import torch
from torch import nn

from slrsfs_tpu_torch.config import Options
from slrsfs_tpu_torch.nn.archs import get_resnet_arch
from slrsfs_tpu_torch.nn.resnets import ResNetDecoderPconv2, ResNetEncoderWithZ
from slrsfs_tpu_torch.ops.maxwarp import maximum_warp_norm_splat
from slrsfs_tpu_torch.ops.splat import NORM_EPS, softsplat_sum

Tensor = torch.Tensor


def _nchw(x: Tensor) -> Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: Tensor) -> Tensor:
    return x.permute(0, 2, 3, 1)


def feature_width(opt: Options) -> int:
    """Width of the encoder features the splat carries."""
    return get_resnet_arch(opt.refine_model_type, opt, 3)["layers_enc"][-1]


class BaselineModel(nn.Module):
    """``encoder`` and ``projector`` (the decoder), named as in the reference
    checkpoint."""

    def __init__(self, opt: Options):
        super().__init__()
        self.opt = opt
        self.encoder = ResNetEncoderWithZ(opt, in_channels=3)
        self.projector = ResNetDecoderPconv2(opt, in_channels=feature_width(opt))

    def encode(self, img: Tensor):
        """img (B, H, W, 3) → (features (B, H, W, C), Z (B, H, W, 1))."""
        fs, z = self.encoder(_nchw(img))
        if "relu" in self.opt.Z_model:
            z = torch.relu(z)
        return _nhwc(fs), _nhwc(z)

    def decode(self, gen_fs: Tensor) -> Tensor:
        """(B, H, W, C) → (B, H, W, 3) in [-1, 1]. An NHWC-contiguous input
        reaches the convs as a channels_last NCHW view, without a copy."""
        return _nhwc(torch.tanh(self.projector(_nchw(gen_fs))))


def _l2_normalize(v: Tensor, eps: float = 1e-12) -> Tensor:
    return v / (v.norm() + eps)


@torch.no_grad()
def init_random_weights(model: nn.Module, seed: int,
                        power_iters: int = 30) -> None:
    """Seeded random weights for a model built on the CPU (baseline or SLR:
    every conv and dense layer in ``model.modules()``): LeCun-normal
    kernels, zero biases, BN statistics (0, 1).

    Random spectral vectors would give a sigma far from the true spectral
    norm and a deep stack that overflows; the JAX package settles them with
    train-mode passes, which this inference-only port does not have. Instead
    ``power_iters`` power iterations on each fresh kernel set (u, v) close to
    its top singular pair, which is what settled vectors approach."""
    g = torch.Generator().manual_seed(seed)
    for mod in model.modules():
        params = mod._parameters
        w = params.get("weight_orig", params.get("weight"))
        if w is None:
            continue
        w.copy_(torch.randn(w.shape, generator=g) / w[0].numel() ** 0.5)
        if params.get("bias") is not None:
            params["bias"].zero_()
        if "weight_orig" in params:
            w_mat = w.reshape(w.shape[0], -1)
            u = _l2_normalize(torch.randn(w.shape[0], generator=g))
            for _ in range(power_iters):
                v = _l2_normalize(w_mat.t() @ u)
                u = _l2_normalize(w_mat @ v)
            mod.weight_u.copy_(u)
            mod.weight_v.copy_(v)


def z_normalize(opt: Options, z: Tensor, flow: Tensor = None) -> Tensor:
    """Reference Z-norm variants (animating_softmax_splating.py:593-605).

    z (B, H, W, 1); flow (B, H, W, 2) f32, needed only for v2, whose
    per-source maximum-warp norm runs through K6."""
    if opt.use_softmax_splatter_v2:
        if flow is None:
            raise ValueError("the v2 Z-norm needs the flow")
        zn = z - maximum_warp_norm_splat(z.contiguous(), flow.contiguous())
    elif opt.use_softmax_splatter_v1:
        zn = z
    elif opt.use_softmax_splatter_v3:
        zn = torch.sigmoid(z) * 20.0
    else:
        zn = z - z.max()
    if not opt.no_clamp_Z:
        zn = zn.clamp(-20.0, 20.0)
    return zn


def pack_splat_input(fs: Tensor, z_norm: Tensor) -> Tensor:
    """[fs·e^Z, e^Z]: the packed tensor whose summation splat implements
    softmax splatting after normalisation (reference :606,628-634)."""
    ez = torch.exp(z_norm).to(fs.dtype)
    return torch.cat([fs * ez, ez], dim=-1)


def splat_blend(u_f: Tensor, flow_f: Tensor, alpha, u_p: Tensor,
                flow_p: Tensor) -> Tensor:
    """Double-ended dense splat + joint normalisation (reference :606-692)."""
    g = softsplat_sum(u_f, flow_f) * alpha + softsplat_sum(u_p, flow_p) * (1.0 - alpha)
    return g[..., :-1] / torch.clamp(g[..., -1:], min=NORM_EPS)


def z_for_splat(opt: Options, fs: Tensor, z: Tensor) -> Tensor:
    """train_Z gate: without it Z is all-ones (reference :588-590)."""
    if opt.train_Z:
        return z
    return torch.ones_like(fs[..., :1])
