"""Single-layer animating model (PyTorch port of
``slrsfs_tpu/models/baseline.py``): encoder → symmetric double-ended softmax
splat → partial-conv decoder, the (start, middle, end) training pass of
``BaselineTrainable``, frozen for the benchmark's reference (copied from
``slrsfs_tpu_torch/models/baseline.py`` with the kernels replaced by their
plain versions; no v2 Z-norm, no mesh, no embedded motion regressor).
Public tensors are NHWC. ``train`` and ``noise`` are the switches of
``nn/norm.py``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from benchmark.reference.config import Options
from benchmark.reference.nn.archs import get_resnet_arch
from benchmark.reference.nn.resnets import ResNetDecoderPconv2, ResNetEncoderWithZ
from benchmark.reference.ops import (
    NORM_EPS,
    euler_integrate_phased_compact_plain,
    euler_integrate_phased_plain,
    softsplat_sum_plain,
    softsplat_sum_plain_vjp,
)

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

    def encode(self, img: Tensor, train: bool = False,
               noise: Optional[torch.Generator] = None):
        """img (B, H, W, 3) → (features (B, H, W, C), Z (B, H, W, 1))."""
        fs, z = self.encoder(_nchw(img), train, noise)
        if "relu" in self.opt.Z_model:
            z = torch.relu(z)
        return _nhwc(fs), _nhwc(z)

    def decode(self, gen_fs: Tensor, train: bool = False,
               noise: Optional[torch.Generator] = None) -> Tensor:
        """(B, H, W, C) → (B, H, W, 3) in [-1, 1]. An NHWC-contiguous input
        reaches the convs as a channels_last NCHW view, without a copy."""
        return _nhwc(torch.tanh(self.projector(_nchw(gen_fs), train, noise)))

    def forward(self, img: Tensor, train: bool = False,
                noise: Optional[torch.Generator] = None):
        """The JAX ``__call__`` (the pass ``settle`` runs): encode, then
        decode the features."""
        fs, z = self.encode(img, train, noise)
        return self.decode(fs, train, noise), z


def z_normalize(opt: Options, z: Tensor, flow: Tensor = None) -> Tensor:
    """Reference Z-norm variants (animating_softmax_splating.py:593-605).

    z (B, H, W, 1). The default variant subtracts the batch's maximum; v2
    (a per-source maximum-warp norm) is not in the reference."""
    if opt.use_softmax_splatter_v2:
        raise NotImplementedError("the reference has no v2 Z-norm")
    if opt.use_softmax_splatter_v1:
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
    g = (softsplat_sum_plain(u_f, flow_f) * alpha
         + softsplat_sum_plain(u_p, flow_p) * (1.0 - alpha))
    return g[..., :-1] / torch.clamp(g[..., -1:], min=NORM_EPS)


def z_for_splat(opt: Options, fs: Tensor, z: Tensor) -> Tensor:
    """train_Z gate: without it Z is all-ones (reference :588-590)."""
    if opt.train_Z:
        return z
    return torch.ones_like(fs[..., :1])


def fold_uvm(motion: Tensor) -> Tensor:
    """uv·m 3-channel motion → 2-channel flow (reference
    animating_softmax_splating.py:524-543); 2-channel motion passes."""
    if motion.shape[-1] == 3:
        return motion[..., :2] * motion[..., 2:3]
    return motion


def train_integrate(batch: Dict, flow: Tensor, tf_c: Tensor, tp_c: Tensor,
                    T: int) -> Tuple[Tensor, Tensor]:
    """Phase-switched training integration of every sample (K7's plain
    versions): the compact moving-set form when the batch carries
    ``mov_pos`` (B, P, 2) int32 / ``mov_valid`` (B, P) f32, else the dense
    form."""
    flow = flow.contiguous()
    if "mov_pos" in batch:
        return euler_integrate_phased_compact_plain(
            flow, batch["mov_pos"], batch["mov_valid"], tf_c, tp_c, T)
    return euler_integrate_phased_plain(flow, tf_c, tp_c, T)


class BaselineTrainable(BaselineModel):
    """Adds the (start, middle, end) training pass (reference
    ``AnimatingSoftmaxSplating.forward``, animating_softmax_splating.py:
    445-775): one phase-switched integration of ``train_max_steps`` steps
    per sample (K7's plain version) and two summation splats (K3's plain
    version, differentiated by autograd)."""

    def __init__(self, opt: Options, train_max_steps: int = 60):
        super().__init__(opt)
        self.train_max_steps = train_max_steps

    def forward_train(self, batch: Dict, train: bool = True,
                      deterministic: bool = False,
                      noise: Optional[torch.Generator] = None,
                      plain: bool = False):
        """batch: ``images`` [start, middle, end] (B, H, W, 3), ``index``
        (B, 3) int [start, middle, end], ``motions`` (B, H, W, 2|3) f32,
        optionally ``mov_pos``/``mov_valid`` and ``ff_mask`` (B, H, W, 1),
        the free-form occlusion keep-mask. The BN noise comes from the
        generator ``noise`` unless ``deterministic``. ``plain`` runs the K3
        and K7 plain versions on any device. Returns (gen_img, pred)."""
        if not deterministic and noise is None:
            raise ValueError("forward_train needs a noise generator unless "
                             "deterministic")
        noise = None if deterministic else noise
        opt = self.opt
        start_img, middle_img, end_img = batch["images"]
        idx = batch["index"]
        flow = fold_uvm(batch["motions"])
        B = flow.shape[0]

        # two encodes in this order: each runs its own power iterations and
        # BN-statistics updates, the second from the state the first left
        fs_s, z_f = self.encode(start_img, train, noise)
        fs_e, z_p = self.encode(end_img, train, noise)

        t_f = (idx[:, 1] - idx[:, 0]).to(torch.int32)
        t_p = (idx[:, 2] + 1 - idx[:, 1]).to(torch.int32)
        T = self.train_max_steps
        tf_c = t_f.clamp(0, T)
        tp_c = torch.minimum(t_p.clamp(min=0), T - tf_c)
        flow_f, flow_p = train_integrate(batch, flow, tf_c, tp_c, T)

        alpha = (1.0 - (idx[:, 1] - idx[:, 0]).to(fs_s.dtype)
                 / (idx[:, 2] - idx[:, 0] + 1).to(fs_s.dtype)).reshape(B, 1, 1, 1)
        z_f = z_for_splat(opt, fs_s, z_f)
        z_p = z_for_splat(opt, fs_e, z_p)
        # each end normalises with its own flow (reference :593-650)
        zn_f = z_normalize(opt, z_f, flow_f)
        zn_p = z_normalize(opt, z_p, flow_p)

        splat = softsplat_sum_plain_vjp
        g = (splat(pack_splat_input(fs_s, zn_f), flow_f) * alpha
             + splat(pack_splat_input(fs_e, zn_p), flow_p) * (1.0 - alpha))
        feats = g[..., :-1]
        if "ff_mask" in batch:
            # the free-form occlusion mask multiplies the features, not the
            # normaliser (reference :680-692)
            feats = feats * batch["ff_mask"]
        gen_fs = feats / torch.clamp(g[..., -1:], min=NORM_EPS)
        gen_img = self.decode(gen_fs, train, noise)
        pred = {"PredImg": gen_img, "OutputImg": middle_img, "Z_f": zn_f,
                "GTMotion": flow}
        return gen_img, pred
