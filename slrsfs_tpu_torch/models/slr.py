"""SLR two-layer model, inference pieces (PyTorch port of
``slrsfs_tpu/models/slr.py``): a warped fluid layer composited over a
hallucinated static background with alpha maps. Public tensors are NHWC, as
in the JAX package.

* ``encoder`` / ``projector``: the fluid layer's encoder (with Z) and pconv
  decoder, as in the baseline;
* ``net_bg``: the background ("mean video") network;
* ``net_alpha_encoder``: the 2-channel alpha head on the input image
  (channel 0 background logits, channel 1 fluid logits);
* ``net_alpha_decoder``: a pconv decoder on ``[warped features, warped
  fluid alpha]`` giving the refined fluid alpha logits.

The splat packs ``[fs·e^Z, af·e^C, e^C, e^Z]`` with ``C`` the composite
fluid alpha when ``use_alpha0_as_blending_weight``, else ``[fs·e^Z, af·e^Z,
e^Z]``; the composite is ``(σ(a_fluid)·I_fluid + σ(a_bg)·I_bg) /
max(σ(a_fluid) + σ(a_bg), 1e-8)`` and its variants.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from slrsfs_tpu_torch.config import Options
from slrsfs_tpu_torch.models.baseline import _nchw, _nhwc, feature_width
from slrsfs_tpu_torch.nn.resnets import (
    ResNetBGDecoder,
    ResNetDecoderPconv2,
    ResNetEncoder,
    ResNetEncoderWithZ,
)
from slrsfs_tpu_torch.ops.splat import NORM_EPS

Tensor = torch.Tensor

SLR_MODEL_TYPE = "softmax_splating_2layers_alpha_seperate"
ALPHA_MIN, ALPHA_MAX = 1.0 / 600.0, 599.0 / 600.0  # reference :461,952


def _alpha_opt(opt: Options) -> Options:
    """The alpha encoder's and decoder's options (reference utilities.py:
    105-133): 2 output channels (3 with AKLloss), decoder input
    ``[gen_fs, warped_alpha]`` and a 1-channel output."""
    out_channel = 3 if opt.AKLloss > 0.0 else 2
    adi = 1
    if "decouple" in opt.alpha_refine_model_type:
        adi -= opt.ngf
    elif "image" in opt.alpha_refine_model_type:
        adi -= opt.ngf - 3
    return opt.replace(
        refine_model_type=opt.alpha_refine_model_type,
        out_channel=out_channel,
        addtional_decoder_input=adi,
        addtional_decoder_output=-2,
    )


def alpha_in_channels(opt: Options) -> int:
    """Alpha-encoder input width: image + optional [motion (2), mask (1),
    bg_raw (3)] (reference 2layers file :375-385)."""
    n = 3
    if opt.use_motion_as_alpha_input:
        n += 2
    if opt.use_mask_as_alpha_input:
        n += 1
    if opt.use_bg_as_alpha_input:
        n += 3
    return n


def alpha_decoder_in_channels(opt: Options) -> int:
    """1 for the 'decouple' variant, 4 for 'image', else fs_w + 1
    (slrsfs_tpu/io/checkpoint.py:141-143)."""
    amt = opt.alpha_refine_model_type
    if "decouple" in amt:
        return 1
    if "image" in amt:
        return 4
    return feature_width(opt) + 1


def split_alpha_output(opt: Options, out: Tensor) -> Tuple[Tensor, Tensor]:
    """Alpha-encoder output → (bg_logits, fluid_logits). With
    ``use_sum1_alpha`` channel 0 is the fluid logit and σ(bg) = 1 − σ(fluid)
    = σ(−fluid)."""
    if opt.use_sum1_alpha:
        a_fl = out[..., 0:1]
        return -a_fl, a_fl
    return out[..., 0:1], out[..., 1:2]


def build_alpha_input(opt: Options, img: Tensor,
                      motion: Optional[Tensor] = None,
                      mask_rock: Optional[Tensor] = None,
                      bg_raw: Optional[Tensor] = None) -> Tensor:
    """The alpha-encoder inputs in reference order (img, +motion, +mask,
    +bg_raw; :375-385). bg_raw is pre-tanh."""
    parts = [img]
    for flag, t, name in ((opt.use_motion_as_alpha_input, motion, "motion"),
                          (opt.use_mask_as_alpha_input, mask_rock, "mask_rock"),
                          (opt.use_bg_as_alpha_input, bg_raw, "bg_raw")):
        if flag:
            if t is None:
                raise ValueError(f"the alpha encoder's options need {name}")
            parts.append(t)
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)


class SLRModel(nn.Module):
    """The five sub-networks, named as in the reference checkpoint."""

    def __init__(self, opt: Options):
        super().__init__()
        self.opt = opt
        a_opt = _alpha_opt(opt)
        self.encoder = ResNetEncoderWithZ(opt, in_channels=3)
        self.projector = ResNetDecoderPconv2(opt, in_channels=feature_width(opt))
        self.net_bg = ResNetBGDecoder(opt)
        self.net_alpha_encoder = ResNetEncoder(
            a_opt, in_channels=alpha_in_channels(opt))
        self.net_alpha_decoder = ResNetDecoderPconv2(
            a_opt, in_channels=alpha_decoder_in_channels(opt))

    def encode(self, img: Tensor, train: bool = False,
               noise: Optional[torch.Generator] = None) -> Tuple[Tensor, Tensor]:
        """img (B, H, W, 3) → (features (B, H, W, C), Z (B, H, W, 1))."""
        fs, z = self.encoder(_nchw(img), train, noise)
        if "relu" in self.opt.Z_model:
            z = torch.relu(z)
        return _nhwc(fs), _nhwc(z)

    def bg(self, img: Tensor, train: bool = False,
           noise: Optional[torch.Generator] = None) -> Tensor:
        """Raw (pre-tanh) background image."""
        return _nhwc(self.net_bg(_nchw(img), train, noise))

    def alpha_encode(self, img: Tensor, motion: Optional[Tensor] = None,
                     mask_rock: Optional[Tensor] = None,
                     bg_raw: Optional[Tensor] = None, train: bool = False,
                     noise: Optional[torch.Generator] = None
                     ) -> Tuple[Tensor, Tensor]:
        """→ (alpha_bg_logits, alpha_fluid_logits), each (B, H, W, 1)."""
        x = build_alpha_input(self.opt, img, motion, mask_rock, bg_raw)
        return split_alpha_output(
            self.opt, _nhwc(self.net_alpha_encoder(_nchw(x), train, noise)))

    def decode_fluid(self, gen_fs: Tensor, train: bool = False,
                     noise: Optional[torch.Generator] = None) -> Tensor:
        return _nhwc(torch.tanh(self.projector(_nchw(gen_fs), train, noise)))

    def decode_alpha(self, gen_fs: Tensor, alpha_warped: Tensor,
                     img: Optional[Tensor] = None, train: bool = False,
                     noise: Optional[torch.Generator] = None) -> Tensor:
        """Refined fluid alpha logits from the warped features and fluid
        alpha (input variants 'decouple' / 'image' as the reference)."""
        return self.decode_alpha_packed(torch.cat([gen_fs, alpha_warped], -1),
                                        img, train, noise)

    def forward(self, img: Tensor, train: bool = False,
                noise: Optional[torch.Generator] = None):
        """The JAX ``__call__`` (the pass ``settle`` runs): every
        sub-network once, the alpha encoder on zero motion and mask."""
        fs, _ = self.encode(img, train, noise)
        fluid = self.decode_fluid(fs, train, noise)
        bg = self.bg(img, train, noise)
        B, H, W = img.shape[:3]
        a_bg, a_fl = self.alpha_encode(
            img, motion=img.new_zeros((B, H, W, 2)),
            mask_rock=img.new_zeros((B, H, W, 1)), bg_raw=bg, train=train,
            noise=noise)
        ga = self.decode_alpha(fs, a_fl, img, train, noise)
        return fluid, bg, a_bg, ga

    def decode_alpha_packed(self, packed: Tensor,
                            img: Optional[Tensor] = None, train: bool = False,
                            noise: Optional[torch.Generator] = None) -> Tensor:
        """``decode_alpha`` on ``[gen_fs, alpha_warped]`` in one tensor, the
        layout K2's SLR epilogue writes: the default variant reads it as is."""
        amt = self.opt.alpha_refine_model_type
        if "decouple" in amt:
            x = packed[..., -1:]
        elif "image" in amt:
            if img is None:
                raise ValueError("the 'image' alpha decoder needs the image")
            x = torch.cat([img, packed[..., -1:]], dim=-1)
        else:
            x = packed
        return _nhwc(self.net_alpha_decoder(_nchw(x), train, noise))


def slr_pack_splat_input(opt: Options, fs: Tensor, zn: Tensor,
                         alpha_fluid_logits: Tensor,
                         alpha_bg_sig: Tensor) -> Tuple[Tensor, bool]:
    """Packed splat tensor (forward_flow :963-976) → (packed, use_alpha0):
    ``[fs·e^Z, af·e^C, e^C, e^Z]`` with ``use_alpha0_as_blending_weight``,
    else ``[fs·e^Z, af·e^Z, e^Z]``."""
    ez = torch.exp(zn)
    if opt.use_alpha0_as_blending_weight:
        a_fl_sig = torch.sigmoid(alpha_fluid_logits)
        norm0 = torch.clamp(a_fl_sig + alpha_bg_sig, min=1e-8)
        comp = torch.exp(a_fl_sig / norm0)
        return torch.cat([fs * ez, alpha_fluid_logits * comp, comp, ez],
                         dim=-1), True
    return torch.cat([fs * ez, alpha_fluid_logits * ez, ez], dim=-1), False


def slr_unpack_splatted(g: Tensor, use_alpha0: bool) -> Tuple[Tensor, Tensor]:
    """Normalise a summed double-ended SLR splat (forward_flow :992-1045)
    → (gen_fs (…, C), alpha_fluid_warped (…, 1)). ``af`` is divided by the
    ``e^C`` channel with ``use_alpha0``, by ``e^Z`` otherwise."""
    norm = torch.clamp(g[..., -1:], min=NORM_EPS)
    if use_alpha0:
        a_norm = torch.clamp(g[..., -2:-1], min=NORM_EPS)
        return g[..., :-3] / norm, g[..., -3:-2] / a_norm
    return g[..., :-2] / norm, g[..., -2:-1] / norm


def slr_composite(gen_fluid_img: Tensor, gen_fluid_alpha_sig: Tensor,
                  alpha_bg_sig: Tensor, bg_img_tanh: Tensor,
                  alpha_region: Optional[Tensor] = None,
                  opt: Optional[Options] = None,
                  ga_raw: Optional[Tensor] = None,
                  a_bg_raw: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Two-layer composite at inference (forward_flow :1056-1088) with the
    reference's variants: ``use_alpha_softmax`` (softmax over the two raw
    logits), ``clamp_alpha`` (fluid weight floored, background 1 − it),
    ``use_{fluid,bg}_alpha_only`` (normaliser 1). Returns (gen_img,
    composite_fluid_alpha)."""
    if (opt is not None and opt.use_alpha_softmax > 0.0
            and ga_raw is not None and a_bg_raw is not None):
        w = torch.softmax(torch.cat([ga_raw, a_bg_raw], dim=-1), dim=-1)
        comp = w[..., 0:1]
        gen = comp * gen_fluid_img + w[..., 1:2] * bg_img_tanh
    elif opt is not None and opt.clamp_alpha > 0.0:
        alpha_norm = torch.clamp(gen_fluid_alpha_sig + alpha_bg_sig, min=1e-8)
        comp = torch.clamp(gen_fluid_alpha_sig / alpha_norm, min=opt.clamp_alpha)
        gen = comp * gen_fluid_img + (1.0 - comp) * bg_img_tanh
    else:
        if opt is not None and (opt.use_fluid_alpha_only
                                or opt.use_bg_alpha_only):
            alpha_norm = torch.ones_like(gen_fluid_alpha_sig)
        else:
            alpha_norm = torch.clamp(gen_fluid_alpha_sig + alpha_bg_sig,
                                     min=1e-8)
        gen = (gen_fluid_alpha_sig * gen_fluid_img
               + alpha_bg_sig * bg_img_tanh) / alpha_norm
        comp = gen_fluid_alpha_sig / alpha_norm
    if alpha_region is not None:
        gen = gen * alpha_region + gen_fluid_img * (1.0 - alpha_region)
    return gen, comp
