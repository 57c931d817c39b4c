"""SLR two-layer model (PyTorch port of ``slrsfs_tpu/models/slr.py``): a
warped fluid layer composited over a hallucinated static background with
alpha maps, its stage-3 training pass (``SLRTrainable``) and loss set
(``slr_extra_losses``), frozen for the benchmark's reference (copied from
``slrsfs_tpu_torch/models/slr.py`` with the kernels' plain versions).
Public tensors are NHWC.

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

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from benchmark.reference.config import Options
from benchmark.reference.models.baseline import (
    _nchw,
    _nhwc,
    feature_width,
    fold_uvm,
    train_integrate,
    z_for_splat,
    z_normalize,
)
from benchmark.reference.nn.resnets import (
    ResNetBGDecoder,
    ResNetDecoderPconv2,
    ResNetEncoder,
    ResNetEncoderWithZ,
)
from benchmark.reference.ops import (
    NORM_EPS,
    softsplat_sum_plain_vjp,
)

Tensor = torch.Tensor

SLR_MODEL_TYPE = "softmax_splating_2layers_alpha_seperate"
BG_MODEL_TYPE = "bg"  # stage 2, BackgroundModel
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

    def alpha_encode_raw(self, img: Tensor, motion: Optional[Tensor] = None,
                         mask_rock: Optional[Tensor] = None,
                         bg_raw: Optional[Tensor] = None, train: bool = False,
                         noise: Optional[torch.Generator] = None) -> Tensor:
        """The alpha encoder's whole output (B, H, W, 2), or 3 channels with
        ``AKLloss`` (channel 2 the alpha log-sigma)."""
        x = build_alpha_input(self.opt, img, motion, mask_rock, bg_raw)
        return _nhwc(self.net_alpha_encoder(_nchw(x), train, noise))

    def alpha_encode(self, img: Tensor, motion: Optional[Tensor] = None,
                     mask_rock: Optional[Tensor] = None,
                     bg_raw: Optional[Tensor] = None, train: bool = False,
                     noise: Optional[torch.Generator] = None
                     ) -> Tuple[Tensor, Tensor]:
        """→ (alpha_bg_logits, alpha_fluid_logits), each (B, H, W, 1)."""
        return split_alpha_output(self.opt, self.alpha_encode_raw(
            img, motion, mask_rock, bg_raw, train, noise))

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


class BackgroundModel(nn.Module):
    """The stage-2 background network (reference ``BackgroundNetwork``,
    2layers file :1117-1234): ``net_bg`` alone, trained to reproduce the
    temporal mean video from the start view. Its keys are the SLR model's
    (``net_bg.*``), so stage 3 takes them as they are."""

    def __init__(self, opt: Options):
        super().__init__()
        self.opt = opt
        self.net_bg = ResNetBGDecoder(opt)

    def forward(self, img: Tensor, train: bool = False,
                noise: Optional[torch.Generator] = None) -> Tensor:
        """img (B, H, W, 3) → tanh(net_bg(img)) (B, H, W, 3)."""
        return _nhwc(torch.tanh(self.net_bg(_nchw(img), train, noise)))

    def forward_train(self, batch: Dict, train: bool = True,
                      deterministic: bool = False,
                      noise: Optional[torch.Generator] = None,
                      plain: bool = False):
        """The background from ``images[0]``, with ``mean_video`` as the
        target (reference :1128-1225; the trainer's ``bg`` task compares
        them). No kernels: ``plain`` changes nothing. Returns (bg, pred)."""
        if not deterministic and noise is None:
            raise ValueError("forward_train needs a noise generator unless "
                             "deterministic")
        bg_f = self(batch["images"][0], train, None if deterministic else noise)
        return bg_f, {"PredImg": bg_f, "OutputImg": batch["mean_video"]}


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
                  a_bg_raw: Optional[Tensor] = None,
                  train_mode: bool = False) -> Tuple[Tensor, Tensor]:
    """Two-layer composite (forward_flow :1056-1088) with the reference's
    variants: ``use_alpha_softmax`` (softmax over the two raw logits),
    ``clamp_alpha`` (fluid weight floored; the background weighted by
    σ(a_bg)/norm in training, :646-651, by 1 − the fluid weight at
    inference, :1071-1075), ``use_{fluid,bg}_alpha_only`` (normaliser 1).
    Returns (gen_img, composite_fluid_alpha)."""
    if (opt is not None and opt.use_alpha_softmax > 0.0
            and ga_raw is not None and a_bg_raw is not None):
        w = torch.softmax(torch.cat([ga_raw, a_bg_raw], dim=-1), dim=-1)
        comp = w[..., 0:1]
        gen = comp * gen_fluid_img + w[..., 1:2] * bg_img_tanh
    elif opt is not None and opt.clamp_alpha > 0.0:
        alpha_norm = torch.clamp(gen_fluid_alpha_sig + alpha_bg_sig, min=1e-8)
        comp = torch.clamp(gen_fluid_alpha_sig / alpha_norm, min=opt.clamp_alpha)
        bg_w = alpha_bg_sig / alpha_norm if train_mode else 1.0 - comp
        gen = comp * gen_fluid_img + bg_w * bg_img_tanh
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


# ---------------------------------------------------------------------------
# Training (stage 3, the joint two-layer fine-tune)
# ---------------------------------------------------------------------------

def smooth_l1(x: Tensor, y: Tensor, gamma: float = 0.1) -> Tensor:
    """Reference SmoothL1Loss (2layers file :63-65), elementwise."""
    t = torch.abs(x - y)
    return t + gamma * (2.0 * torch.sigmoid(5.0 * t) - 1.0)


def total_variation(img: Tensor) -> Tensor:
    """Reference total_variation_loss (:67-71) of an NHWC tensor."""
    return (torch.mean(torch.abs(img[:, :, :-1, :] - img[:, :, 1:, :]))
            + torch.mean(torch.abs(img[:, :-1, :, :] - img[:, 1:, :, :])))


class SLRTrainable(SLRModel):
    """Adds the (start, middle, end) training pass of the joint two-layer
    model (reference forward, 2layers file :256-809): one phase-switched
    integration per sample (K7) and two summation splats with their gather
    VJPs (K3) of the packed ``[fs·e^Z, af·e^C, e^C, e^Z]`` rows.
    """

    def __init__(self, opt: Options, train_max_steps: int = 60):
        super().__init__(opt)
        self.train_max_steps = train_max_steps

    def forward_train(self, batch: Dict, train: bool = True,
                      deterministic: bool = False,
                      noise: Optional[torch.Generator] = None,
                      plain: bool = False):
        """batch: ``images`` [start, middle, end] (B, H, W, 3), ``index``
        (B, 3) int, ``motions`` (B, H, W, 2|3) f32, ``mask_rock`` (B, H, W,
        1), ``mean_video`` (B, H, W, 3), optionally ``mov_pos`` /
        ``mov_valid`` and ``ff_mask`` (B, H, W, 1), the free-form occlusion
        keep-mask on the normalised features. The BN noise comes from ``noise`` unless
        ``deterministic``; ``plain`` runs the K3 and K7 plain versions.
        Returns (gen_img, pred), pred holding every tensor of the SLR loss
        set under the JAX package's keys."""
        if not deterministic and noise is None:
            raise ValueError("forward_train needs a noise generator unless "
                             "deterministic")
        noise = None if deterministic else noise
        opt = self.opt
        start_img, middle_img, end_img = batch["images"]
        idx = batch["index"]
        flow = fold_uvm(batch["motions"])
        mask_rock = batch["mask_rock"]
        B = flow.shape[0]

        # moving-region mask from the motion's speed (reference :334-344)
        speed = torch.linalg.vector_norm(flow, dim=-1, keepdim=True)
        small_motion_alpha = (
            speed < speed.mean(dim=(1, 2, 3), keepdim=True) * 0.1).to(flow.dtype)

        # the sub-networks in the JAX package's order: each call runs its
        # own power iterations and BN-statistics updates
        fs_s, z_f = self.encode(start_img, train, noise)
        fs_e, z_p = self.encode(end_img, train, noise)
        bg_raw = self.bg(start_img, train, noise)
        bg_tanh = torch.tanh(bg_raw)
        # both views take the start view's motion, mask and background
        extras = dict(motion=flow, mask_rock=mask_rock, bg_raw=bg_raw,
                      train=train, noise=noise)
        out_f = self.alpha_encode_raw(start_img, **extras)
        out_p = self.alpha_encode_raw(end_img, **extras)
        a_bg_logits_f, a_fl_logits_f = split_alpha_output(opt, out_f)
        _, a_fl_logits_p = split_alpha_output(opt, out_p)
        a_bg_sig_f = torch.sigmoid(a_bg_logits_f)

        # frame 0's composite fluid alpha (reference :420-430)
        a_fl_sig_f = torch.sigmoid(a_fl_logits_f)
        comp_i0 = a_fl_sig_f / torch.clamp(a_fl_sig_f + a_bg_sig_f, min=1e-8)
        if opt.use_fluid_alpha_only:
            comp_i0 = a_fl_sig_f
        if opt.use_bg_alpha_only:
            comp_i0 = a_bg_sig_f
        if opt.use_alpha_softmax > 0.0:
            comp_i0 = torch.softmax(torch.cat([a_fl_logits_f, a_bg_logits_f], -1),
                                    dim=-1)[..., 0:1]

        t_f = (idx[:, 1] - idx[:, 0]).to(torch.int32)
        t_p = (idx[:, 2] + 1 - idx[:, 1]).to(torch.int32)
        T = self.train_max_steps
        tf_c = t_f.clamp(0, T)
        tp_c = torch.minimum(t_p.clamp(min=0), T - tf_c)
        flow_f, flow_p = train_integrate(batch, flow, tf_c, tp_c, T)

        alpha = torch.clamp(
            1.0 - (idx[:, 1] - idx[:, 0]).to(fs_s.dtype)
            / (idx[:, 2] - idx[:, 0] + 1).to(fs_s.dtype),
            ALPHA_MIN, ALPHA_MAX).reshape(B, 1, 1, 1)
        zn_f = z_normalize(opt, z_for_splat(opt, fs_s, z_f), flow_f)
        zn_p = z_normalize(opt, z_for_splat(opt, fs_e, z_p), flow_p)

        # both ends take frame 0's composite alpha as blending weight
        # (reference :480-540)
        u_f, use_alpha0 = slr_pack_splat_input(opt, fs_s, zn_f, a_fl_logits_f,
                                               a_bg_sig_f)
        ez_p = torch.exp(zn_p)
        if use_alpha0:
            comp_exp = torch.exp(comp_i0)
            u_p = torch.cat([fs_e * ez_p, a_fl_logits_p * comp_exp, comp_exp, ez_p],
                            dim=-1)
        else:
            u_p = torch.cat([fs_e * ez_p, a_fl_logits_p * ez_p, ez_p], dim=-1)

        splat = softsplat_sum_plain_vjp
        g = splat(u_f, flow_f) * alpha + splat(u_p, flow_p) * (1.0 - alpha)
        alpha_fluid_mask = (g[..., -1:] > NORM_EPS).to(g.dtype).detach()
        gen_fs, alpha_fluid_warped = slr_unpack_splatted(g, use_alpha0)
        if "ff_mask" in batch:
            # SLR applies the occlusion mask after the normalisation (:586-594)
            gen_fs = gen_fs * batch["ff_mask"]

        gen_fluid_img = self.decode_fluid(gen_fs, train, noise)
        ga_raw = self.decode_alpha(gen_fs, alpha_fluid_warped, start_img, train,
                                   noise)
        gen_img, comp_alpha = slr_composite(
            gen_fluid_img, torch.sigmoid(ga_raw), a_bg_sig_f, bg_tanh, opt=opt,
            ga_raw=ga_raw, a_bg_raw=a_bg_logits_f, train_mode=True)

        # the three-way target alpha (reference :619-621)
        moving = 1.0 - small_motion_alpha
        gt_alpha = (mask_rock * moving * 0.25 + (1.0 - mask_rock) * moving * 1.0
                    + small_motion_alpha * 0.5)
        pred = {
            "PredImg": gen_img,
            "OutputImg": middle_img,
            "BGImg_f": bg_tanh,
            "MeanImg": batch["mean_video"],
            "FluidImg": gen_fluid_img,
            "AlphaFluid_f": a_fl_sig_f,
            "AlphaBG_f": a_bg_sig_f,
            "AlphaFluidLogits_f": a_fl_logits_f,
            "CompositeFluidAlpha": comp_alpha,
            "CompositeFluidAlpha_I0": comp_i0,
            "AlphaFluidWarped": alpha_fluid_warped,
            "AlphaFluidMask": alpha_fluid_mask,
            "GenFluidAlphaRaw": ga_raw,
            "GTAlpha": gt_alpha,
            "SmallMotionAlpha": small_motion_alpha,
            "RockMask": mask_rock,
            "Z_f": zn_f,
            "GTMotion": flow,
        }
        if opt.AKLloss > 0.0:
            # the clamped log-sigma channel (:411-413); the KL term itself is
            # commented out in the reference (:609-615)
            pred["AlphaLogSigma"] = torch.clamp(out_p[..., 2:3], -50.0, 50.0)
        return gen_img, pred


def decayed_weight(base: float, decay: float, epoch: int) -> Tensor:
    """Per-epoch multiplicative loss-weight decay of the shipped stage-3
    training scripts (``w -= w / decay`` after every epoch, :356-358):
    w(e) = w0 · (1 − 1/decay)^e, in float32."""
    factor = torch.tensor(1.0 - 1.0 / decay, dtype=torch.float32)
    return torch.tensor(base, dtype=torch.float32) * torch.pow(factor, float(epoch))


def slr_extra_losses(opt: Options, pred: Dict[str, Tensor], synth_loss_fn=None,
                     rock_weight=None, epoch: Optional[int] = None
                     ) -> Dict[str, Tensor]:
    """The SLR loss set on top of the synthesis loss (reference :658-765),
    the JAX ``slr_extra_losses`` term for term. ``rock_weight`` overrides
    ``opt.RockRegionloss``; ``epoch`` drives the decays ``AlphaWeightDecay``
    (AlphaMSE) and ``RockRegionlossDecay`` (RockRegion and FluidRegion).
    Returns the terms and their weighted sum, ``Total Extra``."""
    out: Dict[str, Tensor] = {}
    total = 0.0
    moving = 1.0 - pred["SmallMotionAlpha"]
    rock = pred["RockMask"]
    comp_i0 = pred["CompositeFluidAlpha_I0"]
    gt_alpha = pred["GTAlpha"]

    alpha_mse_w = opt.AlphaMSEloss
    fluid_w = opt.FluidRegionloss
    rock_decay_on = epoch is not None and opt.RockRegionlossDecay > 0.0
    if epoch is not None and opt.AlphaWeightDecay > 0.0:
        alpha_mse_w = decayed_weight(opt.AlphaMSEloss, opt.AlphaWeightDecay, epoch)
    if rock_decay_on:
        fluid_w = decayed_weight(opt.FluidRegionloss, opt.RockRegionlossDecay, epoch)

    if opt.AlphaMSEloss > 0.0:
        v = torch.mean(torch.square(comp_i0 * moving - gt_alpha * moving))
        out["AlphaMSEloss"] = v
        total = total + v * alpha_mse_w
    if opt.AlphaL1loss > 0.0:
        v = torch.mean(smooth_l1(comp_i0 * moving, gt_alpha * moving))
        out["AlphaL1loss"] = v
        total = total + v * opt.AlphaL1loss
    if opt.ATVloss > 0.0:
        v = (total_variation(pred["AlphaFluidLogits_f"])
             + total_variation(pred["AlphaBG_f"]))
        out["AlphaTV"] = v
        total = total + v * opt.ATVloss
    if opt.MVloss > 0.0 and synth_loss_fn is not None:
        bg_losses = synth_loss_fn(pred["BGImg_f"], pred["MeanImg"])
        for k, v in bg_losses.items():
            if "Perceptual" in k or "L1" in k:
                out[k + "_bg"] = v
        total = total + bg_losses["Total Loss"] * opt.MVloss
    if opt.FluidRegionloss > 0.0:
        m = (1.0 - rock) * moving
        v = torch.mean(smooth_l1(comp_i0 * m, torch.ones_like(comp_i0) * m))
        out["FluidRegionLoss"] = v
        total = total + v * fluid_w
    rw = opt.RockRegionloss if rock_weight is None else rock_weight
    if rock_weight is None and rock_decay_on:
        rw = decayed_weight(opt.RockRegionloss, opt.RockRegionlossDecay, epoch)
    if rock_weight is not None or opt.RockRegionloss > 0.0:
        m = rock * moving
        v = torch.mean(smooth_l1(
            comp_i0 * m, opt.RockRegionlosstarget * torch.ones_like(comp_i0) * m))
        out["RockRegionLoss"] = v
        total = total + v * rw
    if opt.ADCloss > 0.0 or opt.MRADCloss > 0.0:
        m = pred["AlphaFluidMask"]
        adc = smooth_l1(pred["AlphaFluidWarped"].detach() * m,
                        pred["GenFluidAlphaRaw"] * m)
        if opt.ADCloss > 0.0:
            v = torch.mean(adc)
            out["Alpha Decoder Consistency Loss"] = v
            total = total + v * opt.ADCloss
        if opt.MRADCloss > 0.0:
            v = torch.mean(adc * moving)
            out["Moving Region Alpha Decoder Consistency Loss"] = v
            total = total + v * opt.MRADCloss
    out["Total Extra"] = total
    return out
