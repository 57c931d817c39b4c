"""Motion regressors: dense Eulerian motion from an image, a fluid mask and
sparse hints (PyTorch port of ``slrsfs_tpu/models/motion.py``).

* ``SPADEUnet4MaskMotion`` (reference ``models/networks/architectures.py
  :602-743``): an 8-down/8-up UNet whose normalisation is SPADE,
  conditioned on the 6-channel input [RGB, mask, hint] (the mask resized
  nearest, the rest bilinear), with the reference's per-channel upsampling
  (channels [:3] bilinear, [3:4] nearest, [4:] bilinear);
* ``Unet4Motion`` (architectures.py:382-493): the same skeleton with
  parameter-free instance norms and uniform bilinear upsampling;
* ``MotionRegressor`` (reference ``models/unet_motion.py``): assembles the
  [image, mask, hint] input and scales the prediction by ``div_flow``.

Children carry the reference's names (``motion_predictor.conv1..8``,
``dconv1..8``, ``spade_layer*``, ``mlp_shared.0``), so a reference
``.pth`` loads as it is. Public tensors are NHWC, as in the JAX package;
inside, NCHW. ``MotionRegressor.forward_train`` and ``motion_losses`` are
the motion GAN's training pass and loss (reference ``unet_motion.py:
131-172``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from slrsfs_tpu_torch.config import Options, spectral
from slrsfs_tpu_torch.losses.synthesis import MotionLoss, psnr
from slrsfs_tpu_torch.nn.conv import (
    Conv,
    resize_bilinear,
    resize_nearest,
    upsample_bilinear_2x,
    upsample_nearest_2x,
)
from slrsfs_tpu_torch.nn.discriminators import instance_norm

Tensor = torch.Tensor

MOTION_MODEL_TYPES = ("SPADE_unet_mask_motion", "unet_motion")


def _resize_segmap(segmap: Tensor, h: int, w: int) -> Tensor:
    """SPADE's segmap resize (networks.py:441-454), NCHW: channel 3 (the
    mask) nearest, the others bilinear; 1-, 4- and 6-channel maps."""
    c = segmap.shape[1]
    if c == 1:
        return resize_nearest(segmap, h, w)
    if c in (4, 6):
        parts = [resize_bilinear(segmap[:, :3], h, w),
                 resize_nearest(segmap[:, 3:4], h, w)]
        if c == 6:
            parts.append(resize_bilinear(segmap[:, 4:6], h, w))
        return torch.cat(parts, dim=1)
    return resize_bilinear(segmap, h, w)


class SPADE(nn.Module):
    """networks.py:422-463, the parameter-free instance-norm variant:
    ``instance_norm(x) · (1 + gamma) + beta`` with gamma and beta from
    plain 3x3 convs of the resized segmap."""

    def __init__(self, features: int, label_channels: int, hidden: int = 128):
        super().__init__()
        # the reference's nn.Sequential(conv, ReLU): its key is mlp_shared.0
        self.mlp_shared = nn.Sequential(Conv(label_channels, hidden, 3, 1, 1),
                                        nn.ReLU())
        self.mlp_gamma = Conv(hidden, features, 3, 1, 1)
        self.mlp_beta = Conv(hidden, features, 3, 1, 1)

    def forward(self, x: Tensor, segmap: Tensor) -> Tensor:
        seg = _resize_segmap(segmap, x.shape[2], x.shape[3])
        h = self.mlp_shared(seg)
        return instance_norm(x) * (1.0 + self.mlp_gamma(h)) + self.mlp_beta(h)


def _up_split(x: Tensor) -> Tensor:
    """The reference's per-channel 2x upsample (architectures.py:698-739):
    channels [:3] bilinear, [3:4] nearest, [4:] bilinear (a narrower x
    has fewer parts; torch's upsampling refuses an empty one)."""
    parts = [(up, x[:, lo:hi]) for up, lo, hi in
             ((upsample_bilinear_2x, 0, 3), (upsample_nearest_2x, 3, 4),
              (upsample_bilinear_2x, 4, x.shape[1]))]
    return torch.cat([up(p) for up, p in parts if p.shape[1]], dim=1)


def _enc_mults(downs: int) -> Tuple[int, ...]:
    """Channel multipliers nf·[1, 2, 4, 8, 8, …] of an n-down UNet (the
    reference has 8 downs; fewer cut the smallest input from 256² to
    2^downs squared, for small tests)."""
    return tuple(([1, 2, 4] + [8] * max(0, downs - 3))[:downs])


class _MotionUNet(nn.Module):
    """The skeleton both UNets share: ``conv1..d`` (4x4, stride 2) down,
    ``dconv1..d`` (3x3) up, spectral convs when ``config.spectral(opt)``."""

    def __init__(self, opt: Options, channels_in: int = 6, num_filters: int = 32,
                 channels_out: int = 2, downs: int = 8):
        super().__init__()
        sp = spectral(opt)
        nf, d = num_filters, downs
        self.mults = mults = _enc_mults(d)
        self.downs = d
        for i in range(1, d + 1):
            c_in = channels_in if i == 1 else nf * mults[i - 2]
            setattr(self, f"conv{i}", Conv(c_in, nf * mults[i - 1], 4, 2, 1,
                                           spectral=sp))
        for i in range(1, d):
            c_in = nf * mults[d - 1] if i == 1 else 2 * nf * mults[d - i]
            setattr(self, f"dconv{i}", Conv(c_in, nf * mults[d - i - 1], 3, 1, 1,
                                            spectral=sp))
        setattr(self, f"dconv{d}", Conv(2 * nf * mults[0], channels_out, 3, 1, 1,
                                        spectral=sp))

    def encode(self, x: Tensor, norm, train: bool):
        """The encoder's outputs, deepest last. LeakyReLU 0.2 before every
        conv but the first; ``norm(i, h)`` after each but the first and
        last."""
        enc, h = [], x
        for i in range(1, self.downs + 1):
            h = getattr(self, f"conv{i}")(h if i == 1 else F.leaky_relu(h, 0.2),
                                          train)
            if 1 < i < self.downs:
                h = norm(i, h)
            enc.append(h)
        return enc


class SPADEUnet4MaskMotion(_MotionUNet):
    """architectures.py:602-743, channels_in 6 ([img, mask, hint]). The
    SPADE layers are counted per channel multiplier over the encoder, then
    the decoder; the one nf-wide decoder layer is ``spade_layer``, so at
    depth 8 the names are the reference's (``spade_layer2_0``,
    ``spade_layer4_0``, ``spade_layer8_0..7``, ``spade_layer4_1``,
    ``spade_layer2_1``, ``spade_layer``)."""

    def __init__(self, opt: Options, channels_in: int = 6, num_filters: int = 32,
                 channels_out: int = 2, downs: int = 8):
        super().__init__(opt, channels_in, num_filters, channels_out, downs)
        d, mults = downs, self.mults
        counts = {}

        def spade(mult):
            i = counts.get(mult, 0)
            counts[mult] = i + 1
            name = "spade_layer" if mult == 1 else f"spade_layer{mult}_{i}"
            setattr(self, name, SPADE(num_filters * mult, channels_in))
            return name

        self.enc_spades = {i: spade(mults[i - 1]) for i in range(2, d)}
        self.dec_spades = [spade(mults[d - i - 1]) for i in range(1, d)]

    def forward(self, x: Tensor, train: bool = False) -> Tensor:
        """x (B, channels_in, H, W) → (B, channels_out, H, W)."""
        d = self.downs
        enc = self.encode(x, lambda i, h: getattr(self, self.enc_spades[i])(h, x),
                          train)
        h = _up_split(torch.relu(enc[-1]))
        for i in range(1, d):
            h = getattr(self, self.dec_spades[i - 1])(
                getattr(self, f"dconv{i}")(h, train), x)
            h = torch.relu(torch.cat([_up_split(h), _up_split(enc[d - i - 1])], 1))
        return getattr(self, f"dconv{d}")(h, train)


class Unet4Motion(_MotionUNet):
    """architectures.py:382-493: instance norms (``motion_norm_G``
    'spectral_instance') and uniform bilinear upsampling."""

    def forward(self, x: Tensor, train: bool = False) -> Tensor:
        d = self.downs
        enc = self.encode(x, lambda i, h: instance_norm(h), train)
        h = torch.relu(enc[-1])
        for i in range(1, d):
            h = instance_norm(getattr(self, f"dconv{i}")(upsample_bilinear_2x(h),
                                                         train))
            h = torch.relu(torch.cat([h, enc[d - i - 1]], 1))
        return getattr(self, f"dconv{d}")(upsample_bilinear_2x(h), train)


def moving_region_mask(motion: Tensor) -> Tensor:
    """(B, H, W, 2) → (B, H, W, 1): 1 where the speed is at least 0.1 of the
    mean speed (reference unet_motion.py:57-61)."""
    speed = torch.linalg.vector_norm(motion, dim=-1, keepdim=True)
    small = speed < speed.mean(dim=(1, 2, 3), keepdim=True) * 0.1
    return 1.0 - small.to(motion.dtype)


def resolved_motion_model_type(opt: Options) -> str:
    """The regressor's architecture: ``model_type`` when the model is a
    motion model, else ``motion_model_type`` (the reference builds an
    embedded regressor from opts with the two swapped,
    animating_softmax_splating.py:190-193)."""
    if opt.model_type in MOTION_MODEL_TYPES:
        return opt.model_type
    return opt.motion_model_type


class MotionRegressor(nn.Module):
    """reference models/unet_motion.py (UnetMotion / SPADEUnetMaskMotion):
    the UNet as ``motion_predictor``."""

    def __init__(self, opt: Options):
        super().__init__()
        self.opt = opt
        net = (SPADEUnet4MaskMotion if "SPADE" in resolved_motion_model_type(opt)
               else Unet4Motion)
        # the image, and the mask and the hint when the options feed them
        channels_in = (3 + int(opt.use_mask_as_motion_input)
                       + 2 * int(opt.use_hint_as_motion_input))
        self.motion_predictor = net(opt, channels_in=channels_in,
                                    num_filters=opt.motion_num_filters,
                                    downs=opt.motion_unet_downs)

    def _assemble(self, image: Tensor, mask: Optional[Tensor],
                  hint: Optional[Tensor]) -> Tensor:
        parts = [image]
        if self.opt.use_mask_as_motion_input:
            parts.append(mask)
        if self.opt.use_hint_as_motion_input:
            parts.append(hint)
        return torch.cat(parts, dim=-1)

    def predict(self, image: Tensor, mask: Optional[Tensor] = None,
                hint: Optional[Tensor] = None, train: bool = False) -> Tensor:
        """forward_flow (unet_motion.py:174-190): image (B, H, W, 3), mask
        (B, H, W, 1), hint (B, H, W, 2) → the motion (B, H, W, 2) ·
        div_flow."""
        x = self._assemble(image, mask, hint).permute(0, 3, 1, 2)
        pred = self.motion_predictor(x, train).permute(0, 2, 3, 1)
        return pred * self.opt.div_flow

    def forward(self, image: Tensor, mask: Optional[Tensor] = None,
                hint: Optional[Tensor] = None, train: bool = False) -> Tensor:
        return self.predict(image, mask, hint, train)

    def forward_train(self, batch: Dict, train: bool = True,
                      deterministic: bool = False,
                      noise: Optional[torch.Generator] = None,
                      plain: bool = False):
        """The motion GAN's training pass (unet_motion.py:131-172): the
        mask from the ground-truth motion's speed, the prediction from
        ``images[0]``, the mask and ``hints`` when the batch has them.
        Returns (prediction · div_flow, pred dict). The regressor has no
        noise and no kernels: ``deterministic``, ``noise`` and ``plain``
        are the trainer's common switches and change nothing."""
        image = batch["images"][0]
        gt_motion = batch["motions"]
        mask = moving_region_mask(gt_motion)
        hint = batch.get("hints")
        pred = self.predict(image, mask, hint, train)
        pred_dict = {"PredMotion": pred / self.opt.div_flow, "GTMotion": gt_motion,
                     "InputImg": image, "MovingMask": mask}
        if hint is not None:
            pred_dict["HintMotion"] = hint
        return pred, pred_dict


def motion_losses(opt: Options, pred_scaled: Tensor, gt_motion: Tensor
                  ) -> Dict[str, Tensor]:
    """MotionLoss and the PSNR metric (unet_motion.py:158-159)."""
    ml = MotionLoss(opt.motion_losses)(pred_scaled, gt_motion)
    with torch.no_grad():  # a metric only
        ml["PSNR_motion"] = psnr(pred_scaled, gt_motion)
    return ml
