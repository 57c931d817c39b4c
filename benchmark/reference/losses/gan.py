"""GAN objectives and the discriminator loss wrappers (PyTorch port of
``slrsfs_tpu/losses/gan.py``; reference ``models/losses/gan_loss.py``):
hinge, ls, original and wgan modes (:20-118); fake and real through the
discriminator in ONE batch (:160-172); the generator's loss is the GAN term
plus feature matching × lambda_feat / num_D (:208-235).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def _gan_scalar(x: Tensor, target_is_real: bool, for_discriminator: bool,
                mode: str) -> Tensor:
    if mode == "original":
        t = 1.0 if target_is_real else 0.0
        # binary_cross_entropy_with_logits
        return torch.mean(torch.clamp(x, min=0) - x * t
                          + torch.log1p(torch.exp(-torch.abs(x))))
    if mode == "ls":
        t = 1.0 if target_is_real else 0.0
        return torch.mean(torch.square(x - t))
    if mode == "hinge":
        if for_discriminator:
            if target_is_real:
                return -torch.mean(torch.clamp(x - 1.0, max=0.0))
            return -torch.mean(torch.clamp(-x - 1.0, max=0.0))
        if not target_is_real:
            raise ValueError("the generator's hinge loss aims for real")
        return -torch.mean(x)
    if mode != "wgan":
        raise ValueError(f"unknown gan_mode {mode!r}")
    return -torch.mean(x) if target_is_real else torch.mean(x)


def gan_loss(pred, target_is_real: bool, for_discriminator: bool,
             mode: str = "hinge") -> Tensor:
    """Multiscale list-of-lists input (gan_loss.py:102-118): the loss of
    each scale's LAST output, averaged over the scales."""
    if isinstance(pred, (list, tuple)):
        total = 0.0
        for p in pred:
            if isinstance(p, (list, tuple)):
                p = p[-1]
            total = total + _gan_scalar(p, target_is_real, for_discriminator,
                                        mode)
        return total / len(pred)
    return _gan_scalar(pred, target_is_real, for_discriminator, mode)


def discriminate(d_model, fake: Tensor, real: Tensor, train: bool
                 ) -> Tuple[List[List[Tensor]], List[List[Tensor]]]:
    """fake and real concatenated into one batch, the predictions split."""
    out = d_model(torch.cat([fake, real], dim=0), train)
    b = fake.shape[0]
    pred_fake = [[t[:b] for t in scale] for scale in out]
    pred_real = [[t[b:] for t in scale] for scale in out]
    return pred_fake, pred_real


def generator_gan_losses(d_model, fake: Tensor, real: Tensor, gan_mode: str,
                         lambda_feat: float, feat_matching: bool = True,
                         train: bool = True) -> Dict[str, Tensor]:
    """gan_loss.py:208-235; no gradient reaches the real features."""
    pred_fake, pred_real = discriminate(d_model, fake, real, train)
    out: Dict[str, Tensor] = {"GAN": gan_loss(pred_fake, True, False, gan_mode)}
    total = out["GAN"]
    if feat_matching:
        num_d = len(pred_fake)
        # 0 where the discriminator returns no intermediate features (the
        # pix2pixHD origin D)
        feat = fake.new_zeros(())
        for i in range(num_d):
            for j in range(len(pred_fake[i]) - 1):
                feat = feat + F.l1_loss(pred_fake[i][j],
                                        pred_real[i][j].detach()
                                        ) * lambda_feat / num_d
        out["GAN_Feat"] = feat
        total = total + feat
    out["Total Loss"] = total
    return out


def discriminator_losses(d_model, fake: Tensor, real: Tensor, gan_mode: str,
                         train: bool = True) -> Dict[str, Tensor]:
    """gan_loss.py:190-206; the fake is detached."""
    pred_fake, pred_real = discriminate(d_model, fake.detach(), real, train)
    out = {"D_Fake": gan_loss(pred_fake, False, True, gan_mode),
           "D_real": gan_loss(pred_real, True, True, gan_mode)}
    out["Total Loss"] = out["D_Fake"] + out["D_real"]
    return out
