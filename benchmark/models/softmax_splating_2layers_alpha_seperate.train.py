"""Training cells of ``model_type=softmax_splating_2layers_alpha_seperate``,
SLR stage 3: the fluid, alpha and background nets on both sides, the SLR
loss set, and the rock mask and mean video each sample carries."""

from __future__ import annotations

import numpy as np

from benchmark import generate
from benchmark.reference.models.slr import SLRTrainable, slr_extra_losses

reference_extra_losses = slr_extra_losses


def reference_g(opt, train_max_steps: int):
    """The reference generator, on the CPU, its weights not yet set."""
    return SLRTrainable(opt, train_max_steps=train_max_steps)


def port_g(popt, train_max_steps: int):
    """(the program's generator, its SLR losses), as ``cli/train.py:build``
    makes them."""
    from slrsfs_tpu_torch.models.slr import SLRTrainable as PortTrainable
    from slrsfs_tpu_torch.models.slr import slr_extra_losses as port_losses

    return PortTrainable(popt, train_max_steps=train_max_steps), port_losses


def batch_extras(rng, batch_size: int, size: int):
    """A rock mask (one polygon over about a quarter of the frame, as
    ``chip_smoke.py:make_slr_batch``) and a mean video at N(0, 0.25)."""
    mask = generate.rock_mask(size)[None, ..., None]
    return {"mask_rock": np.repeat(mask, batch_size, axis=0),
            "mean_video": (rng.standard_normal((batch_size, size, size, 3)) * 0.25
                           ).astype(np.float32)}
