"""Training cells of ``model_type=softmax_splating``, stage 1: the
reference's generator and the program's, and no inputs beyond the
common batch."""

from __future__ import annotations

from benchmark.reference.models.baseline import BaselineTrainable

# the reference's losses beyond synthesis and GAN: none
reference_extra_losses = None


def reference_g(opt, train_max_steps: int):
    """The reference generator, on the CPU, its weights not yet set."""
    return BaselineTrainable(opt, train_max_steps=train_max_steps)


def port_g(popt, train_max_steps: int):
    """(the program's generator, its losses beyond synthesis and GAN or
    None), as ``cli/train.py:build`` makes them."""
    from slrsfs_tpu_torch.models.baseline import BaselineTrainable as PortTrainable

    return PortTrainable(popt, train_max_steps=train_max_steps), None


def batch_extras(rng, batch_size: int, size: int):
    """Inputs a batch holds beyond images, indices and motions: none."""
    return {}
