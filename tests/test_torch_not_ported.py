"""The port names a ROADMAP §1 item that ports a feature by its title,
never by a number (numbers change as the roadmap is rewritten); unknown
model types, datasets and losses are ``ValueError``s, as in JAX."""

import argparse
import re

import pytest
import torch

from slrsfs_tpu_torch import config
from slrsfs_tpu_torch.cli import render, train
from slrsfs_tpu_torch.io import checkpoint

torch.set_num_threads(1)

TITLES = ("The rest of training",)


def _render(**kw):
    render.SceneRenderer(W=32, n_frames=2, device="cpu", **kw)


def _dataset(tmp_path, variant="eulerian_data", **kw):
    from slrsfs_tpu_torch.data.datasets import LiquidDataset

    LiquidDataset(str(tmp_path), config.Options(**kw), variant=variant)


def _synthesis_loss(name):
    from slrsfs_tpu_torch.losses.synthesis import SynthesisLoss

    SynthesisLoss([f"1.0_{name}"])


def _checkpoint(tmp_path, model_type):
    path = tmp_path / "model.pth"
    opts = argparse.Namespace(model_type=model_type)
    torch.save({"opts": opts, "state_dict": {}}, path)
    checkpoint.load_checkpoint(str(path))


def test_unknown_model_types_raise_value_error(tmp_path):
    """A model type neither package knows is a ValueError, as in the JAX
    ``import_checkpoint``; a render refuses one that is not a render model
    and names the render model types; the train CLI's ``build`` refuses
    one it does not build ('motion' names no model type: the motion types
    are SPADE_unet_mask_motion and unet_motion) and names those it does."""
    with pytest.raises(ValueError, match="unknown model_type 'motion'"):
        _checkpoint(tmp_path, "motion")
    with pytest.raises(ValueError, match="softmax_splating"):
        _render(opt_overrides=dict(model_type="motion"))
    with pytest.raises(ValueError, match="unknown model_type 'motion'.*SPADE_unet_mask_motion"):
        train.build(config.Options(model_type="motion"), device="cpu")


def test_unknown_dataset_raises_value_error(tmp_path):
    """A dataset variant the reference's registry does not list is a
    ValueError, as in the JAX ``get_dataset``."""
    with pytest.raises(ValueError, match="unknown dataset 'eulerian_data_nope'"):
        _dataset(tmp_path, "eulerian_data_nope")


def test_unknown_synthesis_loss_raises_value_error():
    """A loss neither package knows is a ValueError, as in JAX's
    ``SynthesisLoss``."""
    with pytest.raises(ValueError, match="unknown synthesis loss: ssim"):
        _synthesis_loss("ssim")


def test_train_cli_names_the_item_by_title():
    assert all(t in train.__doc__ for t in TITLES)
    assert not re.search(r"item\s*\d", train.__doc__)
