"""The port's "not ported yet" errors name the ROADMAP §1 item that ports
the feature by its title, never by a number (numbers change as the
roadmap is rewritten). Each branch is driven on the CPU and its message
read."""

import argparse
import re

import pytest
import torch

from slrsfs_tpu_torch import config
from slrsfs_tpu_torch.cli import render, train
from slrsfs_tpu_torch.io import checkpoint

torch.set_num_threads(1)

TITLES = ("The rest of training", "Multi-GPU")


def _render(**kw):
    render.SceneRenderer(W=32, n_frames=2, device="cpu", **kw)


def _trainer(**kw):
    from slrsfs_tpu_torch.engine.trainer import Trainer

    Trainer(config.Options(**kw), torch.nn.Identity(), device="cpu")


def _dataset(tmp_path, variant="eulerian_data", **kw):
    from slrsfs_tpu_torch.data.datasets import LiquidDataset

    LiquidDataset(str(tmp_path), config.Options(**kw), variant=variant)


def _ff_mask_batch(tmp_path):
    from slrsfs_tpu_torch.models.baseline import BaselineTrainable

    opt = config.Options(ngf=8, W=16, out_channel=9,
                         refine_model_type="resnet_TinyTest_de_resnet_pconv2_nonorm")
    img = torch.zeros(1, 16, 16, 3)
    batch = {"images": [img, img, img], "index": torch.tensor([[0, 2, 4]]),
             "motions": torch.ones(1, 16, 16, 2), "ff_mask": torch.ones(1, 16, 16, 1)}
    BaselineTrainable(opt, train_max_steps=4).forward_train(
        batch, deterministic=True, plain=True)


def _slr_ff_mask_batch(tmp_path):
    from slrsfs_tpu_torch.models.slr import SLR_MODEL_TYPE, SLRTrainable

    opt = config.Options(
        ngf=8, W=16, out_channel=9, model_type=SLR_MODEL_TYPE,
        refine_model_type="resnet_TinyTest_de_resnet_pconv2_nonorm",
        alpha_refine_model_type="resnet_TinyTest_de_resnet_pconv2_nonorm",
        bg_refine_model_type="resnet_TinyTestBG_nonorm")
    img = torch.zeros(1, 16, 16, 3)
    batch = {"images": [img, img, img], "index": torch.tensor([[0, 2, 4]]),
             "motions": torch.ones(1, 16, 16, 2), "mask_rock": torch.zeros(1, 16, 16, 1),
             "mean_video": img, "ff_mask": torch.ones(1, 16, 16, 1)}
    SLRTrainable(opt, train_max_steps=4).forward_train(batch, deterministic=True,
                                                       plain=True)


def _synthesis_loss(name):
    from slrsfs_tpu_torch.losses.synthesis import SynthesisLoss

    SynthesisLoss([f"1.0_{name}"])


def _checkpoint(tmp_path, model_type):
    path = tmp_path / "model.pth"
    opts = argparse.Namespace(model_type=model_type)
    torch.save({"opts": opts, "state_dict": {}}, path)
    checkpoint.load_checkpoint(str(path))


BRANCHES = {
    "render --shard-frames": (lambda tmp: _render(shard_frames=True), "Multi-GPU"),
    "trainer num_accumulations": (lambda tmp: _trainer(num_accumulations=2),
                                  "The rest of training"),
    "trainer bfloat16": (lambda tmp: _trainer(train_compute_dtype="bfloat16"),
                         "The rest of training"),
    "trainer pix2pixHDorigin": (lambda tmp: _trainer(discriminator_losses="pix2pixHDorigin"),
                                "The rest of training"),
    "dataset random_ff_mask": (lambda tmp: _dataset(tmp, random_ff_mask=True),
                               "The rest of training"),
    "baseline ff_mask": (_ff_mask_batch, "The rest of training"),
    "SLR ff_mask": (_slr_ff_mask_batch, "The rest of training"),
    "synthesis style loss": (lambda tmp: _synthesis_loss("style"), "The rest of training"),
}


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_not_ported_messages_name_the_item_by_title(branch, tmp_path):
    fn, title = BRANCHES[branch]
    with pytest.raises(NotImplementedError) as err:
        fn(tmp_path)
    msg = str(err.value)
    assert title in msg and "ROADMAP" in msg, msg
    assert not re.search(r"item\s*\d", msg), msg


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
    assert "The rest of training" in train.__doc__
    assert not re.search(r"item\s*\d", train.__doc__)
    assert set(TITLES) >= {t for _, t in BRANCHES.values()}
