"""The port's stage-3 data and warm start against the JAX package, on the
CPU: the rock-label masks, the ``eulerian_data_balanced1_mask`` items (and
the mean video of ``eulerian_data`` when ``MVloss`` > 0), the stage-3
state_dict merge and the VGG19 harvest are equal to JAX's exactly; the
fallback loader keeps a submodule the checkpoint lacks at its initial
weights and refuses one that is only partly present."""

import os
import shutil

import numpy as np
import pytest
import torch

from slrsfs_tpu.config import Options as JaxOptions
from slrsfs_tpu.data import masks as jax_masks
from slrsfs_tpu.data.datasets import get_dataset as jax_get_dataset
from slrsfs_tpu.io import checkpoint as jax_ckpt
from slrsfs_tpu_torch.config import Options
from slrsfs_tpu_torch.data import masks
from slrsfs_tpu_torch.data.datasets import get_dataset
from slrsfs_tpu_torch.io import checkpoint
from slrsfs_tpu_torch.models.baseline import init_random_weights
from slrsfs_tpu_torch.models.slr import SLR_MODEL_TYPE, SLRModel
from slrsfs_tpu_torch.nn.vgg import _CONVS

torch.set_num_threads(1)

TINY = dict(ngf=8, W=16, out_channel=9,
            refine_model_type="resnet_TinyTest_de_resnet_pconv2_nonorm",
            alpha_refine_model_type="resnet_TinyTest_de_resnet_pconv2_nonorm",
            bg_refine_model_type="resnet_TinyTestBG_nonorm",
            model_type=SLR_MODEL_TYPE)


def test_rock_masks_match_jax(fixture_root, tmp_path):
    label = os.path.join(fixture_root, "rock_label", "00001_00000.png.json")
    for path in (label, str(tmp_path / "absent.png.json")):
        want = jax_masks.rasterize_rock_label(path, (96, 160))
        got = masks.rasterize_rock_label(path, (96, 160))
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.float32
    raw = masks.rasterize_rock_label(label, (96, 160))
    assert 0 < raw.sum() < raw.size
    rng = np.random.RandomState(4)
    for params in (None, {"crop_pos": (17, 0), "crop_size": 96, "flip": False},
                   {"crop_pos": (40, 0), "crop_size": 96, "flip": True}):
        for w in (32, 50):
            np.testing.assert_array_equal(masks.transform_mask(raw, w, params),
                                          jax_masks.transform_mask(raw, w, params))
    noisy = (rng.rand(96, 160) > 0.5).astype(np.float32)
    np.testing.assert_array_equal(
        masks.transform_mask(noisy, 40, {"crop_pos": (3, 0), "crop_size": 96, "flip": True}),
        jax_masks.transform_mask(noisy, 40, {"crop_pos": (3, 0), "crop_size": 96, "flip": True}))


@pytest.fixture(scope="module")
def shallow_root(fixture_root, tmp_path_factory):
    """The fixture scenes with a shallow-scene list naming one of them."""
    root = str(tmp_path_factory.mktemp("shallow") / "data")
    shutil.copytree(fixture_root, root)
    np.save(os.path.join(root, "imageset_shallow.npy"),
            np.array(["00002_00000"], dtype=object), allow_pickle=True)
    return root


def _items_equal(want, got):
    assert set(got) == set(want) - {"isval"}
    for v in range(3):
        np.testing.assert_array_equal(got["images"][v], want["images"][v])
    for k in set(got) - {"images"}:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("case", ["mask", "mask_shallow", "mean_only"])
def test_stage3_dataset_items_match_jax(case, fixture_root, shallow_root):
    """``eulerian_data_balanced1_mask`` (with and without a shallow list at
    balanced_weight 10) and ``eulerian_data`` with MVloss > 0 (the mean
    video alone), both splits, several indices."""
    kw = dict(W=32, dataset="eulerian_data_balanced1_mask")
    root = fixture_root
    if case == "mask_shallow":
        kw["balanced_weight"] = 10
        root = shallow_root
    elif case == "mean_only":
        kw = dict(W=32, dataset="eulerian_data", MVloss=1.0)
    jopt, opt = JaxOptions(**kw), Options(**kw)
    for split in ("train", "validation"):
        jd = jax_get_dataset(jopt, root, split=split, seed=3)
        pd = get_dataset(opt, root, split=split, seed=3)
        for ds in (jd, pd):
            (ds.totrain if split == "train" else ds.toval)(2)
        for i in range(5):
            want, got = jd[i], pd[i]
            _items_equal(want, got)
            assert "mean_video" in got
            assert ("mask_rock" in got) == (case != "mean_only")
            if "mask_rock" in got:
                assert got["mask_rock"].shape == (32, 32, 1)
    if case == "mask_shallow":
        assert pd.shallow is not None
    batch = next(pd.batches(2, num_batches=1))
    assert batch["mean_video"].shape == (2, 32, 32, 3)
    if case != "mean_only":
        assert batch["mask_rock"].shape == (2, 32, 32, 1)


def test_shallow_list_oversamples(shallow_root):
    """At balanced_weight 10 the shallow scene is drawn about 9 times in
    10 on the train split; JAX's draws are the same."""
    opt = Options(W=16, dataset="eulerian_data_balanced1_mask", balanced_weight=10)
    ds = get_dataset(opt, shallow_root, split="train", seed=0)
    jd = jax_get_dataset(JaxOptions(**{"W": 16, "dataset": "eulerian_data_balanced1_mask",
                                       "balanced_weight": 10}),
                         shallow_root, split="train", seed=0)
    scenes = [ds._pick_scene(ds._sample_rng(i)) for i in range(200)]
    assert scenes == [jd._pick_scene(jd._sample_rng(i)) for i in range(200)]
    assert scenes.count("00002_00000") > 160


def _slr_sd(seed):
    m = SLRModel(Options(**TINY))
    init_random_weights(m, seed)
    return m.state_dict()


def test_merge_stage3_state_dict_matches_jax():
    s1 = {f"model.module.{k}": v for k, v in _slr_sd(1).items()
          if not k.startswith(("net_bg", "net_alpha"))}
    s1["netD.netD.discriminator_0.model0.0.weight"] = torch.ones(2)
    bg = {f"module.{k}": v for k, v in _slr_sd(2).items()}
    for sd_bg in (None, bg):
        want = jax_ckpt.merge_stage3_state_dict(s1, sd_bg=sd_bg)
        got = checkpoint.merge_stage3_state_dict(s1, sd_bg)
        assert list(got) == list(want)
        for k in want:
            assert got[k] is want[k], k
    assert any(k.startswith("net_bg.") for k in got)
    assert not any(k.startswith("net_alpha") for k in got)


def test_import_vgg_from_checkpoint_matches_jax():
    rng = np.random.default_rng(5)
    base = "model.module.loss_function.losses.1.model."
    slices = ((1, 0, 2), (2, 2, 7), (3, 7, 12), (4, 12, 21), (5, 21, 30))
    sd, c_in = {}, 3
    for li, ch in _CONVS:
        s = next(n for n, lo, hi in slices if lo <= li < hi)
        sd[f"{base}slice{s}.{li}.weight"] = torch.from_numpy(
            rng.standard_normal((ch, c_in, 3, 3)).astype(np.float32))
        sd[f"{base}slice{s}.{li}.bias"] = torch.from_numpy(
            rng.standard_normal(ch).astype(np.float32))
        c_in = ch
    want = jax_ckpt.import_vgg_from_checkpoint(sd)["params"]
    got = checkpoint.import_vgg_from_checkpoint(sd)
    assert len(got) == 2 * len(_CONVS) == 2 * len(want)
    for li, _ in _CONVS:
        np.testing.assert_array_equal(got[f"features.{li}.weight"].numpy(),
                                      want[f"conv_{li}"]["kernel"].transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(got[f"features.{li}.bias"].numpy(),
                                      want[f"conv_{li}"]["bias"])
    assert checkpoint.import_vgg_from_checkpoint({"encoder.x": torch.zeros(1)}) is None
    assert jax_ckpt.import_vgg_from_checkpoint({"encoder.x": torch.zeros(1)}) is None


def test_fallback_loader_keeps_absent_submodules_and_refuses_partial_ones():
    src = _slr_sd(1)
    model = SLRModel(Options(**TINY))
    init_random_weights(model, 9)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    sd = {k: v for k, v in src.items() if not k.startswith("net_alpha")}
    kept = checkpoint.load_model_state_with_fallback(model, sd)
    assert sorted(kept) == ["net_alpha_decoder", "net_alpha_encoder"]
    for k, v in model.state_dict().items():
        want = init[k] if k.startswith("net_alpha") else src[k]
        assert torch.equal(v, want), k
    partial = dict(sd)
    partial.pop(next(k for k in sd if k.startswith("net_bg.")))
    with pytest.raises(KeyError, match="net_bg"):
        checkpoint.load_model_state_with_fallback(model, partial)
