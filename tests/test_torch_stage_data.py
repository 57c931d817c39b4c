"""The stages' data and checkpoints against the JAX package.

* The four dataset variants the bg, motion and embedded-motion stages read
  (``eulerian_data_bg``, ``eulerian_data_hint``,
  ``eulerian_data_mask_hint``, ``eulerian_data_motion_hint`` with and
  without online hints) on a fixture whose hint files the port's
  ``utils/flow_viz.write_flo`` wrote: every item equal to JAX's bit for
  bit, on the train and validation splits (the fixture's motion is one
  velocity, so the online hints do not depend on the clustering), and the
  collated batches' shapes (two views, one view).
* ``write_flo`` round trips through both packages' ``read_flo``.
* ``data/hints.py:synthesize_hint_online`` against JAX's on five separated
  blobs of distinct velocities, for seeds that draw k = 5 and k = 1 (a
  unique optimum, so the port's k-means, whose random stream is not
  scikit-learn's, finds scikit-learn's centroids): within 1e-6, the
  tolerance of tests/test_torch_hints.py; the draws of k and σ are JAX's.
* The checkpoints: ``save_checkpoint`` of the embedded-motion model (its
  regressor at the reference's depth 8) read by JAX's
  ``import_embedded_baseline`` and of the background model by
  ``import_bg_model`` give back the port's weights; ``merge_stage3_state_dict``
  with a motion checkpoint equals JAX's; ``load_embedded_baseline`` takes
  the regressor from merged keys and keeps it at its initial weights
  without them, as JAX's import does with a fallback, and refuses a
  partial regressor; ``load_checkpoint`` reads a bg checkpoint."""

import argparse
import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

import torch_stage_parity as P
from slrsfs_tpu.config import Options as JaxOptions
from slrsfs_tpu.data import hints as jhints
from slrsfs_tpu.data.datasets import get_dataset as jax_get_dataset
from slrsfs_tpu.io import checkpoint as jckpt
from slrsfs_tpu.utils.flow_viz import read_flo as jax_read_flo
from slrsfs_tpu_torch.config import Options
from slrsfs_tpu_torch.data import hints as phints
from slrsfs_tpu_torch.data.datasets import get_dataset
from slrsfs_tpu_torch.io import checkpoint as pckpt
from slrsfs_tpu_torch.io.convert import from_jax_variables
from slrsfs_tpu_torch.models.baseline import BaselineMotionTrainable, init_random_weights
from slrsfs_tpu_torch.models.slr import BackgroundModel
from slrsfs_tpu_torch.utils.flow_viz import read_flo, write_flo

torch.set_num_threads(1)

TINY = dict(ngf=8, out_channel=9, refine_model_type="resnet_TinyTest_de_resnet_pconv2_nonorm",
            bg_refine_model_type="resnet_TinyTestBG_nonorm")


@pytest.fixture(scope="module")
def hint_root(fixture_root, tmp_path_factory):
    """The shared fixture with its hint files rewritten by the port's
    ``write_flo``: a varying field, not the motion's half."""
    root = str(tmp_path_factory.mktemp("hint_data") / "data")
    shutil.copytree(fixture_root, root)
    rng = np.random.default_rng(8)
    for split in ("train", "validation"):
        for name in os.listdir(os.path.join(root, split)):
            if name.endswith("_sparse_motion.flo"):
                h, w = read_flo(os.path.join(root, split, name)).shape[:2]
                write_flo(os.path.join(root, split, name),
                          (rng.standard_normal((h, w, 2)) * 0.7).astype(np.float32))
    return root


def test_write_flo_round_trips_through_both_readers(tmp_path):
    flow = np.random.default_rng(1).standard_normal((5, 7, 2)).astype(np.float32)
    path = str(tmp_path / "f.flo")
    write_flo(path, flow)
    np.testing.assert_array_equal(read_flo(path), flow)
    np.testing.assert_array_equal(jax_read_flo(path), flow)
    with pytest.raises(ValueError, match=r"\(H, W, 2\)"):
        write_flo(path, flow[..., :1])


VARIANT_CASES = {
    "bg": ("eulerian_data_bg", dict(MVloss=1.0), 2),
    "hint": ("eulerian_data_hint", {}, 3),
    "mask_hint": ("eulerian_data_mask_hint", {}, 3),
    "motion_hint_online": ("eulerian_data_motion_hint", dict(use_online_hint=True), 1),
    "motion_hint_flo": ("eulerian_data_motion_hint", {}, 1),
}


@pytest.mark.parametrize("case", sorted(VARIANT_CASES))
def test_dataset_variants_match_jax(case, hint_root):
    variant, kw, views = VARIANT_CASES[case]
    jopt = JaxOptions(W=32, dataset=variant, **kw)
    opt = Options(**dataclasses.asdict(jopt))
    jd = jax_get_dataset(jopt, hint_root, split="train", seed=3)
    pd = get_dataset(opt, hint_root, split="train", seed=3)
    for split in ("train", "validation"):
        for ds in (jd, pd):
            (ds.totrain if split == "train" else ds.toval)(1)
        for i in range(3):
            want, got = jd[i], pd[i]
            assert set(got) == set(want) - {"isval"}, (sorted(got), sorted(want))
            assert len(got["images"]) == len(want["images"]) == views
            for v in range(views):
                np.testing.assert_array_equal(got["images"][v], want["images"][v])
            for k in set(want) - {"images", "isval"}:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            if variant == "eulerian_data_bg":
                assert got["index"][1] == got["index"][2]  # middle = end
            if "hints" in got:
                assert np.abs(got["hints"]).max() > 0
    batch = next(pd.batches(2, num_batches=1))
    assert len(batch["images"]) == views and batch["images"][0].shape == (2, 32, 32, 3)


def _blobs():
    """Five separated blobs of distinct velocities on a 64x80 field."""
    m = np.zeros((64, 80, 2), np.float32)
    for i, (y, x, r) in enumerate([(8, 10, 5), (10, 60, 6), (32, 36, 5), (52, 12, 7),
                                   (54, 66, 6)]):
        yy, xx = np.mgrid[:64, :80]
        inside = (yy - y) ** 2 + (xx - x) ** 2 <= r * r
        m[inside] = [0.5 + 0.3 * i, -0.4 + 0.2 * i]
    return m


def _seeds(k, n=2):
    return [s for s in range(200) if 1 + np.random.default_rng(s).integers(5) == k][:n]


@pytest.mark.parametrize("seed", _seeds(5) + _seeds(1))
def test_synthesize_hint_online_matches_jax(seed):
    motion = _blobs()
    want_h, want_m = jhints.synthesize_hint_online(motion, np.random.default_rng(seed))
    got_h, got_m = phints.synthesize_hint_online(torch.from_numpy(motion),
                                                 np.random.default_rng(seed))
    np.testing.assert_array_equal(got_m.numpy(), want_m)
    np.testing.assert_allclose(got_h.numpy(), want_h, rtol=0, atol=1e-6)
    assert np.abs(want_h).max() > 0


def test_synthesize_hint_online_few_moving_pixels():
    motion = np.zeros((16, 16, 2), np.float32)
    motion[3, 4:9] = 1.0  # 5 moving pixels, fewer than 10
    h, m = phints.synthesize_hint_online(torch.from_numpy(motion), np.random.default_rng(0))
    assert float(h.abs().max()) == 0.0 and float(m.sum()) == 5.0


def _embedded(seed):
    opt = Options(W=32, train_motion=True, motion_num_filters=2, **TINY)
    model = BaselineMotionTrainable(opt, train_max_steps=4)
    init_random_weights(model, seed)
    return opt, model


def _port_sd(variables, opt, model):
    return from_jax_variables(P.np_tree(variables), opt, model)


def test_embedded_checkpoint_reads_back_in_jax(tmp_path):
    opt, model = _embedded(1)
    path = str(tmp_path / "embedded.pth")
    pckpt.save_checkpoint(path, model, torch.nn.Linear(1, 1), opt)
    sd = jckpt.load_torch_checkpoint(path)["state_dict"]
    variables = jckpt.import_embedded_baseline(sd, JaxOptions(**dataclasses.asdict(opt)))
    back = _port_sd(variables, opt, model)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(back[k].numpy(), v.numpy(), err_msg=k)


def test_embedded_warm_start_rule_matches_jax():
    opt, base = _embedded(2)
    _, motion_src = _embedded(3)
    _, init = _embedded(4)
    head = "motion_regressor."
    sd_base = {f"model.module.{k}": v for k, v in base.state_dict().items()
               if not k.startswith(head)}
    sd_motion = {f"model.module.{k[len(head):]}": v
                 for k, v in motion_src.state_dict().items() if k.startswith(head)}
    jopt = JaxOptions(**dataclasses.asdict(opt))
    # JAX's fallback: the regressor's initial weights, as variables
    init_reg = jckpt.import_motion_model(
        {k: v for k, v in init.state_dict().items() if k.startswith(head)},
        jopt.replace(model_type=jopt.motion_model_type))
    fallback = {c: {"motion_regressor": t} for c, t in init_reg.items()}
    for motion in (sd_motion, None):
        merged = pckpt.merge_stage3_state_dict(sd_base, sd_motion=motion)
        jmerged = jckpt.merge_stage3_state_dict(sd_base, sd_motion=motion)
        assert set(merged) == set(jmerged)
        for k in merged:
            assert torch.equal(merged[k], jmerged[k]), k
        model = BaselineMotionTrainable(opt, train_max_steps=4)
        model.load_state_dict(init.state_dict())
        loaded = pckpt.load_embedded_baseline(model, pckpt.clean_state_dict(merged))
        assert loaded == (motion is not None)
        variables = jckpt.import_embedded_baseline(merged, jopt, fallback=fallback)
        back = _port_sd(variables, opt, model)
        want_reg = motion_src if motion is not None else init
        for k, v in model.state_dict().items():
            np.testing.assert_array_equal(back[k].numpy(), v.numpy(), err_msg=k)
            want = want_reg if k.startswith(head) else base
            assert torch.equal(v, want.state_dict()[k]), k
    partial = pckpt.merge_stage3_state_dict(sd_base, sd_motion=dict(
        list(sd_motion.items())[:3]))
    with pytest.raises(KeyError, match="part of motion_regressor"):
        pckpt.load_embedded_baseline(BaselineMotionTrainable(opt, train_max_steps=4),
                                     pckpt.clean_state_dict(partial))


def test_bg_checkpoint_reads_back_in_both(tmp_path):
    opt = Options(W=32, model_type="bg", MVloss=1.0, **TINY)
    model = BackgroundModel(opt)
    init_random_weights(model, 5)
    path = str(tmp_path / "bg.pth")
    pckpt.save_checkpoint(path, model, torch.nn.Linear(1, 1), opt)
    variables, jopt = jckpt.import_checkpoint(path)
    assert jopt.model_type == "bg"
    direct = jckpt.import_bg_model(jckpt.load_torch_checkpoint(path)["state_dict"], jopt)
    back = _port_sd(direct, opt, model)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(back[k].numpy(), v.numpy(), err_msg=k)
    sd, popt = pckpt.load_checkpoint(path)
    assert popt.model_type == "bg" and set(sd) >= set(model.state_dict())
    ns = argparse.Namespace(**dataclasses.asdict(opt))
    assert pckpt.opts_from_namespace(ns).model_type == "bg"
