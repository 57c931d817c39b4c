"""The port's train CLI on the CPU: two G+D steps on the synthetic fixture
scenes write a reference-style ``.pth`` that the JAX ``import_checkpoint``
(and ``import_discriminator``) and the port's render path both load; the
frames rendered from it by the two packages agree within 2e-3 (the
tolerance of the JAX package's own chain parity,
tests/test_forward_flow_parity.py:103).

SLR stage 3: two steps warm-started from the stage-1 run's checkpoint and a
bg checkpoint log the SLR loss set; the checkpoint loads through JAX's
``import_slr_model`` and renders alike (2e-3); the warm start takes the
fluid nets, ``net_bg``, D and the VGG19 as JAX does and leaves the alpha
nets at their initial weights; ``--init-bg-from`` alone is refused."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from slrsfs_tpu.engine import rollout as jax_rollout
from slrsfs_tpu.io.checkpoint import (
    import_checkpoint,
    import_discriminator,
    import_slr_model,
    load_torch_checkpoint,
)
from slrsfs_tpu.models.baseline import BaselineModel as JaxBaselineModel
from slrsfs_tpu.models.slr import SLRModel as JaxSLRModel
from slrsfs_tpu_torch.cli import render as port_render
from slrsfs_tpu_torch.cli import train as port_train

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def trained(fixture_root, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("train") / "run")
    ckpt = port_train.main([
        "--data-root", fixture_root, "--out", out, "--batch-size", "2",
        "--W", "32", "--ngf", "16", "--niter", "1", "--niter-decay", "0",
        "--steps-per-epoch", "2", "--val-steps", "1", "--train-max-steps", "12",
        "--device", "cpu"])
    return out, ckpt


def test_train_cli_logs_and_checkpoint(trained):
    out, ckpt = trained
    assert ckpt == os.path.join(out, "checkpoint.pth") and os.path.exists(ckpt)
    with open(os.path.join(out, "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    train = [r for r in rows if r["split"] == "train"]
    assert [r["step"] for r in train] == [1, 2]
    for r in rows:
        assert all(np.isfinite(v) for k, v in r.items() if k != "split"), r
    assert any(r["split"] == "val" and "Perceptual" in r for r in rows)
    assert os.path.exists(os.path.join(out, "options.json"))


def test_checkpoint_loads_in_jax_and_renders_alike(trained):
    _, ckpt = trained
    variables, jopt = import_checkpoint(ckpt)
    assert jopt.ngf == 16 and jopt.model_type == "softmax_splating"
    d_vars = import_discriminator(load_torch_checkpoint(ckpt)["state_dict"], jopt)
    assert set(d_vars["params"]) == {"discriminator_0", "discriminator_1"}

    r = port_render.SceneRenderer(ckpt=ckpt, W=32, n_frames=4, decode_batch=2,
                                  device="cpu")
    rng = np.random.default_rng(9)
    img = rng.uniform(-1, 1, (32, 32, 3)).astype(np.float32)
    flow = (rng.standard_normal((32, 32, 2)) * 0.9).astype(np.float32)
    flow[:12] = 0.0
    got = r.frames(img, flow).numpy()
    pos, val = jax_rollout.prepare_scene_sparse(flow)
    model = JaxBaselineModel(jopt)
    want = jax.jit(lambda v, i, f, p, va: jax_rollout.baseline_rollout_sparse(
        model, v, i, f, 4, p, va, decode_batch=2))(
        variables, jnp.asarray(img[None]), jnp.asarray(flow), jnp.asarray(pos),
        jnp.asarray(val))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-3, atol=2e-3)


def test_train_cli_refuses_other_model_types(fixture_root, tmp_path):
    """'motion' names no model type (the motion types are
    SPADE_unet_mask_motion and unet_motion): argparse refuses it."""
    with pytest.raises(SystemExit):
        port_train.main(["--data-root", fixture_root, "--out", str(tmp_path),
                         "--model-type", "motion", "--device", "cpu"])


SLR_TYPE = "softmax_splating_2layers_alpha_seperate"
SLR_LOG_KEYS = ("AlphaTV", "L1_bg", "Perceptual_bg", "FluidRegionLoss",
                "RockRegionLoss", "Alpha Decoder Consistency Loss")


@pytest.fixture(scope="module")
def bg_ckpt(tmp_path_factory):
    """A seeded stage-2 checkpoint: an SLR model's ``net_bg`` alone."""
    from slrsfs_tpu_torch.config import Options
    from slrsfs_tpu_torch.models.baseline import init_random_weights
    from slrsfs_tpu_torch.models.slr import SLRModel

    m = SLRModel(Options(ngf=16, W=32, model_type=SLR_TYPE))
    init_random_weights(m, 5)
    path = str(tmp_path_factory.mktemp("bg") / "bg.pth")
    torch.save({"state_dict": {f"model.module.{k}": v for k, v in m.state_dict().items()
                               if k.startswith("net_bg.")}}, path)
    return path


@pytest.fixture(scope="module")
def stage3(trained, bg_ckpt, fixture_root, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("stage3") / "run")
    ckpt = port_train.main([
        "--data-root", fixture_root, "--out", out, "--model-type", SLR_TYPE,
        "--init-from", trained[1], "--init-bg-from", bg_ckpt, "--batch-size", "2",
        "--W", "32", "--ngf", "16", "--niter", "1", "--niter-decay", "0",
        "--steps-per-epoch", "2", "--val-steps", "1", "--train-max-steps", "12",
        "--device", "cpu"])
    return out, ckpt


def test_stage3_cli_logs_the_slr_losses(stage3):
    out, ckpt = stage3
    with open(os.path.join(out, "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    train = [r for r in rows if r["split"] == "train"]
    assert [r["step"] for r in train] == [1, 2]
    for r in train:
        for k in SLR_LOG_KEYS + ("Total Loss", "GAN", "D_Fake"):
            assert k in r, (k, sorted(r))
    for r in rows:
        assert all(np.isfinite(v) for k, v in r.items() if k != "split"), r
    val = [r for r in rows if r["split"] == "val"]
    assert val and "Perceptual" in val[0] and "AlphaTV" not in val[0]
    with open(os.path.join(out, "options.json")) as f:
        opts = json.load(f)
    assert opts["dataset"] == "eulerian_data_balanced1_mask"
    assert opts["RockRegionloss"] == 30.0 and opts["use_alpha0_as_blending_weight"]


def test_stage3_checkpoint_loads_in_jax_and_renders_alike(stage3):
    _, ckpt = stage3
    variables, jopt = import_checkpoint(ckpt)
    assert jopt.model_type == SLR_TYPE and jopt.ngf == 16
    sd = load_torch_checkpoint(ckpt)["state_dict"]
    direct = import_slr_model(sd, jopt)
    for a, b in zip(jax.tree.leaves(direct), jax.tree.leaves(variables)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    r = port_render.SceneRenderer(ckpt=ckpt, W=32, n_frames=4, decode_batch=2,
                                  device="cpu")
    rng = np.random.default_rng(10)
    img = rng.uniform(-1, 1, (32, 32, 3)).astype(np.float32)
    flow = (rng.standard_normal((32, 32, 2)) * 0.9).astype(np.float32)
    flow[:12] = 0.0
    got = r.frames(img, flow)
    pos, val = jax_rollout.prepare_scene_sparse(flow)
    model = JaxSLRModel(jopt)
    want = jax.jit(lambda v, i, f, p, va: jax_rollout.slr_rollout_sparse(
        model, v, i, f, 4, p, va, decode_batch=2))(
        variables, jnp.asarray(img[None]), jnp.asarray(flow), jnp.asarray(pos),
        jnp.asarray(val))
    for k in ("PredImg", "FluidImg", "CompositeFluidAlpha", "BGImg"):
        g = got[k].numpy()
        assert np.isfinite(g).all(), k
        np.testing.assert_allclose(g, np.asarray(want[k]).reshape(g.shape),
                                   rtol=2e-3, atol=2e-3, err_msg=k)


def test_stage3_warm_start_takes_what_jax_takes(trained, bg_ckpt, tmp_path):
    """Fluid nets and D from the stage-1 checkpoint, net_bg from the bg
    checkpoint, the VGG19 from the loss-function slices, the alpha nets
    at their initial weights."""
    from slrsfs_tpu_torch.config import Options
    from slrsfs_tpu_torch.nn.vgg import _CONVS

    ck = torch.load(trained[1], map_location="cpu", weights_only=False)
    rng = np.random.default_rng(6)
    slices = ((1, 0, 2), (2, 2, 7), (3, 7, 12), (4, 12, 21), (5, 21, 30))
    c_in = 3
    for li, ch in _CONVS:
        s = next(n for n, lo, hi in slices if lo <= li < hi)
        key = f"model.module.loss_function.losses.1.model.slice{s}.{li}"
        ck["state_dict"][f"{key}.weight"] = torch.from_numpy(
            rng.standard_normal((ch, c_in, 3, 3)).astype(np.float32))
        ck["state_dict"][f"{key}.bias"] = torch.zeros(ch)
        c_in = ch
    s1 = str(tmp_path / "s1_with_vgg.pth")
    torch.save(ck, s1)
    opt = Options(ngf=16, W=32, model_type=SLR_TYPE, **port_train.stage_options(SLR_TYPE))
    model, tr = port_train.build(opt, train_max_steps=12, device="cpu", seed=0)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    port_train.warm_start(model, tr, s1, bg_ckpt)
    src = {k[len("model.module."):]: v for k, v in ck["state_dict"].items()
           if k.startswith("model.module.")}
    bg = {k[len("model.module."):]: v for k, v in torch.load(
        bg_ckpt, map_location="cpu", weights_only=False)["state_dict"].items()}
    for k, v in model.state_dict().items():
        want = (init[k] if k.startswith("net_alpha") else bg[k]
                if k.startswith("net_bg.") else src[k])
        assert torch.equal(v, want), k
    for k, v in tr.d_model.state_dict().items():
        assert torch.equal(v, ck["state_dict"][f"netD.netD.{k}"]), k
    w0 = tr.vgg.state_dict()["features.0.weight"]
    assert torch.equal(w0, ck["state_dict"][
        "model.module.loss_function.losses.1.model.slice1.0.weight"])


def test_train_cli_refuses_bg_without_init_from(fixture_root, tmp_path, bg_ckpt):
    with pytest.raises(SystemExit):
        port_train.main(["--data-root", fixture_root, "--out", str(tmp_path),
                         "--model-type", SLR_TYPE, "--init-bg-from", bg_ckpt,
                         "--device", "cpu"])
