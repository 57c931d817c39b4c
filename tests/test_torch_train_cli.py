"""The port's train CLI on the CPU: two G+D steps on the synthetic fixture
scenes write a reference-style ``.pth`` that the JAX ``import_checkpoint``
(and ``import_discriminator``) and the port's render path both load; the
frames rendered from it by the two packages agree within 2e-3 (the
tolerance of the JAX package's own chain parity,
tests/test_forward_flow_parity.py:103)."""

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
    load_torch_checkpoint,
)
from slrsfs_tpu.models.baseline import BaselineModel as JaxBaselineModel
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
    with pytest.raises(SystemExit):
        port_train.main(["--data-root", fixture_root, "--out", str(tmp_path),
                         "--model-type", "bg", "--device", "cpu"])
