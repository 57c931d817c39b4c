"""The port's render CLI and checkpoint path against the JAX package.

A reference-style ``.pth`` ({'state_dict', 'opts': Namespace}) is written
from JAX variables through ``from_jax_variables``. Loading it through the
JAX importer (``io/checkpoint.py:import_baseline_model``) must give back the
JAX variables, which proves the port's key names are the reference's; the
port's ``--ckpt`` path and the JAX CLI then render the same scene to PNGs
within one u8 level."""

import argparse
import dataclasses
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from slrsfs_tpu.engine import rollout as jax_rollout
from slrsfs_tpu.io.checkpoint import import_baseline_model
from slrsfs_tpu_torch.cli import render as port_render
from slrsfs_tpu_torch.io.convert import from_jax_variables

torch.set_num_threads(1)

SCENE = "00001_00000"


@pytest.fixture(scope="module")
def ckpt(real32_env, tmp_path_factory):
    opt = real32_env["opt"]
    sd = from_jax_variables(jax.tree.map(np.asarray, real32_env["variables"]), opt)
    # the reference's training script prefixes keys with 'model.module.'
    sd = {f"model.module.{k}": v for k, v in sd.items()}
    path = str(tmp_path_factory.mktemp("ckpt") / "model.pth")
    torch.save({"state_dict": sd, "opts": argparse.Namespace(**dataclasses.asdict(opt))},
               path)
    return path


def test_weight_round_trip(real32_env, ckpt):
    want = jax.tree.map(np.asarray, real32_env["variables"])
    sd = torch.load(ckpt, map_location="cpu", weights_only=False)["state_dict"]
    got = import_baseline_model(sd, real32_env["opt"])
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(g, w)

    # the same file through the port's --ckpt path renders the JAX frames
    r = port_render.SceneRenderer(ckpt=ckpt, W=32, n_frames=4, decode_batch=2,
                                  device="cpu")
    img = real32_env["img"][0]
    flow = (np.random.default_rng(2).standard_normal((32, 32, 2)) * 0.9
            ).astype(np.float32)
    flow[:12] = 0.0
    got_frames = r.frames(img, flow).numpy()
    pos, val = jax_rollout.prepare_scene_sparse(flow)
    model = real32_env["model"]
    want_frames = jax.jit(lambda v, i, f, p, va: jax_rollout.baseline_rollout_sparse(
        model, v, i, f, 4, p, va, decode_batch=2))(
        got, jnp.asarray(img[None]), jnp.asarray(flow), jnp.asarray(pos),
        jnp.asarray(val))
    np.testing.assert_allclose(got_frames, np.asarray(want_frames), rtol=2e-3,
                               atol=2e-3)


def test_render_cli_matches_jax_cli(fixture_root, ckpt, tmp_path):
    from slrsfs_tpu.cli.render import render_scene as jax_render_scene

    img_path = os.path.join(fixture_root, "avr_image", f"{SCENE}.png")
    flow_path = os.path.join(fixture_root, "train", f"{SCENE}_motion.npz")
    jax_dir = jax_render_scene(img_path, flow_path, str(tmp_path / "jax"),
                               ckpt=ckpt, name=SCENE, W=32, n_frames=6,
                               decode_batch=6, crop_decode="off")
    port_render.main([img_path, flow_path, str(tmp_path / "port"), "--ckpt", ckpt,
                      "--name", SCENE, "--W", "32", "--n-frames", "6",
                      "--decode-batch", "6", "--device", "cpu"])
    port_dir = str(tmp_path / "port" / SCENE)
    names = sorted(os.listdir(os.path.join(jax_dir, "PredImg")))
    assert names == sorted(os.listdir(os.path.join(port_dir, "PredImg")))
    assert len(names) == 6
    for n in names:
        a = np.asarray(Image.open(os.path.join(jax_dir, "PredImg", n)), np.int16)
        b = np.asarray(Image.open(os.path.join(port_dir, "PredImg", n)), np.int16)
        assert a.shape == b.shape == (48, 80, 3)
        assert np.abs(a - b).max() <= 1, n
    assert any(f.endswith(".mp4") for f in os.listdir(port_dir))


def test_edit_flow_matches_jax():
    from slrsfs_tpu.cli.render import edit_flow as jax_edit_flow

    flow = np.random.default_rng(0).standard_normal((5, 7, 2)).astype(np.float32)
    np.testing.assert_array_equal(port_render.edit_flow(flow, 37.0, 0.8),
                                  jax_edit_flow(flow, 37.0, 0.8))


def test_auto_decode_batch_divides_frames():
    assert port_render.auto_decode_batch(60, 256 * 256) == 60
    db = port_render.auto_decode_batch(60, 768 * 768)
    assert 60 % db == 0 and db * 768 * 768 <= port_render.DECODE_PX_BUDGET


@pytest.mark.parametrize("kw", [dict(shard_frames=True)])
def test_unported_options_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_render.SceneRenderer(W=16, n_frames=2, device="cpu", **kw)


def test_unknown_crop_decode_raises():
    with pytest.raises(ValueError, match="crop_decode"):
        port_render.SceneRenderer(W=16, n_frames=2, device="cpu",
                                  crop_decode="always")


@pytest.mark.parametrize("fmt", ["npz", "flo", "pth", "lz4"])
def test_flow_loading_matches_jax(fmt, tmp_path):
    import pickle

    from slrsfs_tpu.cli.render import _load_flow as jax_load_flow
    from slrsfs_tpu.data import lz4f
    from slrsfs_tpu.data.tensors import save_motion
    from slrsfs_tpu.utils.flow_viz import write_flo

    flow = np.random.default_rng(4).standard_normal((6, 9, 2)).astype(np.float32)
    path = str(tmp_path / f"motion.{fmt}")
    if fmt == "npz":
        save_motion(path, flow)
    elif fmt == "flo":
        write_flo(path, flow)
    elif fmt == "pth":  # reference layout (1, 2, H, W)
        torch.save(torch.from_numpy(flow.transpose(2, 0, 1)[None].copy()), path)
    else:
        if not lz4f.available():
            pytest.skip("no liblz4 on this host")
        with open(path, "wb") as f:
            f.write(lz4f.compress(pickle.dumps(
                torch.from_numpy(flow.transpose(2, 0, 1).copy()))))
    got = port_render._load_flow(path)
    np.testing.assert_array_equal(got, jax_load_flow(path))
    np.testing.assert_array_equal(got, flow)


@pytest.mark.parametrize("shape,out_w,speed", [((96, 160), 32, 1.0),
                                               ((50, 30), 64, 2.5),
                                               ((256, 256), 256, 0.5)])
def test_transform_flow_matches_jax(shape, out_w, speed):
    from slrsfs_tpu.data.transforms import transform_flow as jax_transform_flow
    from slrsfs_tpu_torch.data.transforms import transform_flow

    flow = np.random.default_rng(5).standard_normal(shape + (2,)).astype(np.float32)
    np.testing.assert_array_equal(
        transform_flow(flow, out_w, speed=speed),
        jax_transform_flow(flow, out_w, None, mode="nearest", speed=speed))
