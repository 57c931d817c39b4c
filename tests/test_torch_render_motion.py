"""Motion from hints through the port's renderer against the JAX package's,
and the port's ``warp_flow_rollout`` against JAX's.

One reference-style motion ``.pth`` (a SPADE regressor at depth 4, width
4, under ``model.module.motion_predictor.*``) is written from numpy-drawn
JAX variables through ``from_jax_variables``, beside a baseline ``.pth``
(``tests/test_torch_render.py``'s). The scene's flow moves in five
separated blobs, so both packages' k-means pick the same hints. At W = 32,
N = 4:

* the port's ``regress_motion`` (hints, then the regressor) against JAX's
  hints and regressor: within 1e-5 of max |pred|;
* the port's frames of that motion against JAX's sparse rollout of JAX's
  motion: 2e-3;
* ``SceneRenderer.render`` with ``motion_ckpt`` (``--rawsize``: the
  sparsifier at 0.5/N) against JAX's ``SceneRenderer.render``, which
  imports motion checkpoints at the reference's depth 8 only and so is
  handed the same JAX variables as its ``__init__`` would hold them: PNGs
  within one u8 level;
* the render CLI's ``--motion-ckpt`` on the CPU;
* a motion checkpoint refused as ``--ckpt`` and a render checkpoint as
  ``--motion-ckpt``, each with a ``ValueError`` that names the types.

``warp_flow_rollout`` (K1 and K2 with C1 = 4, here their plain versions)
is held at 1e-5 against JAX's on a scene with a static band and padded
rows."""

import argparse
import dataclasses
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from slrsfs_tpu.config import Options as JaxOptions
from slrsfs_tpu.data import hints as jax_hints
from slrsfs_tpu.engine import rollout as jax_rollout
from slrsfs_tpu.io.checkpoint import import_baseline_model
from slrsfs_tpu.utils.flow_viz import write_flo
from slrsfs_tpu_torch.cli import render as port_render
from slrsfs_tpu_torch.engine import rollout as port_rollout
from slrsfs_tpu_torch.io.convert import from_jax_variables
from test_torch_hints import blobs_motion
from test_torch_motion import jax_motion_variables

torch.set_num_threads(1)

W, N = 32, 4


def _save(path, sd, opt):
    torch.save({"state_dict": {f"model.module.{k}": v for k, v in sd.items()},
                "opts": argparse.Namespace(**dataclasses.asdict(opt))}, path)
    return str(path)


@pytest.fixture(scope="module")
def env(real32_env, tmp_path_factory):
    root = tmp_path_factory.mktemp("motion_render")
    jopt = JaxOptions(model_type="SPADE_unet_mask_motion", W=W, motionW=W, motionH=W,
                      motion_num_filters=4, motion_unet_downs=4)
    jreg, m_vars = jax_motion_variables(jopt, W, 11)
    motion_ckpt = _save(root / "motion.pth",
                        from_jax_variables(jax.tree.map(np.asarray, m_vars), jopt), jopt)
    base = real32_env["opt"]
    ckpt = _save(root / "model.pth", from_jax_variables(
        jax.tree.map(np.asarray, real32_env["variables"]), base), base)
    rng = np.random.default_rng(12)
    img_u8 = rng.integers(0, 256, (W, W, 3), dtype=np.uint8)
    Image.fromarray(img_u8).save(root / "scene.png")
    flow = blobs_motion(W, W, seed=3)
    write_flo(str(root / "scene.flo"), flow)
    img = (img_u8.astype(np.float32) / 255.0 - 0.5) / 0.5
    return dict(root=root, jopt=jopt, jreg=jreg, m_vars=m_vars, ckpt=ckpt,
                motion_ckpt=motion_ckpt, img=img, flow=flow,
                base_vars=import_baseline_model(
                    torch.load(ckpt, weights_only=False)["state_dict"], base),
                model=real32_env["model"])


def _jax_motion(env):
    hint, mask = jax_hints.synthesize_hint(env["flow"], n_hints=5)
    return np.asarray(jax.jit(env["jreg"].apply)(
        env["m_vars"], env["img"][None], mask[None, ..., None], hint[None]))[0]


def test_motion_from_hints_and_frames_match_jax(env):
    r = port_render.SceneRenderer(ckpt=env["ckpt"], motion_ckpt=env["motion_ckpt"],
                                  W=W, n_frames=N, decode_batch=2, device="cpu")
    got = r.regress_motion(env["img"], env["flow"])
    want = _jax_motion(env)
    assert got.shape == want.shape == (W, W, 2)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    # a random regressor moves most pixels: the render is not sparse
    assert (np.abs(want).sum(-1) > 0).mean() > 0.9
    frames = r.frames(env["img"], got).numpy()
    pos, val = jax_rollout.prepare_scene_sparse(want)
    model = env["model"]
    want_frames = jax.jit(lambda v, i, f, p, va: jax_rollout.baseline_rollout_sparse(
        model, v, i, f, N, p, va, decode_batch=2))(
        env["base_vars"], jnp.asarray(env["img"][None]), jnp.asarray(want),
        jnp.asarray(pos), jnp.asarray(val))
    np.testing.assert_allclose(frames, np.asarray(want_frames), rtol=2e-3, atol=2e-3)


def _pngs(d):
    names = sorted(os.listdir(d))
    return names, [np.asarray(Image.open(os.path.join(d, n)), np.int16) for n in names]


def test_scene_renderer_with_motion_ckpt_matches_jax(env, tmp_path):
    from slrsfs_tpu.cli.render import SceneRenderer as JaxSceneRenderer
    from slrsfs_tpu.models.motion import MotionRegressor as JaxMotionRegressor

    paths = (str(env["root"] / "scene.png"), str(env["root"] / "scene.flo"))
    jr = JaxSceneRenderer(ckpt=env["ckpt"], W=W, n_frames=N, decode_batch=2)
    # what JAX's __init__ holds after importing a depth-8 motion checkpoint
    jr.m_vars = env["m_vars"]
    jr.regressor = JaxMotionRegressor(env["jopt"])
    jr._predict_motion = jax.jit(lambda v, i, m, h: jr.regressor.apply(v, i, m, h))
    jax_dir = jr.render(*paths, str(tmp_path / "jax"), name="scene", rawsize=True)
    jr.finish()
    r = port_render.SceneRenderer(ckpt=env["ckpt"], motion_ckpt=env["motion_ckpt"],
                                  W=W, n_frames=N, decode_batch=2, device="cpu")
    port_dir = r.render(*paths, str(tmp_path / "port"), name="scene", rawsize=True)
    r.finish()
    ja, a = _pngs(os.path.join(jax_dir, "PredImg"))
    pb, b = _pngs(os.path.join(port_dir, "PredImg"))
    assert ja == pb and len(ja) == N
    for n, x, y in zip(ja, a, b):
        assert x.shape == (W, W, 3)
        assert np.abs(x - y).max() <= 1, n


def test_render_cli_motion_ckpt(env, tmp_path):
    r = port_render.main([str(env["root"] / "scene.png"), str(env["root"] / "scene.flo"),
                          str(tmp_path), "--ckpt", env["ckpt"], "--motion-ckpt",
                          env["motion_ckpt"], "--W", str(W), "--n-frames", str(N),
                          "--rawsize", "--device", "cpu"])
    assert r.regressor is not None
    assert len(os.listdir(tmp_path / "scene" / "PredImg")) == N


def test_checkpoints_of_the_wrong_kind_raise(env):
    with pytest.raises(ValueError, match="softmax_splating"):
        port_render.SceneRenderer(ckpt=env["motion_ckpt"], W=W, n_frames=N, device="cpu")
    with pytest.raises(ValueError, match="SPADE_unet_mask_motion"):
        port_render.SceneRenderer(ckpt=env["ckpt"], motion_ckpt=env["ckpt"], W=W,
                                  n_frames=N, device="cpu")


@pytest.mark.parametrize("pad", [64, 1024])
def test_warp_flow_rollout_matches_jax(pad):
    rng = np.random.default_rng(pad)
    H_, W_, n = 40, 48, 5
    img = rng.uniform(-1, 1, (1, H_, W_, 3)).astype(np.float32)
    flow = (rng.standard_normal((H_, W_, 2)) * 1.3).astype(np.float32)
    flow[:12] = 0.0
    pos, val = jax_rollout.prepare_scene_sparse(flow, pad_multiple=pad)
    want = np.asarray(jax.jit(lambda *a: jax_rollout.warp_flow_rollout(
        a[0], a[1], n, a[2], a[3]))(img, flow, pos, val))
    got = port_rollout.warp_flow_rollout(
        torch.from_numpy(img), torch.from_numpy(flow), n, torch.from_numpy(pos),
        torch.from_numpy(val)).numpy()
    assert got.shape == want.shape == (n, H_, W_, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[0], img[0], rtol=0, atol=1e-5)  # t = 0: the image
