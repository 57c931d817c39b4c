"""The rest of the port's rollout and render API against the JAX package on
the CPU: a precomputed SLR background (``bg_img_raw`` of
``slr_rollout_sparse``, ``slr_rollout_frame_sharded`` and
``slr_rollout_dense``) and ``render_scene(shard_frames=...)``.

The SLR model is the tiny two-layer one (TinyTest archs, ngf 8) with JAX's
settled variables carried over by ``from_jax_variables``, on a 32² scene
whose bottom rows move, N = 4. Passing the model's own background is the
same computation as passing none, so the outputs are bit-equal. Another
background is held against JAX at 2e-3, the rollouts' frame tolerance
(PERF.md §2), and the port's dense rollout against its sparse one at 2e-5,
the sparse path's exactness claim (tests/test_rollout_sparse.py:184).
``render_scene(shard_frames=True)`` on this process's own 1-rank gloo
group writes the unsharded render's PNGs bit for bit."""

import dataclasses
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
from PIL import Image

import jax
import jax.numpy as jnp

from conftest import tiny_options
from slrsfs_tpu.engine import rollout as jax_rollout
from slrsfs_tpu.engine.init_utils import jit_init, settle
from slrsfs_tpu.models.slr import SLRModel as JaxSLRModel
from slrsfs_tpu_torch.cli.render import render_scene
from slrsfs_tpu_torch.config import Options
from slrsfs_tpu_torch.engine import rollout as port_rollout
from slrsfs_tpu_torch.io.convert import from_jax_variables
from slrsfs_tpu_torch.models.slr import SLR_MODEL_TYPE, SLRModel
from slrsfs_tpu_torch.parallel.mesh import make_mesh
from slrsfs_tpu_torch.utils.flow_viz import write_flo

torch.set_num_threads(1)

S, N, DB = 32, 4, 2
SLR_KW = dict(model_type=SLR_MODEL_TYPE, use_alpha0_as_blending_weight=True)


@pytest.fixture(scope="module")
def env():
    rng = np.random.default_rng(6)
    img = (rng.standard_normal((1, S, S, 3)) * 0.25).astype(np.float32)
    flow = np.zeros((S, S, 2), np.float32)
    flow[S // 2:] = rng.standard_normal((S // 2, S, 2)).astype(np.float32) * 0.8
    pos, val = jax_rollout.prepare_scene_sparse(flow, pad_multiple=64)
    jopt = tiny_options(**SLR_KW)
    jmodel = JaxSLRModel(jopt)
    variables = jit_init(jmodel, {"params": jax.random.PRNGKey(0),
                                  "noise": jax.random.PRNGKey(1)},
                         jnp.asarray(img), False, True)
    variables = settle(jmodel, variables, (jnp.asarray(img),), n=3)
    popt = Options(**dataclasses.asdict(jopt)).replace(bn_noise_misc=True)
    model = SLRModel(popt).eval()
    model.load_state_dict(from_jax_variables(jax.tree.map(np.asarray, variables), popt))
    other_bg = (rng.standard_normal((1, S, S, 3)) * 0.5).astype(np.float32)
    return dict(img=img, flow=flow, pos=pos, val=val, jmodel=jmodel,
                variables=variables, model=model, other_bg=other_bg)


def _port(env, fn, bg=None, **kw):
    t = [torch.from_numpy(env[k]) for k in ("img", "flow", "pos", "val")]
    args = t[:2] + [N] + (t[2:] if fn is port_rollout.slr_rollout_sparse else [])
    return fn(env["model"], *args, decode_batch=DB, bg_img_raw=bg, **kw)


@pytest.mark.parametrize("rollout", ["sparse", "dense"])
def test_own_background_is_bit_equal_to_none(env, rollout):
    fn = getattr(port_rollout, f"slr_rollout_{rollout}")
    with torch.no_grad():
        own = env["model"].bg(torch.from_numpy(env["img"]))
    want, got = _port(env, fn), _port(env, fn, own)
    assert set(got) == set(want) == {"PredImg", "FluidImg", "CompositeFluidAlpha",
                                     "BGImg"}
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_other_background_matches_jax(env):
    """Another background: the port's sparse rollout against JAX's (jitted)
    within 2e-3, and the port's dense rollout against its sparse one within
    2e-5; the background output is that background's tanh."""
    bg = torch.from_numpy(env["other_bg"])
    got = _port(env, port_rollout.slr_rollout_sparse, bg)
    j = [jnp.asarray(env[k]) for k in ("img", "flow", "pos", "val")]
    want = jax.jit(lambda v, b: jax_rollout.slr_rollout_sparse(
        env["jmodel"], v, j[0], j[1], N, j[2], j[3], bg_img_raw=b,
        decode_batch=DB))(env["variables"], jnp.asarray(env["other_bg"]))
    dense = _port(env, port_rollout.slr_rollout_dense, bg)
    none = _port(env, port_rollout.slr_rollout_sparse)
    for k, v in got.items():
        w = np.asarray(want[k]).reshape(v.shape)
        np.testing.assert_allclose(v.numpy(), w, rtol=2e-3, atol=2e-3, err_msg=k)
        np.testing.assert_allclose(dense[k].numpy(), v.numpy(), rtol=2e-5, atol=2e-5,
                                   err_msg=k)
    assert torch.equal(got["BGImg"], torch.tanh(bg[0]))
    assert not torch.equal(got["PredImg"], none["PredImg"])


def test_frame_sharded_rollout_takes_the_background(env):
    """``slr_rollout_frame_sharded`` passes ``bg_img_raw`` on (a 1-rank
    gloo group in this process): equal to the sparse rollout."""
    bg = torch.from_numpy(env["other_bg"])
    t = [torch.from_numpy(env[k]) for k in ("img", "flow", "pos", "val")]
    mesh = make_mesh(device="cpu")
    try:
        got = port_rollout.slr_rollout_frame_sharded(
            env["model"], t[0], t[1], N, t[2], t[3], mesh, decode_batch=DB,
            bg_img_raw=bg)
    finally:
        mesh.close()
    want = _port(env, port_rollout.slr_rollout_sparse, bg)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_render_scene_shard_frames_equals_unsharded(tmp_path):
    """Random weights from one seed, tiny decoders, 32², N = 4: the PNGs of
    ``render_scene(shard_frames=True)`` on a 1-rank group equal the
    unsharded render's, and the group it formed is gone afterwards."""
    rng = np.random.default_rng(8)
    image = str(tmp_path / "scene.png")
    Image.fromarray(rng.integers(0, 255, (40, 40, 3), dtype=np.uint8)).save(image)
    flow = np.zeros((40, 40, 2), np.float32)
    flow[20:] = rng.standard_normal((20, 40, 2)).astype(np.float32) * 2.0
    flow_path = str(tmp_path / "scene.flo")
    write_flo(flow_path, flow)
    kw = dict(W=32, n_frames=N, name="scene", device="cpu", opt_overrides=dict(
        ngf=8, out_channel=9, refine_model_type="resnet_TinyTest_de_resnet_pconv2_nonorm",
        ndf=8, num_D=1, n_layers_D=2))
    dirs = {}
    for shard in (False, True):
        dirs[shard] = render_scene(image, flow_path, str(tmp_path / f"shard{shard}"),
                                   shard_frames=shard, **kw)
        assert not dist.is_initialized()
    pngs = sorted(os.listdir(os.path.join(dirs[False], "PredImg")))
    assert len(pngs) == N
    assert sorted(os.listdir(os.path.join(dirs[True], "PredImg"))) == pngs
    for f in pngs:
        a, b = (np.asarray(Image.open(os.path.join(d, "PredImg", f))) for d in
                (dirs[True], dirs[False]))
        np.testing.assert_array_equal(a, b, err_msg=f)
