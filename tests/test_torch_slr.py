"""The port's SLR two-layer model and the v2 Z-norm against the JAX package
on the same inputs and weights (real reference archs at ngf=16, 32², N=4;
JAX variables initialised and settled as tests/test_slr.py does, carried
over by ``from_jax_variables``).

JAX's jitted init of the full SLR graph takes minutes to compile on one
CPU, so the variables are drawn with numpy into the shapes ``jax.eval_shape``
gives (LeCun-normal kernels, zero biases, unit BN variance, random spectral
vectors) and then settled by the JAX package's own ``settle`` (train-mode
passes: power iterations and BN statistics).

* SLRModel pieces: encoders at 1e-4, decoders at 2e-3 (conv summation
  order, tests/test_torch_nn.py);
* sparse SLR rollouts, v2 off and on, and the baseline's v2 rollouts: 2e-3
  on every output;
* port sparse vs port dense SLR: 2e-5, the JAX package's own oracle
  (tests/test_slr.py:154-156);
* K2's SLR epilogue (plain) vs the JAX splat + ``slr_unpack_splatted``:
  1e-5 with the same exact zeros;
* the weight bridge: a reference-style SLR ``.pth`` written from the port's
  state_dict loads into JAX as the same variables, and the port's CLI
  renders the JAX CLI's PNGs within one u8 level."""

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
from slrsfs_tpu.engine import rollout as jax_rollout
from slrsfs_tpu.engine.init_utils import settle
from slrsfs_tpu.models.slr import SLRModel as JaxSLRModel
from slrsfs_tpu.models.slr import slr_unpack_splatted as jax_unpack
from slrsfs_tpu.ops.euler import euler_integrate_compact_dual
from slrsfs_tpu.ops.splat import softsplat_sum_at_quad_dual
from slrsfs_tpu_torch import kernels
from slrsfs_tpu_torch.cli import render as port_render
from slrsfs_tpu_torch.config import Options
from slrsfs_tpu_torch.engine import rollout as port_rollout
from slrsfs_tpu_torch.io.convert import from_jax_variables
from slrsfs_tpu_torch.models.baseline import BaselineModel
from slrsfs_tpu_torch.models.slr import SLR_MODEL_TYPE, SLRModel
from slrsfs_tpu_torch.ops import splat as port_splat

torch.set_num_threads(1)

N = 4
DB = 2
SCENE = "00001_00000"
OUT_KEYS = ("PredImg", "FluidImg", "CompositeFluidAlpha", "BGImg")


def _opts(**kw):
    base = dict(ngf=16, W=32, model_type=SLR_MODEL_TYPE,
                use_alpha0_as_blending_weight=True, **kw)
    return JaxOptions(**base), Options(bn_noise_misc=True, **base)


def _numpy_init(model, img, seed):
    shapes = jax.eval_shape(
        lambda r, i: model.init(r, i, False, True),
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jax.ShapeDtypeStruct(img.shape, img.dtype))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            a = rng.standard_normal(leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
        elif name in ("u", "v"):
            a = rng.standard_normal(leaf.shape)
            a /= np.linalg.norm(a)
        elif name == "stored_var":
            a = np.ones(leaf.shape)
        else:
            a = np.zeros(leaf.shape)
        return jnp.asarray(a, leaf.dtype)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def env():
    rng = np.random.default_rng(21)
    jopt, popt = _opts()
    jmodel = JaxSLRModel(jopt)
    img = (rng.standard_normal((1, 32, 32, 3)) * 0.25).astype(np.float32)
    variables = settle(jmodel, _numpy_init(jmodel, img, seed=0),
                       (jnp.asarray(img),), n=8)
    sd = from_jax_variables(jax.tree.map(np.asarray, variables), popt)
    flow = rng.standard_normal((32, 32, 2)).astype(np.float32)
    flow[:16] = 0.0
    flow[:, :6] = 0.0
    pos, valid = jax_rollout.prepare_scene_sparse(flow, pad_multiple=64)
    region = np.zeros((1, 32, 32, 1), np.float32)
    region[:, 8:28, 4:20] = 1.0

    def port_model(**kw):
        m = SLRModel(_opts(**kw)[1]).eval()
        m.load_state_dict(sd)
        return m

    return dict(jopt=jopt, jmodel=jmodel, variables=variables, sd=sd,
                port_model=port_model, model=port_model(), img=img,
                flow=flow, pos=pos, valid=valid, region=region)


def _jax_sparse(env, v2=False, region=None, dtype=jnp.float32,
                splat_dtype=None):
    model = JaxSLRModel(_opts(use_softmax_splatter_v2=v2)[0])
    out = jax.jit(lambda v, i, f, p, va, rg: jax_rollout.slr_rollout_sparse(
        model, v, i, f, N, p, va, alpha_region=rg, decode_batch=DB,
        compute_dtype=dtype, splat_dtype=splat_dtype))(
        env["variables"], jnp.asarray(env["img"]), jnp.asarray(env["flow"]),
        jnp.asarray(env["pos"]), jnp.asarray(env["valid"]),
        None if region is None else jnp.asarray(region))
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


def _port_sparse(env, model, region=None, dtype=torch.float32,
                 splat_dtype=torch.float32):
    out = port_rollout.slr_rollout_sparse(
        model, torch.from_numpy(env["img"]), torch.from_numpy(env["flow"]), N,
        torch.from_numpy(env["pos"]), torch.from_numpy(env["valid"]),
        alpha_region=None if region is None else torch.from_numpy(region),
        decode_batch=DB, compute_dtype=dtype, splat_dtype=splat_dtype)
    return {k: v.numpy() for k, v in out.items()}


def _jax_apply(env, method, *args):
    jm = env["jmodel"]
    return jax.jit(lambda v, *a: jm.apply(v, *a, method=method))(
        env["variables"], *map(jnp.asarray, args))


@pytest.mark.parametrize("piece", ["encode", "bg", "alpha_encode",
                                   "decode_fluid", "decode_alpha"])
def test_model_pieces_match_jax(env, piece):
    model, img = env["model"], env["img"]
    fs = np.array(_jax_apply(env, "encode", img)[0])
    # splat holes: whole pixels at exactly 0 (the pconv mask)
    fs[0, 5:9, 3:20] = 0.0
    af = np.random.default_rng(3).standard_normal((1, 32, 32, 1)).astype(np.float32)
    af[0, 5:9, 3:20] = 0.0
    want = {"encode": lambda: _jax_apply(env, "encode", img),
            "bg": lambda: (_jax_apply(env, "bg", img),),
            "alpha_encode": lambda: _jax_apply(env, "alpha_encode", img),
            "decode_fluid": lambda: (_jax_apply(env, "decode_fluid", fs),),
            "decode_alpha": lambda: (_jax_apply(env, "decode_alpha", fs, af),)
            }[piece]()
    t = torch.from_numpy
    with torch.no_grad():
        got = {"encode": lambda: model.encode(t(img)),
               "bg": lambda: (model.bg(t(img)),),
               "alpha_encode": lambda: model.alpha_encode(t(img)),
               "decode_fluid": lambda: (model.decode_fluid(t(fs)),),
               "decode_alpha": lambda: (model.decode_alpha(t(fs), t(af)),)
               }[piece]()
    tol = 1e-4 if piece in ("encode", "alpha_encode") else 2e-3
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=tol, atol=tol)


@pytest.mark.parametrize("v2", [False, True])
def test_sparse_rollout_matches_jax(env, v2):
    region = None if v2 else env["region"]
    want = _jax_sparse(env, v2=v2, region=region)
    got = _port_sparse(env, env["port_model"](use_softmax_splatter_v2=v2),
                       region=region)
    assert set(got) == set(want) == set(OUT_KEYS)
    for k in OUT_KEYS:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=2e-3, atol=2e-3,
                                   err_msg=k)


@pytest.mark.parametrize("v2", [False, True])
def test_sparse_equals_dense(env, v2):
    model = env["port_model"](use_softmax_splatter_v2=v2)
    sparse = _port_sparse(env, model, region=env["region"])
    dense = port_rollout.slr_rollout_dense(
        model, torch.from_numpy(env["img"]), torch.from_numpy(env["flow"]), N,
        alpha_region=torch.from_numpy(env["region"]), decode_batch=DB)
    for k in OUT_KEYS:
        np.testing.assert_allclose(sparse[k], dense[k].numpy(), rtol=2e-5,
                                   atol=2e-5, err_msg=k)


def test_bf16_render_is_finite_and_near_jax_bf16(env):
    """bf16 casts the five sub-networks; its distance to JAX f32 stays
    within twice the distance JAX's own bf16 mode shows."""
    got = _port_sparse(env, env["model"], dtype=torch.bfloat16)
    want32 = _jax_sparse(env)
    want16 = _jax_sparse(env, dtype=jnp.bfloat16)
    for k in OUT_KEYS:
        assert np.isfinite(got[k]).all(), k
    jax_delta = np.abs(want16["PredImg"] - want32["PredImg"]).max()
    port_delta = np.abs(got["PredImg"] - want32["PredImg"]).max()
    assert jax_delta > 0.0
    assert port_delta <= 2.0 * jax_delta, (port_delta, jax_delta)


@pytest.mark.parametrize("v2", [False, True])
def test_bf16_fast_rollout_matches_jax(env, v2):
    """The bfloat16-fast mode (bf16 sub-networks and bf16 splat
    accumulation) against JAX's at compute_dtype = splat_dtype = bfloat16:
    every output within 2e-2, the JAX package's bound for the mode
    (tests/test_rollout_sparse.py:88)."""
    region = env["region"] if v2 else None
    want = _jax_sparse(env, v2=v2, region=region, dtype=jnp.bfloat16,
                       splat_dtype=jnp.bfloat16)
    got = _port_sparse(env, env["port_model"](use_softmax_splatter_v2=v2),
                       region=region, dtype=torch.bfloat16,
                       splat_dtype=torch.bfloat16)
    for k in OUT_KEYS:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=2e-2,
                                   err_msg=k)


@pytest.mark.parametrize("dense", [False, True])
def test_baseline_v2_matches_jax(real32_env, dense):
    rng = np.random.default_rng(11)
    flow = (rng.standard_normal((32, 32, 2)) * 1.2).astype(np.float32)
    flow[:16] = 0.0
    pos, valid = jax_rollout.prepare_scene_sparse(flow, pad_multiple=64)
    jopt = real32_env["opt"].replace(use_softmax_splatter_v2=True)
    jmodel = type(real32_env["model"])(jopt)
    popt = Options(ngf=16, W=32, use_softmax_splatter_v2=True, bn_noise_misc=True)
    model = BaselineModel(popt).eval()
    model.load_state_dict(from_jax_variables(
        jax.tree.map(np.asarray, real32_env["variables"]), popt))
    img = real32_env["img"]
    if dense:
        want = jax.jit(lambda v, i, f: jax_rollout.baseline_rollout(
            jmodel, v, i, f, N))(real32_env["variables"], jnp.asarray(img),
                                 jnp.asarray(flow))
        got = port_rollout.baseline_rollout(model, torch.from_numpy(img),
                                            torch.from_numpy(flow), N)
    else:
        want = jax.jit(lambda v, i, f, p, va: jax_rollout.baseline_rollout_sparse(
            jmodel, v, i, f, N, p, va, decode_batch=DB))(
            real32_env["variables"], jnp.asarray(img), jnp.asarray(flow),
            jnp.asarray(pos), jnp.asarray(valid))
        got = port_rollout.baseline_rollout_sparse(
            model, torch.from_numpy(img), torch.from_numpy(flow), N,
            torch.from_numpy(pos), torch.from_numpy(valid), decode_batch=DB)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-3)


def _slr_splat_inputs(case: str):
    H, W = 24, 20
    rng = np.random.default_rng(2)
    motion = (rng.standard_normal((H, W, 2)) * 1.3).astype(np.float32)
    motion[: H // 3] = 0.0
    positions, valid = port_rollout.prepare_scene_sparse(motion, pad_multiple=64)
    ez = np.exp(-rng.uniform(0, 3, (H, W, 1))).astype(np.float32)
    ec = np.exp(rng.uniform(0, 1, (H, W, 1))).astype(np.float32)
    u = np.concatenate([rng.standard_normal((H, W, 8)).astype(np.float32) * ez,
                        rng.standard_normal((H, W, 1)).astype(np.float32) * ec,
                        ec, ez], -1)  # [fs·e^Z, af·e^C, e^C, e^Z]
    static = np.all(motion == 0, axis=-1).astype(np.float32)
    disp_f, disp_b = euler_integrate_compact_dual(motion, positions, 5, 6)
    da, db = np.array(disp_f[3]), np.array(disp_b[3])
    if case == "sentinel_integer_border":
        da[0::3] = max(H, W) + 1
        da[1::3] = [3.0, -2.0]
        da[2::3] = [-0.75, -5.5]
    return (u[positions[:, 1], positions[:, 0]] * valid[:, None], positions,
            valid, da, db, u * static[..., None])


@pytest.mark.parametrize("case", ["trajectory", "sentinel_integer_border"])
def test_k2_slr_epilogue_matches_jax(case):
    u_mov, positions, valid, da, db, u_static = _slr_splat_inputs(case)
    H, W = u_static.shape[:2]
    a, b = np.float32(0.6), np.float32(1.0) - np.float32(0.6)
    g = softsplat_sum_at_quad_dual(u_mov, positions, da, db, a, b, H, W)
    fs, af = jax_unpack(np.asarray(g + u_static, np.float32), True)
    want = np.concatenate([np.asarray(fs), np.asarray(af)], -1)
    args = [*map(torch.from_numpy, (u_mov, positions, valid, da, db)),
            float(a), float(b), torch.from_numpy(u_static)]
    got = port_splat.splat_dual_normalize_slr_plain(*args, torch.float32).numpy()
    assert got.shape == (H, W, u_mov.shape[1] - 2)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got == 0, want == 0)

    kernels.reset_counts()
    out = torch.empty((H, W, u_mov.shape[1] - 2), dtype=torch.bfloat16)
    port_splat.splat_dual_normalize_slr(*args, out=out)
    np.testing.assert_allclose(out.float().numpy(), want, rtol=2 ** -8, atol=1e-5)
    assert kernels.counts()["splat_dual_normalize_slr"] == 0


def test_gaussian_blur_region_matches_jax():
    mask = np.zeros((1, 100, 100, 1), np.float32)
    mask[:, 20:70, 10:50] = 1.0
    want = jax_rollout.gaussian_blur_region(jnp.asarray(mask), 100)
    got = port_rollout.gaussian_blur_region(torch.from_numpy(mask), 100)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.fixture(scope="module")
def slr_ckpt(env, tmp_path_factory):
    sd = {f"model.module.{k}": v for k, v in env["sd"].items()}
    path = str(tmp_path_factory.mktemp("slr_ckpt") / "model.pth")
    torch.save({"state_dict": sd, "opts": argparse.Namespace(
        **dataclasses.asdict(env["jopt"]))}, path)
    return path


def test_weight_round_trip(env, slr_ckpt):
    from slrsfs_tpu.io.checkpoint import import_slr_model

    want = jax.tree.map(np.asarray, env["variables"])
    sd = torch.load(slr_ckpt, map_location="cpu", weights_only=False)["state_dict"]
    got = import_slr_model(sd, env["jopt"])
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(g, w)
    # the reference's child names
    for k in ("net_bg.eblocks.1.ch_b.0.weight_orig",
              "net_alpha_encoder.gblocks.7.ch_a.5.weight_u",
              "net_alpha_decoder.eblocks.0.bn_noise1.pbn.stored_mean"):
        assert f"model.module.{k}" in sd, k


def test_render_cli_matches_jax_cli(fixture_root, slr_ckpt, tmp_path):
    from slrsfs_tpu.cli.render import render_scene as jax_render_scene

    img_path = os.path.join(fixture_root, "avr_image", f"{SCENE}.png")
    flow_path = os.path.join(fixture_root, "train", f"{SCENE}_motion.npz")
    region = np.zeros((96, 160), np.uint8)
    region[30:90, 20:120] = 255
    region_path = str(tmp_path / "region.png")
    Image.fromarray(region).save(region_path)
    jax_dir = jax_render_scene(img_path, flow_path, str(tmp_path / "jax"),
                               ckpt=slr_ckpt, name=SCENE, W=32, n_frames=4,
                               decode_batch=4, crop_decode="off",
                               alpha_region_path=region_path)
    port_render.main([img_path, flow_path, str(tmp_path / "port"), "--ckpt",
                      slr_ckpt, "--name", SCENE, "--W", "32", "--n-frames", "4",
                      "--decode-batch", "4", "--alpha-region", region_path,
                      "--device", "cpu"])
    port_dir = str(tmp_path / "port" / SCENE)
    for key in OUT_KEYS[:3]:
        names = sorted(os.listdir(os.path.join(jax_dir, key)))
        assert names == sorted(os.listdir(os.path.join(port_dir, key))), key
        assert len(names) == 4
        for n in names:
            a = np.asarray(Image.open(os.path.join(jax_dir, key, n)), np.int16)
            b = np.asarray(Image.open(os.path.join(port_dir, key, n)), np.int16)
            assert a.shape == b.shape == (48, 80, 3)
            assert np.abs(a - b).max() <= 1, (key, n)
        assert os.path.exists(os.path.join(port_dir, f"{key}_{SCENE}.mp4"))
    a = np.asarray(Image.open(os.path.join(jax_dir, "BGImg.png")), np.int16)
    b = np.asarray(Image.open(os.path.join(port_dir, "BGImg.png")), np.int16)
    assert np.abs(a - b).max() <= 1


def test_slr_decode_budget():
    assert port_render.auto_decode_batch(60, 256 * 256, slr=True) == 60
    db = port_render.auto_decode_batch(60, 768 * 768, slr=True)
    assert 60 % db == 0 and db * 768 * 768 <= port_render.DECODE_PX_BUDGET_SLR
    assert port_render.DECODE_PX_BUDGET_SLR <= port_render.DECODE_PX_BUDGET
