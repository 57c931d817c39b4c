"""The port's frame-sharded renders on two gloo ranks against the port's
single-process sparse rollouts and JAX's ``*_frame_sharded`` rollouts on a
2-device ``make_mesh(2)``, on the same weights (JAX variables carried over
by ``from_jax_variables``; the tiny UPDOWN decoders of
``tests/test_torch_crop.py``), a 64 x 96 scene, N = 8.

Each rank must return all N frames. Against the single-process rollout:
2e-5 (the sparse path's exactness claim, tests/test_rollout_sparse.py:184).
Against JAX: 2e-3, the port's frame tolerance (PERF.md §2), and 2e-2 in
the bf16 modes, as JAX holds its own sharded bf16 rollout against its
sparse one (tests/test_trainer.py:222). The cases: baseline and SLR in
float32, with v2 Z-norm, in bf16 (baseline) and bf16-fast (SLR v2), and
the crop decode (tests/test_trainer.py:465). ``--shard-frames`` PNGs,
written by rank 0 alone, are within one u8 level of the unsharded
render's; a world size that does not divide N raises."""

import dataclasses

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

import torch_dist_ranks as ranks
from conftest import tiny_options
from slrsfs_tpu.engine import rollout as jax_rollout
from slrsfs_tpu.engine.init_utils import jit_init, settle
from slrsfs_tpu.models.baseline import BaselineModel as JaxBaselineModel
from slrsfs_tpu.models.slr import SLRModel as JaxSLRModel
from slrsfs_tpu.parallel.mesh import make_mesh, replicate
from slrsfs_tpu_torch.config import Options
from slrsfs_tpu_torch.engine import rollout as port_rollout
from slrsfs_tpu_torch.io.convert import from_jax_variables
from slrsfs_tpu_torch.models.baseline import BaselineModel
from slrsfs_tpu_torch.models.slr import SLR_MODEL_TYPE, SLRModel
from slrsfs_tpu_torch.parallel import mesh as port_mesh
from slrsfs_tpu_torch.utils.flow_viz import write_flo

torch.set_num_threads(1)

H, W, N, DB = 64, 96, 8, 4
UPDOWN = "resnet_TinyTestUpDown_de_resnet_pconv2_nonorm"
SLR_KW = dict(model_type=SLR_MODEL_TYPE, alpha_refine_model_type=UPDOWN,
              use_alpha0_as_blending_weight=True)
# name: (slr, v2, render dtype, crop)
CASES = {"baseline": (False, False, "float32", False),
         "slr": (True, False, "float32", False),
         "baseline-v2": (False, True, "float32", False),
         "slr-v2": (True, True, "float32", False),
         "baseline-bf16": (False, False, "bfloat16", False),
         "slr-v2-bf16-fast": (True, True, "bfloat16-fast", False),
         "baseline-crop": (False, False, "float32", True),
         "slr-crop": (True, False, "float32", True)}
DTYPES = {"float32": (torch.float32, torch.float32, jnp.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, torch.float32, jnp.bfloat16, jnp.float32),
          "bfloat16-fast": (torch.bfloat16, torch.bfloat16, jnp.bfloat16, jnp.bfloat16)}


def _opts(slr: bool, v2: bool):
    kw = dict(SLR_KW if slr else {}, use_softmax_splatter_v2=v2)
    jopt = tiny_options(refine_model_type=UPDOWN, **kw)
    return jopt, Options(**dataclasses.asdict(jopt)).replace(bn_noise_misc=True)


def _scene():
    """A moving block of seeded flow in the middle of the frame: a crop
    window at positive offsets, P padded to 64."""
    rng = np.random.default_rng(4)
    img = (rng.standard_normal((1, H, W, 3)) * 0.25).astype(np.float32)
    flow = np.zeros((H, W, 2), np.float32)
    flow[48:58, 66:84] = rng.standard_normal((10, 18, 2)).astype(np.float32) * 0.8
    pos, val = jax_rollout.prepare_scene_sparse(flow, pad_multiple=64)
    return img, flow, pos, val


def _as_dict(out):
    return out if isinstance(out, dict) else {"PredImg": out}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Settled JAX variables of both models, each case's port
    single-process rollout and its two-rank frame-sharded rollout (one
    spawn for every case)."""
    img, flow, pos, val = _scene()
    variables, states = {}, {}
    for slr in (False, True):
        jopt, popt = _opts(slr, False)
        jm = (JaxSLRModel if slr else JaxBaselineModel)(jopt)
        v = jit_init(jm, {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
                     jnp.asarray(img), False, True)
        variables[slr] = settle(jm, v, (jnp.asarray(img),), n=3)
        states[slr] = from_jax_variables(jax.tree.map(np.asarray, variables[slr]), popt)
    t = [torch.from_numpy(a) for a in (img, flow, pos, val)]
    cases, single = [], {}
    for name, (slr, v2, dtype, crop) in CASES.items():
        _, popt = _opts(slr, v2)
        model = (SLRModel if slr else BaselineModel)(popt).eval()
        model.load_state_dict(states[slr])
        cd, sd = DTYPES[dtype][:2]
        kw = dict(compute_dtype=cd, splat_dtype=sd)
        if crop:
            disp, plan = port_rollout.prepare_crop(popt, slr, t[1], t[2], t[3], N,
                                                   max_area_frac=1.01, bucket=8)
            assert plan is not None and plan.hc < H and plan.wc < W
            kw.update(crop=plan, disp=disp)
        args = (t[0], t[1], N, t[2], t[3])
        fn = port_rollout.slr_rollout_sparse if slr else port_rollout.baseline_rollout_sparse
        single[name] = _as_dict(fn(model, *args, decode_batch=DB, **kw))
        cases.append((slr, popt, states[slr], args, dict(kw, decode_batch=DB)))
    sharded = ranks.run_ranks(ranks.rank_rollouts, 2, tmp_path_factory.mktemp("fs"), cases)
    return dict(img=img, flow=flow, pos=pos, val=val, variables=variables, single=single,
                sharded={name: [_as_dict(sharded[r][i]) for r in range(2)]
                         for i, name in enumerate(CASES)})


def _jax_sharded(runs, name):
    slr, v2, dtype, crop = CASES[name]
    jopt, _ = _opts(slr, v2)
    jm = (JaxSLRModel if slr else JaxBaselineModel)(jopt)
    mesh = make_mesh(2)
    kw = dict(compute_dtype=DTYPES[dtype][2], splat_dtype=DTYPES[dtype][3])
    flow, pos, val = (jnp.asarray(runs[k]) for k in ("flow", "pos", "val"))
    if crop:
        disp, plan = jax_rollout.prepare_crop(jopt, slr, flow, pos, val, N,
                                              max_area_frac=1.01, bucket=8)
        kw.update(crop=plan, disp=disp, crop_offsets=jnp.asarray(
            [plan.y0, plan.x0, plan.py0, plan.px0], jnp.int32))
    fn = jax_rollout.slr_rollout_frame_sharded if slr else \
        jax_rollout.baseline_rollout_frame_sharded
    out = jax.jit(lambda v: fn(jm, v, jnp.asarray(runs["img"]), flow, N, pos, val, mesh,
                               **kw))(replicate(runs["variables"][slr], mesh))
    return {k: np.asarray(v) for k, v in _as_dict(out).items()}


@pytest.mark.parametrize("name", sorted(CASES))
def test_two_rank_render_matches_single_process_and_jax(runs, name):
    single, sharded = runs["single"][name], runs["sharded"][name]
    want = _jax_sharded(runs, name)
    jax_tol = 2e-3 if CASES[name][2] == "float32" else 2e-2
    for r in range(2):
        assert set(sharded[r]) == set(single)
        for k, v in single.items():
            got = sharded[r][k]
            assert got.shape == v.shape, (k, got.shape)
            np.testing.assert_allclose(got.numpy(), v.numpy(), rtol=2e-5, atol=2e-5,
                                       err_msg=f"rank {r} {k}")
            if k in want:
                w = want[k] if k != "BGImg" else want[k].reshape(v.shape)
                np.testing.assert_allclose(got.numpy(), w, rtol=jax_tol, atol=jax_tol,
                                           err_msg=f"rank {r} {k} vs JAX")


def test_shard_frames_pngs_match_unsharded_render(tmp_path):
    """``SceneRenderer(shard_frames=True)`` on two ranks (random weights
    from one seed, tiny decoders, 32², N = 4): rank 0 writes every PNG and
    the mp4, rank 1 nothing, and the PNGs are within one u8 level of one
    process's unsharded render."""
    from slrsfs_tpu_torch.cli.render import SceneRenderer

    rng = np.random.default_rng(8)
    image = str(tmp_path / "scene.png")
    Image.fromarray(rng.integers(0, 255, (48, 48, 3), dtype=np.uint8)).save(image)
    flow = np.zeros((48, 48, 2), np.float32)
    flow[24:, :] = rng.standard_normal((24, 48, 2)).astype(np.float32) * 2.0
    flow_path = str(tmp_path / "scene.flo")
    write_flo(flow_path, flow)
    kw = dict(W=32, n_frames=4, opt_overrides=dict(
        ngf=8, out_channel=9, refine_model_type=UPDOWN, ndf=8, num_D=1, n_layers_D=2))
    files = ranks.run_ranks(ranks.rank_render, 2, tmp_path, str(tmp_path / "sharded"),
                            image, flow_path, kw)
    pngs = [f for f in files[0] if f.endswith(".png")]
    assert len(pngs) == 4 and any(f.endswith(".mp4") for f in files[0]), files[0]
    assert files[1] == []
    r = SceneRenderer(device="cpu", **kw)
    r.render(image, flow_path, str(tmp_path / "single"), name="scene")
    r.close()
    for f in pngs:
        a = np.asarray(Image.open(tmp_path / "sharded" / "rank0" / f), np.int16)
        b = np.asarray(Image.open(tmp_path / "single" / f), np.int16)
        assert a.shape == b.shape and np.abs(a - b).max() <= 1, f


def test_frame_sharded_rollouts_refuse_an_indivisible_world():
    """N % world != 0 raises ``ValueError`` before any collective (JAX
    asserts), for both rollouts and for ``parallel.mesh.frame_block``."""
    fake = port_mesh.Mesh(None, 1, 2, torch.device("cpu"))
    with pytest.raises(ValueError, match="must divide over 2 ranks"):
        port_mesh.frame_block(7, fake)
    for slr in (False, True):
        _, popt = _opts(slr, False)
        model = (SLRModel if slr else BaselineModel)(popt).eval()
        fn = (port_rollout.slr_rollout_frame_sharded if slr
              else port_rollout.baseline_rollout_frame_sharded)
        flow = torch.zeros((16, 16, 2))
        with pytest.raises(ValueError, match="must divide over 2 ranks"):
            fn(model, torch.zeros((1, 16, 16, 3)), flow, 3,
               torch.zeros((16, 2), dtype=torch.int32), torch.zeros(16), fake)
    assert port_mesh.frame_block(8, fake) == range(4, 8)
