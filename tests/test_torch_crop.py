"""The port's moving-region crop decode, the scene sweep and the stage
profiles against the JAX package, on the same numpy-seeded inputs and the
same weights (JAX variables carried over by ``from_jax_variables``).

* the crop planning helpers (radius, alignment, plan, target bounds):
  exact, CropSpec for CropSpec;
* the baseline and SLR crop rollouts (SLR with an edit region), v2 off and
  on, on the JAX crop tests' TinyTestUpDown scene at (64, 96), N = 6, and
  on one whose window
  sits at a positive offset with padded rows: port crop against JAX crop
  within 2e-3 (the port's frame tolerance, tests/test_torch_rollout.py),
  port crop against port full within 2e-6 (the JAX package's own crop
  exactness, tests/test_crop_rollout.py); in the bfloat16 modes in
  tests/test_torch_crop_bf16.py;
* the static decode input at the NORM_EPS floor: 1e-6, as the JAX test
  holds it against the per-frame math;
* ``SceneRenderer`` with ``crop_decode='auto'`` against the JAX renderer
  (PNGs within one u8 level); ``render_all``'s moving sets against JAX's
  ``prepare_scene_sparse(bucket_ratio=1.25)`` and its PNGs against
  one-scene renders; the stage profiles' frames against the rollout's and
  their keys against JAX's."""

import argparse
import dataclasses
import os
import re

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from conftest import tiny_options
from slrsfs_tpu.engine import rollout as jax_rollout
from slrsfs_tpu.engine.init_utils import jit_init, settle
from slrsfs_tpu.models.baseline import BaselineModel as JaxBaselineModel
from slrsfs_tpu.models.slr import SLRModel as JaxSLRModel
from slrsfs_tpu.nn import archs as jax_archs
from slrsfs_tpu_torch.cli import render as port_render
from slrsfs_tpu_torch.config import Options
from slrsfs_tpu_torch.engine import rollout as port_rollout
from slrsfs_tpu_torch.engine import stage_profile
from slrsfs_tpu_torch.io.convert import from_jax_variables
from slrsfs_tpu_torch.models.baseline import BaselineModel
from slrsfs_tpu_torch.models.slr import SLR_MODEL_TYPE, SLRModel

torch.set_num_threads(1)

H, W, N, DB = 64, 96, 6, 3
UPDOWN = "resnet_TinyTestUpDown_de_resnet_pconv2_nonorm"
SLR_KW = dict(model_type=SLR_MODEL_TYPE, alpha_refine_model_type=UPDOWN,
              use_alpha0_as_blending_weight=True)
SETUPS = re.findall(r'setup == "(\w+)"', open(jax_archs.__file__).read())


def _scene(seed: int, rows: slice, cols: slice):
    """The JAX crop tests' scene (``_scene``): a moving block of seeded
    random flow, P padded to 64."""
    rng = np.random.default_rng(seed)
    img = (rng.standard_normal((1, H, W, 3)) * 0.25).astype(np.float32)
    flow = np.zeros((H, W, 2), np.float32)
    n_r, n_c = rows.stop - rows.start, cols.stop - cols.start
    flow[rows, cols] = rng.standard_normal((n_r, n_c, 2)).astype(np.float32) * 0.8
    pos, val = jax_rollout.prepare_scene_sparse(flow, pad_multiple=64)
    return img, flow, pos, val


# the JAX tests' scene (window at x0 = 0), and one in the middle of the
# frame: a window at a positive offset in both axes, its padding rows at
# negative window coordinates
SCENES = {"jax": (0, slice(40, 56), slice(8, 32)),
          "offset": (4, slice(48, 58), slice(66, 84))}


def _init(jmodel, img):
    v = jit_init(jmodel, {"params": jax.random.PRNGKey(0),
                          "noise": jax.random.PRNGKey(1)}, img, False, True)
    return settle(jmodel, v, (img,), n=3)


def _opts(**kw):
    jopt = tiny_options(refine_model_type=UPDOWN, **kw)
    return jopt, Options(**dataclasses.asdict(jopt)).replace(bn_noise_misc=True)


@pytest.fixture(scope="module")
def env():
    """Settled JAX variables of the UPDOWN baseline and SLR models (v2 does
    not change the parameters) and their port state_dicts."""
    img = _scene(*SCENES["jax"])[0]
    out = {}
    for name, kw in (("baseline", {}), ("slr", SLR_KW)):
        jopt, popt = _opts(**kw)
        jmodel = (JaxSLRModel if kw else JaxBaselineModel)(jopt)
        variables = _init(jmodel, jnp.asarray(img))
        out[name] = dict(variables=variables, sd=from_jax_variables(
            jax.tree.map(np.asarray, variables), popt))
    return out


def _models(env, slr: bool, v2: bool):
    kw = dict(SLR_KW if slr else {}, use_softmax_splatter_v2=v2)
    jopt, popt = _opts(**kw)
    pm = (SLRModel if slr else BaselineModel)(popt).eval()
    pm.load_state_dict(env["slr" if slr else "baseline"]["sd"])
    jm = (JaxSLRModel if slr else JaxBaselineModel)(jopt)
    return jopt, jm, popt, pm


def _as_dict(out):
    return out if isinstance(out, dict) else {"PredImg": out}


@pytest.mark.parametrize("setup", SETUPS)
def test_crop_params_match_jax(setup):
    jopt, popt = _opts()
    name = f"resnet_{setup}_de_resnet_pconv2_nonorm"
    ja = jax_archs.get_resnet_arch(name, jopt)
    from slrsfs_tpu_torch.nn.archs import get_resnet_arch

    pa = get_resnet_arch(name, popt)
    assert (port_rollout.decoder_receptive_radius(pa)
            == jax_rollout.decoder_receptive_radius(ja))
    assert port_rollout.crop_alignment(pa) == jax_rollout.crop_alignment(ja)
    for slr in (False, True):
        kw = dict(refine_model_type=name, alpha_refine_model_type=name)
        assert (port_rollout.model_crop_params(popt.replace(**kw), slr)
                == jax_rollout.model_crop_params(jopt.replace(**kw), slr))


@pytest.mark.parametrize("bucket", [1, 8, 32])
@pytest.mark.parametrize("frame", [(64, 96), (63, 96), (768, 768), (256, 200)])
def test_plan_crop_matches_jax(frame, bucket):
    """A grid of bounds, inverted (no tap reaches the grid) ones included,
    at radii and alignments of the real and the tiny decoders."""
    h, w = frame
    rng = np.random.default_rng(h * 7 + w + bucket)
    cases = [np.array([w - 1, 0, h - 1, 0], np.float32),  # inverted sentinels
             np.array([5, 3, 2, 9], np.float32),
             np.array([0, w - 1, 0, h - 1], np.float32)]
    for _ in range(40):
        x = np.sort(rng.integers(0, w, 2))
        y = np.sort(rng.integers(0, h, 2))
        cases.append(np.array([x[0], x[1], y[0], y[1]], np.float32))
    for radius, align in ((43, 4), (15, 2), (6, 1)):
        for frac in (0.85, 1.01):
            for b in cases:
                want = jax_rollout.plan_crop(b, h, w, radius, align,
                                             max_area_frac=frac, bucket=bucket)
                got = port_rollout.plan_crop(b, h, w, radius, align,
                                             max_area_frac=frac, bucket=bucket)
                assert got == want, (b, radius, align, frac)
                assert (got is None) == (want is None)


def test_target_bounds_matches_jax_on_oob_markers():
    """JAX's case (tests/test_crop_rollout.py:184): the max(H, W)+1 marker of
    a leaving trajectory and a fully off-grid target add nothing."""
    h, w = 32, 48
    pos = np.asarray([[10, 12], [11, 12], [40, 20]], np.int32)
    val = np.ones((3,), np.float32)
    disp = np.zeros((3, 3, 2), np.float32)
    disp[:, 0] = [2.0, 3.0]
    disp[:, 1] = [49.0, 49.0]
    disp[:, 2] = [30.0, -25.0]
    want = np.asarray(jax_rollout._target_bounds(
        jnp.asarray(pos), jnp.asarray(val), jnp.asarray(disp), jnp.asarray(disp),
        h, w))
    got = port_rollout._target_bounds(
        torch.from_numpy(pos), torch.from_numpy(val), torch.from_numpy(disp),
        torch.from_numpy(disp), h, w).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [12.0, 13.0, 15.0, 16.0])


# a render dtype → (JAX compute_dtype, splat_dtype; the port's)
MODES = {"float32": (jnp.float32, None, torch.float32, torch.float32),
         "bfloat16": (jnp.bfloat16, None, torch.bfloat16, torch.float32),
         "bfloat16-fast": (jnp.bfloat16, jnp.bfloat16, torch.bfloat16,
                           torch.bfloat16)}


def crop_rollouts(env, slr: bool, v2: bool, scene: str, mode: str = "float32"):
    """On one scene in one render mode: {"port": the port's crop rollout,
    "jax": JAX's crop rollout, "full": the port's uncropped rollout, and
    outside float32 "jax_f32": JAX's float32 crop rollout}, each a dict of
    outputs. SLR renders with an edit region across the window's edge."""
    img, flow, pos, val = _scene(*SCENES[scene])
    jopt, jm, popt, pm = _models(env, slr, v2)
    j = tuple(map(jnp.asarray, (img, flow, pos, val)))
    p = tuple(map(torch.from_numpy, (img, flow, pos, val)))
    jdisp, jcrop = jax_rollout.prepare_crop(jopt, slr, j[1], j[2], j[3], N,
                                            max_area_frac=1.01)
    disp, crop = port_rollout.prepare_crop(popt, slr, p[1], p[2], p[3], N,
                                           max_area_frac=1.01)
    assert crop == jcrop and crop.hc < H
    if scene == "offset":
        assert crop.y0 > 0 and crop.x0 > 0 and (pos[:, 0] < crop.x0).any()
    jrun = jax_rollout.slr_rollout_sparse if slr else jax_rollout.baseline_rollout_sparse
    prun = port_rollout.slr_rollout_sparse if slr else port_rollout.baseline_rollout_sparse
    variables = env["slr" if slr else "baseline"]["variables"]
    kw = {}
    if slr:  # an edit region across the window's edge
        region = np.zeros((1, H, W, 1), np.float32)
        region[:, 30:60, 20:70] = 1.0
        kw = dict(alpha_region=region)
    jc, js, pc, ps = MODES[mode]

    def jax_crop(compute_dtype, splat_dtype):
        return _as_dict(jax.jit(lambda v, d: jrun(
            jm, v, *j[:2], N, *j[2:], decode_batch=DB, crop=jcrop, disp=d,
            compute_dtype=compute_dtype, splat_dtype=splat_dtype,
            **{k: jnp.asarray(a) for k, a in kw.items()}))(variables, jdisp))

    kw = {k: torch.from_numpy(a) for k, a in kw.items()}
    pkw = dict(decode_batch=DB, compute_dtype=pc, splat_dtype=ps, **kw)
    out = {"port": _as_dict(prun(pm, *p[:2], N, *p[2:], crop=crop, disp=disp, **pkw)),
           "jax": jax_crop(jc, js),
           "full": _as_dict(prun(pm, *p[:2], N, *p[2:], **pkw))}
    if mode != "float32":
        out["jax_f32"] = jax_crop(jnp.float32, None)
    assert all(set(o) == set(out["port"]) for o in out.values())
    return out


@pytest.mark.parametrize("scene", sorted(SCENES))
@pytest.mark.parametrize("v2", [False, True])
@pytest.mark.parametrize("slr", [False, True], ids=["baseline", "slr"])
def test_crop_rollout_matches_jax(env, slr, v2, scene):
    o = crop_rollouts(env, slr, v2, scene)
    for k in o["port"]:
        np.testing.assert_allclose(o["port"][k].numpy(), np.asarray(o["jax"][k]),
                                   rtol=2e-3, atol=2e-3, err_msg=k)
        np.testing.assert_allclose(o["port"][k].numpy(), o["full"][k].numpy(),
                                   rtol=0, atol=2e-6, err_msg=k)


def test_all_static_scene_plans_no_crop(env):
    img = _scene(*SCENES["jax"])[0]
    flow = np.zeros((H, W, 2), np.float32)
    pos, val = port_rollout.prepare_scene_sparse(flow, pad_multiple=64)
    popt, pm = _models(env, False, False)[2:]
    p = tuple(map(torch.from_numpy, (img, flow, pos, val)))
    disp, crop = port_rollout.prepare_crop(popt, False, *p[1:], N)
    assert crop is None
    frames = port_rollout.baseline_rollout_sparse(pm, *p[:2], N, *p[2:],
                                                  decode_batch=DB, disp=disp)
    assert frames.shape == (N, H, W, 3) and bool(torch.isfinite(frames).all())


@pytest.mark.parametrize("v2", [False, True])
def test_static_decode_input_matches_jax_at_eps_floor(v2):
    """The JAX test's inputs (tests/test_crop_rollout.py:262): Z spread
    wider than ln(1e-8), so that the NORM_EPS floor engages at static
    pixels and the field there is not fs."""
    rng = np.random.default_rng(7)
    h, w, C = 24, 32, 5
    jopt, popt = _opts(use_softmax_splatter_v2=v2)
    fs = rng.standard_normal((1, h, w, C)).astype(np.float32)
    z = rng.standard_normal((1, h, w, 1)).astype(np.float32)
    z[:, :8] += 30.0
    z[:, 18:] -= 25.0
    flow = np.zeros((h, w, 2), np.float32)
    flow[10:14, 10:18] = 0.7
    pos, val = jax_rollout.prepare_scene_sparse(flow, pad_multiple=64)
    want = np.asarray(jax_rollout._baseline_static_decode_input(
        jopt, *map(jnp.asarray, (fs, z, pos, val)), h, w, jnp.dtype(jnp.float32)))
    got = port_rollout._baseline_static_decode_input(
        popt, *map(torch.from_numpy, (fs, z, pos, val)), False).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert np.abs(got[0] - fs[0]).max() > 0.5  # the floor engaged


@pytest.fixture(scope="module")
def ckpt(env, tmp_path_factory):
    """A reference-style .pth of the UPDOWN baseline, as
    tests/test_torch_render.py writes one."""
    jopt = _opts()[0]
    sd = {f"model.module.{k}": v for k, v in env["baseline"]["sd"].items()}
    path = str(tmp_path_factory.mktemp("crop_ckpt") / "model.pth")
    torch.save({"state_dict": sd,
                "opts": argparse.Namespace(**dataclasses.asdict(jopt))}, path)
    return path


def _pngs(d):
    names = sorted(os.listdir(d))
    return names, [np.asarray(Image.open(os.path.join(d, n)), np.int16) for n in names]


def test_scene_renderer_crop_matches_jax(fixture_root, ckpt, tmp_path):
    """Both renderers with crop_decode 'auto' at W = 192, where the
    fixture's moving bottom half plans a window at y0 > 0."""
    from slrsfs_tpu.cli.render import render_scene as jax_render_scene

    scene = "00001_00000"
    img_path = os.path.join(fixture_root, "avr_image", f"{scene}.png")
    flow_path = os.path.join(fixture_root, "train", f"{scene}_motion.npz")
    kw = dict(ckpt=ckpt, name=scene, W=192, n_frames=6, decode_batch=6,
              crop_decode="auto")
    jax_dir = jax_render_scene(img_path, flow_path, str(tmp_path / "jax"), **kw)
    r = port_render.SceneRenderer(ckpt=ckpt, W=192, n_frames=6, decode_batch=6,
                                  device="cpu")
    port_dir = r.render(img_path, flow_path, str(tmp_path / "port"), name=scene)
    r.finish()
    (P, hc, wc), = r.shapes
    assert hc < 192 and wc == 192  # the crop engaged
    ja, a = _pngs(os.path.join(jax_dir, "PredImg"))
    pb, b = _pngs(os.path.join(port_dir, "PredImg"))
    assert ja == pb and len(ja) == 6
    for n, x, y in zip(ja, a, b):
        assert np.abs(x - y).max() <= 1, n


def test_render_cli_profile_stages(fixture_root, ckpt, tmp_path, monkeypatch,
                                   capsys):
    """``cli.render --profile-stages`` on the CPU: the full and the crop
    profiles, every stage > 0, and the crop profile's decodes sized to the
    window's area as the crop render sizes them."""
    scene = "00001_00000"
    seen = []
    rollout = stage_profile.baseline_rollout_sparse

    def spy(*a, **k):
        seen.append((k.get("crop"), k["decode_batch"]))
        return rollout(*a, **k)

    monkeypatch.setattr(stage_profile, "baseline_rollout_sparse", spy)
    r = port_render.main([
        os.path.join(fixture_root, "avr_image", f"{scene}.png"),
        os.path.join(fixture_root, "train", f"{scene}_motion.npz"),
        str(tmp_path / "out"), "--ckpt", ckpt, "--W", "192", "--n-frames", "6",
        "--profile-stages", "--device", "cpu"])
    st = r.stage_profiles
    assert st["crop"] is not None
    for kind in ("full", "crop"):
        assert all(st[kind][k] > 0 for k in stage_profile.STAGES), kind
    hc, wc = st["crop"]["crop"][2:4]
    assert hc < 192
    crops = [db for c, db in seen if c is not None]
    assert crops and set(crops) == {r.decode_batch_for(hc * wc)}
    assert {db for c, db in seen if c is None} == {r.decode_batch_for(192 * 192)}
    out = capsys.readouterr().out
    assert f"[profile {scene}] crop (t_euler_integration = prepare_crop)" in out


def test_render_all_buckets_and_renders_each_scene(fixture_root, monkeypatch,
                                                   tmp_path):
    from slrsfs_tpu_torch.cli import render_all
    from slrsfs_tpu_torch.data.video import VideoReader

    scenes_dir = tmp_path / "scenes"
    os.makedirs(scenes_dir)
    scenes = ("00001_00000", "00002_00000")
    for scene in scenes:
        vr = VideoReader(os.path.join(fixture_root, "train", f"{scene}_gt.mp4"))
        Image.fromarray(vr[0]).save(scenes_dir / f"{scene}_input.jpg")
        vr.close()
        os.symlink(os.path.join(fixture_root, "train", f"{scene}_motion.npz"),
                   scenes_dir / f"{scene}_motion.npz")
    seen = []
    prepare = port_rollout.prepare_scene_sparse

    def spy(flow, *a, **k):
        out = prepare(flow, *a, **k)
        seen.append((np.array(flow), out[0].shape[0]))
        return out

    monkeypatch.setattr(port_rollout, "prepare_scene_sparse", spy)
    overrides = ('{"ngf": 8, "out_channel": 9, "refine_model_type": "%s"}'
                 % UPDOWN)
    common = ["--W", "192", "--n-frames", "6", "--dtype", "float32",
              "--opt-overrides", overrides, "--device", "cpu"]
    res = render_all.main([str(scenes_dir), str(tmp_path / "sweep"),
                           "--flow-suffix", "_motion.npz"] + common)
    assert res["done"] == 2 and res["shapes"] >= 1 and res["elapsed_s"] > 0
    assert len(seen) == 2
    for flow, P in seen:
        want = jax_rollout.prepare_scene_sparse(flow, bucket_ratio=1.25)[0]
        assert P == want.shape[0]
    for scene in scenes:
        one = port_render.render_scene(
            str(scenes_dir / f"{scene}_input.jpg"),
            str(scenes_dir / f"{scene}_motion.npz"), str(tmp_path / "one"),
            name=scene, W=192, n_frames=6, dtype="float32",
            opt_overrides=dict(ngf=8, out_channel=9, refine_model_type=UPDOWN),
            sparsify_eps=None, device="cpu")
        na, a = _pngs(os.path.join(one, "PredImg"))
        nb, b = _pngs(str(tmp_path / "sweep" / scene / "PredImg"))
        assert na == nb and len(na) == 6
        for n, x, y in zip(na, a, b):
            np.testing.assert_array_equal(x, y, err_msg=f"{scene} {n}")


@pytest.mark.parametrize("crop", [False, True], ids=["full", "crop"])
def test_stage_profiles_match_the_rollout_and_jax_keys(env, crop):
    from slrsfs_tpu.engine import stage_profile as jax_stage_profile

    img, flow, pos, val = _scene(*SCENES["offset"])
    jopt, jm, popt, pm = _models(env, False, False)
    p = tuple(map(torch.from_numpy, (img, flow, pos, val)))
    j = (env["baseline"]["variables"],) + tuple(map(jnp.asarray, (img, flow, pos, val)))
    kw = dict(decode_batch=DB, runs=1)
    if crop:
        want_keys = set(jax_stage_profile.profile_baseline_crop_stages(
            jm, *j, N, max_area_frac=1.01, **kw))
        st, frames = stage_profile.profile_baseline_crop_stages(
            pm, *p, N, max_area_frac=1.01, **kw)
        disp, c = port_rollout.prepare_crop(popt, False, *p[1:], N,
                                            max_area_frac=1.01)
        assert st["crop"] == tuple(c)
    else:
        want_keys = set(jax_stage_profile.profile_baseline_stages(jm, *j, N, **kw))
        st, frames = stage_profile.profile_baseline_stages(pm, *p, N, **kw)
        disp = c = None
    assert set(st) == want_keys
    assert all(st[k] > 0 for k in stage_profile.STAGES + ("total", "fps"))
    want = port_rollout.baseline_rollout_sparse(pm, *p[:2], N, *p[2:],
                                                decode_batch=DB, crop=c, disp=disp)
    np.testing.assert_array_equal(frames.numpy(), want.numpy())



def test_chip_smoke_scenes_plan_as_jax_plans():
    """chip_smoke.py's 768² crop scene plans JAX's window (its CROP_PLAN),
    in the port as in the JAX package, and of its sweep's scenes a and b
    share one (P, window) shape and c and d have shapes of their own."""
    import chip_smoke
    from slrsfs_tpu.config import Options as JaxOptions

    n = chip_smoke.N_FRAMES
    flow = chip_smoke.synthetic_scene(chip_smoke.SEED, chip_smoke.CROP_W,
                                      chip_smoke.CROP_ROWS, chip_smoke.CROP_COLS)[1]
    pos, val = jax_rollout.prepare_scene_sparse(flow)
    assert int(val.sum()) == 73728
    jcrop = jax_rollout.prepare_crop(JaxOptions(), False,
                                     *map(jnp.asarray, (flow, pos, val)), n)[1]
    assert tuple(jcrop) == chip_smoke.CROP_PLAN
    crop = port_rollout.prepare_crop(Options(), False,
                                     *map(torch.from_numpy, (flow, pos, val)), n,
                                     plain=True)[1]
    assert crop == jcrop
    shapes = {}
    for name, (seed, rows, cols) in chip_smoke.SWEEP_SCENES.items():
        flow = chip_smoke.synthetic_scene(seed, chip_smoke.CROP_W, rows, cols)[1]
        pos, val = port_rollout.prepare_scene_sparse(flow, bucket_ratio=1.25)
        c = port_rollout.prepare_crop(Options(), False,
                                      *map(torch.from_numpy, (flow, pos, val)), n,
                                      plain=True)[1]
        shapes[name] = (pos.shape[0], c.hc, c.wc)
    assert shapes["a"] == shapes["b"]
    assert len(set(shapes.values())) == len(shapes) - 1


def test_trace_busy_reconciles_overlapping_streams(tmp_path):
    """``tools/trace_busy.py`` on a hand-made trace: two streams overlap and
    one kernel leaves the span. The busy time is the union clipped to the
    span; the durations' sum is Σ k · t_k over the time with k running."""
    import gzip
    import json

    from slrsfs_tpu_torch.tools import trace_busy

    def ev(cat, ts, dur, tid=7, name="k"):
        return {"cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}

    events = [ev("user_annotation", 0.0, 100.0, name=trace_busy.SPAN),
              ev("cpu_op", 0.0, 100.0, name="aten::conv2d"),
              ev("kernel", 10.0, 40.0), ev("kernel", 30.0, 30.0, tid=13),
              ev("gpu_memcpy", 70.0, 10.0), ev("kernel", 95.0, 15.0, tid=13)]
    path = str(tmp_path / "trace.json.gz")
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events}, f)
    b = trace_busy.device_busy(trace_busy.load_events(path), trace_busy.SPAN)
    assert b["span_us"] == 100.0 and b["sum_us"] == 95.0
    assert b["busy_us"] == 65.0 and b["busy_unclipped_us"] == 75.0
    assert b["by_running"] == {0: 35.0, 1: 45.0, 2: 20.0}
    assert b["streams"] == {7: (2, 50.0), 13: (2, 45.0)} and b["n_kernels"] == 3
    assert "65.0 % (idle 35.0 %" in trace_busy.summary(b)
    assert trace_busy.main([path]) == 0
    with pytest.raises(ValueError, match="0 'other' spans"):
        trace_busy.device_busy(events, "other")
