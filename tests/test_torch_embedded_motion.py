"""The embedded-motion stages (the fix-motion finetune and the unfrozen joint
stage) against the JAX package: ``models/baseline.py:
BaselineMotionTrainable`` and ``baseline_motion_extra_losses``, and the
port's ``Trainer`` with ``opt.freeze_motion`` on and off against the JAX
``Trainer`` (tests/torch_stage_parity.py's conventions and checks).

* ``forward_train`` at the reference fluid archs (ngf 16), a depth-4
  SPADE regressor of width 4, W = 32, B = 2, T = 4, numpy-drawn JAX
  variables: every pred tensor (``PredMotion``, ``GTMotionRaw``, the
  splat's Z, the decoded image) within 1e-4 of its largest magnitude,
  except ``PredImg``, which the fluid pconv decoder gives: 1e-3 (see
  ``DECODED_TOL``); the BN statistics and spectral vectors it leaves
  within 1e-5; a batch's moving sets are dropped as in JAX (the same
  result with and without them);
* ``baseline_motion_extra_losses``: the motion losses and their total, 0
  when frozen, within 1e-6;
* two G+D steps at ``tiny_options`` (the fluid nets' TinyTest archs, the
  depth-4 regressor), frozen and unfrozen, from settled spectral vectors:
  losses of both steps; after the first, the gradients of every
  sub-network (the regressor's too when unfrozen: the synthesis loss's
  gradient reaches it through K7's and K3's plain VJPs) and parameters;
  BN statistics and spectral vectors after both. Frozen, the regressor's
  parameters stay bit-identical (as tests/test_stage_trainers.py:84 holds
  for JAX) and out of G's Adam, while its spectral vectors run their power
  iterations (they move, and equal JAX's)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
from flax import linen as nn

import torch_stage_parity as P
from conftest import tiny_options
from slrsfs_tpu.config import Options as JaxOptions
from slrsfs_tpu.engine.trainer import Trainer as JaxTrainer
from slrsfs_tpu.models import baseline as jbase
from slrsfs_tpu_torch.cli.train import attach_moving_sets
from slrsfs_tpu_torch.config import Options
from slrsfs_tpu_torch.engine.trainer import Trainer
from slrsfs_tpu_torch.io.convert import from_jax_variables
from slrsfs_tpu_torch.models import baseline as pbase
from slrsfs_tpu_torch.nn.discriminators import MultiscaleDiscriminator
from slrsfs_tpu_torch.nn.vgg import VGG19Features

torch.set_num_threads(1)

B, HW, T = 2, 32, 4
MOTION = dict(W=HW, motionW=HW, motionH=HW, train_motion=True,
              motion_num_filters=4, motion_unet_downs=4,
              motion_losses=("1.0_EndPointError", "0.5_MotionL1"))
# The fluid pconv decoder's output reaches ~2.7e-4 of its largest magnitude
# against JAX's at these shapes: the two frameworks sum its convolutions
# and BN reductions in other float32 orders, and the drift grows through
# its eight blocks (ROADMAP §3; its hole masks agree element for element).
DECODED_TOL = 1e-3


def motion_batch(seed: int, static_top: bool = True):
    """Three views, counts, a ground-truth motion (its top half static) and
    hints, as numpy."""
    rng = np.random.default_rng(seed)
    idx = np.zeros((B, 3), np.int32)
    idx[:, 1] = rng.integers(1, 4, size=B)
    idx[:, 2] = 4
    motions = (rng.standard_normal((B, HW, HW, 2)) * 0.8).astype(np.float32)
    if static_top:
        motions[:, : HW // 2] = 0.0
    hints = (motions * (rng.random((B, HW, HW, 1)) < 0.2)).astype(np.float32)
    return {"images": [(rng.standard_normal((B, HW, HW, 3)) * 0.25).astype(np.float32)
                       for _ in range(3)],
            "index": idx, "motions": motions, "hints": hints}


# ---- forward_train and the extra losses -------------------------------------

@pytest.fixture(scope="module")
def ft():
    jopt = JaxOptions(ngf=16, **MOTION)
    popt = Options(**dataclasses.asdict(jopt))
    jmodel = jbase.BaselineMotionTrainable(jopt, train_max_steps=T)
    batch = motion_batch(3)
    variables = P.numpy_init(jmodel, P.jnp_batch(batch), seed=21)

    @jax.jit
    def jforward(v, b):
        with nn.intercept_methods(P.zero_noise):
            return jmodel.apply(v, b, True, False, method=jmodel.forward_train,
                                mutable=["batch_stats", "spectral"],
                                rngs={"noise": jax.random.PRNGKey(2)})

    (_, want), ups = jforward(variables, P.jnp_batch(batch))
    model = pbase.BaselineMotionTrainable(popt, train_max_steps=T)
    init = from_jax_variables(P.np_tree(variables), popt, model)
    model.load_state_dict(init)
    with torch.no_grad():
        _, got = model.forward_train(P.port_batch(batch), train=True, deterministic=True)
    return dict(jopt=jopt, popt=popt, want=P.np_tree(want), got=got, ups=ups,
                variables=variables, model=model, init=init, batch=batch)


def test_forward_train_matches_jax(ft):
    P.check_pred(ft["got"], ft["want"], {"PredImg": DECODED_TOL})
    assert {"PredMotion", "GTMotionRaw", "GTMotion"} <= set(ft["got"])
    np.testing.assert_array_equal(ft["got"]["GTMotionRaw"].numpy(), ft["batch"]["motions"])
    model = ft["model"]
    after = from_jax_variables(P.np_tree({"params": ft["variables"]["params"],
                                          **ft["ups"]}), ft["popt"], model)
    params = {n for n, _ in model.named_parameters()}
    n_state = 0
    for name, t in model.state_dict().items():
        if name in params:
            continue
        n_state += 1
        np.testing.assert_allclose(t.numpy(), after[name].numpy(), rtol=0, atol=1e-5,
                                   err_msg=name)
    # the regressor's spectral vectors ran their power iterations
    assert any(n.startswith("motion_regressor.") and n.endswith("weight_u")
               for n in model.state_dict())
    assert n_state > 50


def test_forward_train_drops_the_moving_sets(ft):
    """A predicted motion is dense: moving sets attached from the ground
    truth change nothing."""
    model = ft["model"]
    sparse = attach_moving_sets(dict(ft["batch"]))
    assert "mov_pos" in sparse
    outs = []
    for b in (ft["batch"], sparse):
        model.load_state_dict(ft["init"])
        with torch.no_grad():
            gen, _ = model.forward_train(P.port_batch(b), train=True, deterministic=True)
        outs.append(gen)
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("frozen", [False, True])
def test_extra_losses_match_jax(frozen):
    rng = np.random.default_rng(4)
    pred = {"PredMotion": rng.standard_normal((B, HW, HW, 2)).astype(np.float32),
            "GTMotionRaw": rng.standard_normal((B, HW, HW, 2)).astype(np.float32)}
    jopt = JaxOptions(freeze_motion=frozen, **MOTION)
    want = jbase.baseline_motion_extra_losses(
        jopt, {k: jax.numpy.asarray(v) for k, v in pred.items()})
    got = pbase.baseline_motion_extra_losses(
        Options(**dataclasses.asdict(jopt)), {k: torch.from_numpy(v) for k, v in pred.items()})
    assert set(got) == set(want) == {"EndPointError", "MotionL1", "Total Extra"}
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    assert (float(got["Total Extra"]) == 0.0) == frozen


# ---- the G+D steps, frozen and unfrozen --------------------------------------

@pytest.fixture(scope="module", params=[False, True], ids=["joint", "frozen"])
def runs(request, vgg_vars32):
    frozen = request.param
    jopt = tiny_options(batch_size=B, freeze_motion=frozen, **MOTION)
    jtr = JaxTrainer(jopt, jbase.BaselineMotionTrainable(jopt, train_max_steps=T),
                     steps_per_epoch=10, extra_losses_fn=jbase.baseline_motion_extra_losses)
    jtr.load_vgg(vgg_vars32)
    batch = motion_batch(5, static_top=False)
    state = P.settled_state(jtr.init_state(jax.random.PRNGKey(0), P.jnp_batch(batch)))
    jruns = P.jax_steps(jtr, state, batch)

    opt = Options(**dataclasses.asdict(jopt))
    model = pbase.BaselineMotionTrainable(opt, train_max_steps=T)
    d = MultiscaleDiscriminator(opt)
    P.load_port(model, d, opt, state)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    vgg = VGG19Features()
    vgg.load_state_dict(from_jax_variables(P.np_tree(vgg_vars32), opt, vgg))
    tr = Trainer(opt, model, steps_per_epoch=10, vgg=vgg, d_model=d, deterministic=True,
                 device="cpu", extra_losses_fn=pbase.baseline_motion_extra_losses)
    port = P.port_steps(tr, batch, sync=lambda k: P.sync_port(tr, opt, jruns[k - 1][0]))
    return dict(frozen=frozen, opt=opt, model=model, d=d, tr=tr, init=init,
                jax=jruns, port=port)


def _groups(runs):
    names = ("encoder", "projector") if runs["frozen"] else None
    return P.g_groups(runs["model"], names)


@pytest.mark.parametrize("k", [0, 1])
def test_step_losses_match_jax(runs, k):
    P.check_losses(runs["port"][k][0], runs["jax"][k][1],
                   ("EndPointError", "MotionL1", "L1", "Perceptual", "GAN", "D_Fake"))


def test_step_gradients_match_jax(runs):
    _, g, d, _ = runs["port"][0]
    rel = P.check_grads(runs["opt"], runs["model"], runs["d"], runs["jax"][0][0], g, d,
                        _groups(runs))
    assert ("motion_regressor" in rel) != runs["frozen"], rel
    regressor = [n for n in g if n.startswith("motion_regressor.")]
    assert bool(regressor) != runs["frozen"]


def test_step_params_and_state_match_jax(runs):
    opt, js = runs["opt"], [s for s, _ in runs["jax"]]
    sd_g, sd_d = runs["port"][0][3]
    n = P.check_state(opt, sd_g, js, 0, runs["model"], "g", _groups(runs))
    n += P.check_state(opt, sd_d, js, 0, runs["d"], "d")
    assert n > 1000


@pytest.mark.parametrize("k", [0, 1])
def test_step_stats_and_vectors_match_jax(runs, k):
    """BN statistics and spectral vectors after each step (the second from
    JAX's state after the first) within 1e-5, the regressor's included;
    frozen, its parameters stay bit for bit as they started while its
    spectral vectors move by their power iterations, as JAX's do."""
    opt, js = runs["opt"], runs["jax"][k][0]
    sd_g, _ = runs["port"][k][3]
    model = runs["model"]
    want = {}
    for name, sub in P.g_groups(model):
        sd = from_jax_variables(P.np_tree({c: t[name] for c, t in (
            ("params", js.g_params), ("batch_stats", js.g_stats),
            ("spectral", js.g_spectral)) if name in t}), opt, sub)
        want.update({f"{name}.{n}": v for n, v in sd.items()})
    params = {n for n, _ in model.named_parameters()}
    moved = 0
    for name, got in sd_g.items():
        if name not in params:
            np.testing.assert_allclose(got.numpy(), want[name].numpy(), rtol=0,
                                       atol=P.STATE_TOL[0], err_msg=name)
            if name.startswith("motion_regressor."):
                moved += int(not torch.equal(got, runs["init"][name]))
        elif runs["frozen"] and name.startswith("motion_regressor."):
            assert torch.equal(got, runs["init"][name]), name
            np.testing.assert_array_equal(got.numpy(), want[name].numpy(), err_msg=name)
    assert moved > 0


def test_frozen_regressor_stays_out_of_adam(runs):
    tr = runs["tr"]
    names = [n for n, _ in runs["model"].named_parameters()]
    reg = [n for n in names if n.startswith("motion_regressor.")]
    assert reg
    if runs["frozen"]:
        assert tr.g_names == [n for n in names if n not in reg]
    else:
        assert tr.g_names == names
