"""The port's SLR stage-3 training (``models/slr.py``: the loss primitives,
``slr_extra_losses``, ``SLRTrainable.forward_train``; the trainer's
extra-loss hook) against the JAX package on the same inputs and weights.

Conventions of tests/test_torch_trainer.py: zero BN noise on both sides
(the JAX ``NoiseBN`` called with ``deterministic=True`` through a
test-only ``flax.linen.intercept_methods`` interceptor, the port with
``deterministic=True``), JAX weights carried over by ``from_jax_variables``.

* ``smooth_l1``, ``total_variation``, ``decayed_weight``: 1e-6;
* ``slr_extra_losses`` term by term: 1e-5 relative, over the CLI's
  stage-3 set, AlphaMSE with its decay, AlphaL1, MRADC and a
  ``rock_weight`` override, at epochs 0 and 5;
* ``forward_train`` (the reference archs at ngf 16, W = 32, B = 2, T = 4;
  JAX variables drawn with numpy into ``jax.eval_shape``'s shapes, as
  tests/test_torch_slr.py does, since a jitted JAX init of the graph takes
  minutes): every ``pred`` tensor within 1e-4 of its largest magnitude
  (``FluidImg`` and ``PredImg``, from the fluid pconv decoder, 1e-3: see
  ``DECODED_TOL``), and the BN statistics and spectral vectors its seven sub-network calls
  leave within 1e-5 (a wrong call order moves them by far more); with
  ``use_alpha0_as_blending_weight`` on and off, dense and compact moving
  sets, ``AKLloss`` and ``clamp_alpha``;
* the G+D step with ``extra_losses_fn=slr_extra_losses`` after one and two
  steps (``steps_per_epoch`` 1, so the second step decays the region
  weights), with test_torch_trainer.py's tolerances;
* the compact step equals the dense step exactly."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax import linen as nn
from flax.traverse_util import flatten_dict, unflatten_dict

from conftest import tiny_options
from slrsfs_tpu.cli.train import attach_moving_sets as jax_attach
from slrsfs_tpu.config import Options as JaxOptions
from slrsfs_tpu.engine.trainer import Trainer as JaxTrainer
from slrsfs_tpu.losses.synthesis import SynthesisLoss as JaxSynthesisLoss
from slrsfs_tpu.models import slr as jslr
from slrsfs_tpu.nn.norm import NoiseBN as JaxNoiseBN
from slrsfs_tpu.nn.vgg import VGG19Features as JaxVGG
from slrsfs_tpu_torch.cli.train import (
    SLR_MODEL_TYPE,
    attach_moving_sets,
    stage_options,
    to_device_batch,
)
from slrsfs_tpu_torch.config import Options
from slrsfs_tpu_torch.engine.trainer import Trainer
from slrsfs_tpu_torch.io.convert import from_jax_variables
from slrsfs_tpu_torch.losses.synthesis import SynthesisLoss
from slrsfs_tpu_torch.models import slr as pslr
from slrsfs_tpu_torch.nn.discriminators import MultiscaleDiscriminator
from slrsfs_tpu_torch.nn.vgg import VGG19Features

torch.set_num_threads(1)

LOSS_RTOL = 1e-4
GRAD_REL = 5e-4
STATE_TOL = (1e-5, 5e-4)  # after one step, after two
B, HW, T = 2, 32, 4
# The fluid pconv decoder's output, and the composite made of it, reach
# 2.6e-4 of their largest magnitude here (every other pred tensor <= 4e-5):
# the two frameworks sum the decoder's convolutions in other float32 orders
# (tests/test_torch_slr.py holds the decoders at 2e-3).
DECODED_TOL = 1e-3


def _zero_noise(next_fun, args, kwargs, context):
    """Calls every JAX NoiseBN with deterministic=True (zero noise)."""
    if isinstance(context.module, JaxNoiseBN) and context.method_name == "__call__":
        args = (args[0], args[1], True) + tuple(args[3:])
    return next_fun(*args, **kwargs)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _port_batch(batch):
    return to_device_batch({k: ([np.asarray(x) for x in v] if k == "images"
                                else np.asarray(v)) for k, v in batch.items()},
                           "cpu")


def slr_batch(seed: int, static_top: bool = True):
    """A stage-3 batch as numpy: three views, counts, motion (its top half
    static), a rock mask and a mean video."""
    rng = np.random.default_rng(seed)
    idx = np.zeros((B, 3), np.int32)
    idx[:, 1] = rng.integers(1, 4, size=B)
    idx[:, 2] = 4
    motions = (rng.standard_normal((B, HW, HW, 2)) * 0.8).astype(np.float32)
    if static_top:
        motions[:, : HW // 2] = 0.0
    return {
        "images": [(rng.standard_normal((B, HW, HW, 3)) * 0.25).astype(np.float32)
                   for _ in range(3)],
        "index": idx,
        "motions": motions,
        "mask_rock": (rng.random((B, HW, HW, 1)) < 0.3).astype(np.float32),
        "mean_video": (rng.standard_normal((B, HW, HW, 3)) * 0.25).astype(np.float32),
    }


def _jnp_batch(batch):
    return {k: [jnp.asarray(x) for x in v] if k == "images" else jnp.asarray(v)
            for k, v in batch.items()}


# ---- the loss primitives and the loss set ----------------------------------

def test_loss_primitives_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 7, 3)).astype(np.float32)
    y = rng.standard_normal((2, 9, 7, 3)).astype(np.float32)
    for gamma in (0.1, 0.3):
        np.testing.assert_allclose(
            pslr.smooth_l1(_t(x), _t(y), gamma).numpy(),
            np.asarray(jslr.smooth_l1(x, y, gamma)), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(pslr.total_variation(_t(x))),
                               float(jslr.total_variation(x)), rtol=1e-6)
    for base, decay, epoch in ((30.0, 20.0, 0), (30.0, 20.0, 7), (3.0, 20.0, 5),
                               (1.0, 10.0, 3)):
        np.testing.assert_allclose(
            float(pslr.decayed_weight(base, decay, epoch)),
            float(jslr.decayed_weight(base, decay, jnp.int32(epoch))), rtol=1e-6)


EXTRA_CASES = {
    "stage3_cli": (stage_options(SLR_MODEL_TYPE), None),
    "alpha_mse_decay": (dict(AlphaMSEloss=2.0, AlphaWeightDecay=10.0), None),
    "alpha_l1": (dict(AlphaL1loss=1.5, RockRegionloss=5.0,
                      RockRegionlosstarget=0.4), None),
    "mradc": (dict(MRADCloss=1.0, ADCloss=0.5), None),
    "rock_weight": (dict(FluidRegionloss=3.0, RockRegionlossDecay=20.0), 7.0),
}


@pytest.fixture(scope="module")
def synth_pair(vgg_vars32):
    """The synthesis loss of both packages on the same VGG weights."""
    opt = Options()
    vgg = VGG19Features()
    vgg.load_state_dict(from_jax_variables(_np(vgg_vars32), opt, vgg))
    return (JaxSynthesisLoss(opt.losses, JaxVGG(), vgg_vars32),
            SynthesisLoss(opt.losses, vgg.requires_grad_(False)))


def _loss_pred(seed: int):
    rng = np.random.default_rng(seed)
    shape = (B, HW, HW, 1)
    pred = {
        "SmallMotionAlpha": (rng.random(shape) < 0.3),
        "RockMask": (rng.random(shape) < 0.4),
        "CompositeFluidAlpha_I0": rng.uniform(0, 1, shape),
        "GTAlpha": rng.choice([0.25, 0.5, 1.0], shape),
        "AlphaFluidLogits_f": rng.standard_normal(shape) * 2.0,
        "AlphaBG_f": rng.uniform(0, 1, shape),
        "BGImg_f": rng.uniform(-1, 1, (B, HW, HW, 3)),
        "MeanImg": rng.uniform(-1, 1, (B, HW, HW, 3)),
        "AlphaFluidMask": (rng.random(shape) < 0.8),
        "AlphaFluidWarped": rng.standard_normal(shape),
        "GenFluidAlphaRaw": rng.standard_normal(shape),
    }
    return {k: v.astype(np.float32) for k, v in pred.items()}


@pytest.mark.parametrize("epoch", [0, 5])
@pytest.mark.parametrize("case", sorted(EXTRA_CASES))
def test_slr_extra_losses_match_jax(case, epoch, synth_pair):
    kw, rock_weight = EXTRA_CASES[case]
    jsynth, psynth = synth_pair
    pred = _loss_pred(7)
    want = jslr.slr_extra_losses(JaxOptions(**kw), {k: jnp.asarray(v) for k, v in pred.items()},
                                 jsynth, rock_weight=rock_weight, epoch=jnp.int32(epoch))
    ppred = {k: _t(v).requires_grad_(True) for k, v in pred.items()}
    got = pslr.slr_extra_losses(Options(**kw), ppred, psynth, rock_weight=rock_weight,
                                epoch=epoch)
    assert set(got) == set(want)
    assert len(got) > 1
    for k in want:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    got["Total Extra"].backward()
    # the decoder-consistency terms stop the gradient at the warped alpha
    assert ppred["AlphaFluidWarped"].grad is None
    if "Alpha Decoder Consistency Loss" in got:
        assert ppred["GenFluidAlphaRaw"].grad.abs().sum() > 0


# ---- forward_train ----------------------------------------------------------

FT_CASES = {
    "alpha0_dense": (dict(use_alpha0_as_blending_weight=True), False),
    "no_alpha0_compact": (dict(use_alpha0_as_blending_weight=False), True),
    "akl_clamp_alpha0": (dict(use_alpha0_as_blending_weight=True, AKLloss=1.0,
                              clamp_alpha=0.3), False),
}


def _ft_opts(**kw):
    base = dict(ngf=16, W=HW, model_type=SLR_MODEL_TYPE, **stage_options(SLR_MODEL_TYPE))
    base.update(kw)
    return JaxOptions(**base), Options(**base)


def _numpy_init(model, batch, seed):
    shapes = jax.eval_shape(
        lambda r, b: model.init(r, b, True, False, method=model.forward_train),
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}, batch)
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
        elif name == "stored_mean":
            a = rng.standard_normal(leaf.shape) * 0.1
        else:
            a = np.zeros(leaf.shape)
        return jnp.asarray(a, leaf.dtype)

    variables = jax.tree.map(np.asarray, jax.tree_util.tree_map_with_path(draw, shapes))
    # spectral vectors near each kernel's top singular pair (30 power
    # iterations, as the port's init_random_weights sets them): random ones
    # give a sigma far below the true norm, and the decoders then amplify
    # summation-order differences
    params = flatten_dict(variables["params"])
    spectral = flatten_dict(variables["spectral"])
    for path in [p for p in spectral if p[-1] == "u"]:
        k = params[path[:-2] + ("kernel",)]
        w_mat = k.transpose(3, 0, 1, 2).reshape(k.shape[3], -1) if k.ndim == 4 else k.T
        u = spectral[path]
        for _ in range(30):
            v = w_mat.T @ u
            v = v / np.linalg.norm(v)
            u = w_mat @ v
            u = u / np.linalg.norm(u)
        spectral[path], spectral[path[:-1] + ("v",)] = u, v
    variables["spectral"] = unflatten_dict(spectral)
    return jax.tree.map(jnp.asarray, variables)


@pytest.fixture(scope="module")
def ft_variables():
    """Numpy-drawn JAX variables for the SLR graph: one set with the
    2-channel alpha head, one with AKLloss's 3 channels."""
    batch = _jnp_batch(slr_batch(3))
    out = {}
    for akl in (0.0, 1.0):
        jopt, _ = _ft_opts(AKLloss=akl)
        out[akl] = _numpy_init(jslr.SLRTrainable(jopt, train_max_steps=T), batch,
                               seed=11 + int(akl))
    return out


@pytest.mark.parametrize("case", sorted(FT_CASES))
def test_forward_train_matches_jax(case, ft_variables):
    kw, compact = FT_CASES[case]
    jopt, popt = _ft_opts(**kw)
    variables = ft_variables[popt.AKLloss]
    batch = slr_batch(3)
    if compact:
        batch = jax_attach(batch)
        assert "mov_pos" in batch
    jmodel = jslr.SLRTrainable(jopt, train_max_steps=T)

    @jax.jit
    def jforward(v, b):
        with nn.intercept_methods(_zero_noise):
            return jmodel.apply(v, b, True, False, method=jmodel.forward_train,
                                mutable=["batch_stats", "spectral"],
                                rngs={"noise": jax.random.PRNGKey(2)})

    (_, want), ups = jforward(variables, _jnp_batch(batch))
    model = pslr.SLRTrainable(popt, train_max_steps=T)
    model.load_state_dict(from_jax_variables(_np(variables), popt, model))
    with torch.no_grad():
        _, got = model.forward_train(_port_batch(batch), train=True,
                                     deterministic=True, plain=True)
    assert set(got) == set(want)
    assert ("AlphaLogSigma" in got) == (popt.AKLloss > 0)
    for k, w in want.items():
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()), 1e-6)
        tol = DECODED_TOL if k in ("FluidImg", "PredImg") else 1e-4
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0, atol=tol * scale,
                                   err_msg=k)
    # the seven sub-network calls' BN statistics and spectral vectors
    after = from_jax_variables(_np({"params": variables["params"], **ups}), popt, model)
    params = {n for n, _ in model.named_parameters()}
    n_state = 0
    for name, t in model.state_dict().items():
        if name in params:
            continue
        n_state += 1
        np.testing.assert_allclose(t.numpy(), after[name].numpy(), rtol=0,
                                   atol=STATE_TOL[0], err_msg=name)
    assert n_state > 100


# ---- the G+D step -----------------------------------------------------------

def _step_opts():
    return tiny_options(W=HW, batch_size=B, model_type=SLR_MODEL_TYPE, AlphaL1loss=1.0,
                        **stage_options(SLR_MODEL_TYPE))


def _adam_mu(opt_state):
    for s in jax.tree.leaves(opt_state,
                             is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState)):
        if isinstance(s, optax.ScaleByAdamState):
            return s.mu
    raise AssertionError("no Adam state")


@pytest.fixture(scope="module")
def runs(vgg_vars32):
    """Two JAX steps and two port steps from the same state and batch, with
    one epoch a step."""
    jopt = _step_opts()
    jtr = JaxTrainer(jopt, jslr.SLRTrainable(jopt, train_max_steps=T),
                     steps_per_epoch=1, extra_losses_fn=jslr.slr_extra_losses)
    jtr.load_vgg(vgg_vars32)
    batch = slr_batch(5, static_top=False)
    jbatch = _jnp_batch(batch)
    state = jtr.init_state(jax.random.PRNGKey(0), jbatch)
    step_fn = jtr.make_train_step()

    @jax.jit
    def jstep(s, b):
        with nn.intercept_methods(_zero_noise):
            return step_fn(s, b, jax.random.PRNGKey(1))

    j1, jl1 = jstep(state, jbatch)
    j2, jl2 = jstep(j1, jbatch)

    opt = Options(**dataclasses.asdict(jopt))
    model = pslr.SLRTrainable(opt, train_max_steps=T)
    model.load_state_dict(from_jax_variables(_np(
        {"params": state.g_params, "batch_stats": state.g_stats,
         "spectral": state.g_spectral}), opt, model))
    d = MultiscaleDiscriminator(opt)
    d.load_state_dict(from_jax_variables(_np(
        {"params": state.d_params, "spectral": state.d_spectral}), opt, d))
    vgg = VGG19Features()
    vgg.load_state_dict(from_jax_variables(_np(vgg_vars32), opt, vgg))
    tr = Trainer(opt, model, steps_per_epoch=1, vgg=vgg, d_model=d,
                 deterministic=True, device="cpu",
                 extra_losses_fn=pslr.slr_extra_losses)
    pb = _port_batch(batch)
    p_logs, p_grads, p_state = [], [], []
    for _ in range(2):
        p_logs.append(tr.train_step(pb))
        p_grads.append(tr.last_grads)
        p_state.append(({k: v.clone() for k, v in model.state_dict().items()},
                        {k: v.clone() for k, v in d.state_dict().items()}))
    return dict(opt=opt, model=model, d=d, tr=tr,
                jax=[(j1, _np(jl1)), (j2, _np(jl2))], p_logs=p_logs,
                p_grads=p_grads, p_state=p_state)


@pytest.mark.parametrize("k", [0, 1])
def test_slr_step_losses_match_jax(runs, k):
    want = runs["jax"][k][1]
    got = runs["p_logs"][k]
    assert set(got) == set(want)
    for name in ("AlphaL1loss", "AlphaTV", "L1_bg", "Perceptual_bg", "FluidRegionLoss",
                 "RockRegionLoss", "Alpha Decoder Consistency Loss", "GAN", "D_Fake"):
        assert name in got, sorted(got)
    for name in want:
        np.testing.assert_allclose(float(got[name]), float(want[name]),
                                   rtol=LOSS_RTOL, atol=1e-6, err_msg=name)


def _named(module, tensors):
    names = [n for n, p in module.named_parameters() if p.requires_grad]
    return dict(zip(names, tensors))


@pytest.mark.parametrize("k", [0, 1])
def test_slr_step_gradients_match_jax(runs, k):
    js = runs["jax"][k][0]
    opt = runs["opt"]
    for which, module, vars_ in (
            ("g", runs["model"], {"params": _adam_mu(js.opt_g),
                                  "batch_stats": js.g_stats,
                                  "spectral": js.g_spectral}),
            ("d", runs["d"], {"params": _adam_mu(js.opt_d),
                              "spectral": js.d_spectral})):
        want = from_jax_variables(_np(vars_), opt, module)
        got = _named(module, runs["p_grads"][k][which])
        assert got
        scale = max(np.abs(want[name].numpy()).max() for name in got)
        for name, g in got.items():
            np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=0,
                                       atol=GRAD_REL * scale, err_msg=f"{which} {name}")


def _jax_vars(js, which, params=None):
    if which == "g":
        return {"params": js.g_params if params is None else params,
                "batch_stats": js.g_stats, "spectral": js.g_spectral}
    return {"params": js.d_params if params is None else params,
            "spectral": js.d_spectral}


@pytest.mark.parametrize("k", [0, 1])
def test_slr_step_stats_vectors_and_params_match_jax(runs, k):
    """test_torch_trainer.py's rule: parameters whose every step's gradient
    is above 1e-2 of the network's largest within 1e-6 (+ 0.01·lr after two
    steps), all within 2·k·lr + 1e-6; BN statistics and spectral vectors
    within 1e-5, then 5e-4."""
    opt = runs["opt"]
    js = runs["jax"][k][0]
    lr = {"g": opt.lr_g, "d": opt.lr_d}
    n_checked = 0
    for which, module, sd in (("g", runs["model"], runs["p_state"][k][0]),
                              ("d", runs["d"], runs["p_state"][k][1])):
        want = from_jax_variables(_np(_jax_vars(js, which)), opt, module)
        grads = []
        for j in range(k + 1):
            sj = runs["jax"][j][0]
            mu = _adam_mu(sj.opt_g if which == "g" else sj.opt_d)
            grads.append(from_jax_variables(_np(_jax_vars(sj, which, mu)), opt, module))
        params = {n for n, _ in module.named_parameters()}
        scales = [max(np.abs(gj[n].numpy()).max() for n in params) for gj in grads]
        for name, got in sd.items():
            w = want[name].numpy()
            got = got.numpy()
            if name not in params:
                np.testing.assert_allclose(got, w, rtol=0, atol=STATE_TOL[k],
                                           err_msg=name)
                continue
            big = np.ones(w.shape, bool)
            for gj, scale in zip(grads, scales):
                big &= np.abs(gj[name].numpy()) > 1e-2 * scale
            n_checked += int(big.sum())
            np.testing.assert_allclose(got[big], w[big], rtol=0,
                                       atol=1e-6 + 1e-2 * k * lr[which],
                                       err_msg=f"{which} {name}")
            np.testing.assert_allclose(got, w, rtol=0,
                                       atol=2 * (k + 1) * lr[which] + 1e-6,
                                       err_msg=f"{which} {name}")
    assert n_checked > 1000


def test_slr_compact_step_equals_dense_step(runs):
    """Static top half: the SLR step with host-attached moving sets
    (compact K7) equals the dense step bit for bit."""
    tr = runs["tr"]
    np_batch = slr_batch(13)
    sparse = attach_moving_sets(dict(np_batch))
    assert "mov_pos" in sparse and sparse["mov_valid"].sum(1).max() <= HW * HW // 2
    state = ({k: v.clone() for k, v in tr.model.state_dict().items()},
             {k: v.clone() for k, v in tr.d_model.state_dict().items()})
    results = []
    for b in (np_batch, sparse):
        tr.model.load_state_dict(state[0])
        tr.d_model.load_state_dict(state[1])
        with torch.no_grad():
            _, logs, gen = tr.g_losses(to_device_batch(b, "cpu"))
        results.append(({k: float(v) for k, v in logs.items()}, gen))
    assert "RockRegionLoss" in results[0][0]
    assert results[0][0] == results[1][0]
    assert torch.equal(results[0][1], results[1][1])
