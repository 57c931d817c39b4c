"""The motion GAN (``--model-type SPADE_unet_mask_motion`` / ``unet_motion``)
against the JAX package: ``losses/synthesis.py:MotionLoss`` and
``end_point_error``, ``models/motion.py:MotionRegressor.forward_train`` and
``motion_losses``, and the port's ``Trainer(task='motion')`` against the JAX
``Trainer`` (tests/torch_stage_parity.py's conventions and checks).

* ``end_point_error`` (2- and 3-channel uv·m motion) and ``MotionLoss``
  ('λ_MotionL1', 'λ_EndPointError'): values and input gradients within
  1e-6 relative; the inputs never have an exactly zero difference, where
  ``jnp.linalg.norm``'s gradient is NaN and torch's 0; an unknown name is a
  ``ValueError`` in both;
* ``forward_train`` of the depth-4 SPADE and plain UNets of width 4 at 32²
  with and without hints, numpy-drawn JAX variables: every pred tensor
  within 1e-4 of its largest magnitude, the spectral vectors it leaves
  within 1e-5; ``motion_losses`` within 1e-5 relative;
* two G+D steps of the SPADE regressor at ``tiny_options`` with
  '10.0_EndPointError' and the 2-channel multiscale D: losses of both
  steps, gradients and parameters after the first, spectral vectors after
  both. The motion task builds no VGG."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_stage_parity as P
from conftest import tiny_options
from slrsfs_tpu.config import Options as JaxOptions
from slrsfs_tpu.engine.trainer import Trainer as JaxTrainer
from slrsfs_tpu.losses import synthesis as jsyn
from slrsfs_tpu.models import motion as jmot
from slrsfs_tpu_torch.config import Options
from slrsfs_tpu_torch.engine.trainer import Trainer
from slrsfs_tpu_torch.io.convert import from_jax_variables
from slrsfs_tpu_torch.losses import synthesis as psyn
from slrsfs_tpu_torch.models import motion as pmot
from slrsfs_tpu_torch.nn.discriminators import MultiscaleDiscriminator

torch.set_num_threads(1)

B, HW = 2, 32
SMALL = dict(W=HW, motionW=HW, motionH=HW, motion_num_filters=4, motion_unet_downs=4)


def _pair(seed, channels=2):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((B, 9, 7, channels)).astype(np.float32)
    b = rng.standard_normal((B, 9, 7, channels)).astype(np.float32)
    if channels == 3:  # a uv·m mask channel
        a[..., 2] = rng.random((B, 9, 7)) > 0.3
        b[..., 2] = rng.random((B, 9, 7)) > 0.3
        a[..., 2] += 0.5  # never an exactly zero folded difference
    return a, b


def _grads(fn_p, fn_j, a, b):
    x = torch.from_numpy(a).requires_grad_(True)
    v = fn_p(x, torch.from_numpy(b))
    v.backward()
    jv, jg = jax.value_and_grad(lambda t: fn_j(t, jnp.asarray(b)))(jnp.asarray(a))
    return float(v), x.grad.numpy(), float(jv), np.asarray(jg)


@pytest.mark.parametrize("channels", [2, 3])
def test_end_point_error_matches_jax(channels):
    a, b = _pair(1, channels)
    v, g, jv, jg = _grads(psyn.end_point_error, jsyn.end_point_error, a, b)
    np.testing.assert_allclose(v, jv, rtol=1e-6)
    np.testing.assert_allclose(g, jg, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("spec", [("10.0_EndPointError",), ("1.0_MotionL1",),
                                  ("2.0_MotionL1", "0.5_EndPointError")])
def test_motion_loss_matches_jax(spec):
    a, b = _pair(2)
    got = psyn.MotionLoss(spec)(torch.from_numpy(a), torch.from_numpy(b))
    want = jsyn.MotionLoss(spec)(jnp.asarray(a), jnp.asarray(b))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6, err_msg=k)
    v, g, jv, jg = _grads(lambda x, y: psyn.MotionLoss(spec)(x, y)["Total Loss"],
                          lambda x, y: jsyn.MotionLoss(spec)(x, y)["Total Loss"], a, b)
    np.testing.assert_allclose(g, jg, rtol=1e-6, atol=1e-9)


def test_unknown_motion_loss_raises_value_error():
    a, b = _pair(3)
    with pytest.raises(ValueError, match="unknown motion loss: l1"):
        psyn.MotionLoss(("1.0_l1",))
    with pytest.raises(ValueError, match="unknown motion loss: l1"):
        jsyn.MotionLoss(("1.0_l1",))(jnp.asarray(a), jnp.asarray(b))


def motion_batch(seed: int, hints: bool = True):
    """One view, a ground-truth motion with a slow band, and hints. (An
    exactly static band makes D's first bias gradient a near-total
    cancellation: 1e-2 against terms of 1e-2, which the frameworks' sum
    orders do not reproduce.)"""
    rng = np.random.default_rng(seed)
    motions = (rng.standard_normal((B, HW, HW, 2)) * 1.5).astype(np.float32)
    motions[:, :8] *= 0.05  # a slow band
    batch = {"images": [(rng.standard_normal((B, HW, HW, 3)) * 0.25).astype(np.float32)],
             "motions": motions}
    if hints:
        batch["hints"] = (motions * (rng.random((B, HW, HW, 1)) < 0.1)).astype(np.float32)
    return batch


@pytest.mark.parametrize("model_type,hints", [("SPADE_unet_mask_motion", True),
                                              ("unet_motion", True),
                                              ("SPADE_unet_mask_motion", False)])
def test_forward_train_matches_jax(model_type, hints):
    kw = dict(SMALL, model_type=model_type, div_flow=2.0,
              motion_losses=("10.0_EndPointError", "1.0_MotionL1"))
    if not hints:
        kw["use_hint_as_motion_input"] = False
    jopt = JaxOptions(**kw)
    popt = Options(**dataclasses.asdict(jopt))
    batch = motion_batch(4, hints)
    jmodel = jmot.MotionRegressor(jopt)
    variables = P.numpy_init(jmodel, P.jnp_batch(batch), seed=7)
    (jpred, want), ups = jax.jit(lambda v, b: jmodel.apply(
        v, b, True, False, method=jmodel.forward_train, mutable=["spectral"]))(
        variables, P.jnp_batch(batch))
    model = pmot.MotionRegressor(popt)
    model.load_state_dict(from_jax_variables(P.np_tree(variables), popt, model))
    with torch.no_grad():
        pred, got = model.forward_train(P.port_batch(batch), train=True)
    P.check_pred(got, P.np_tree(want))
    assert ("HintMotion" in got) == hints
    np.testing.assert_allclose(pred.numpy(), np.asarray(jpred), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(jpred)).max())
    after = from_jax_variables(P.np_tree({"params": variables["params"], **ups}), popt, model)
    for name, t in model.state_dict().items():
        if name.endswith(("weight_u", "weight_v")):
            np.testing.assert_allclose(t.numpy(), after[name].numpy(), rtol=0, atol=1e-5,
                                       err_msg=name)
    gt = P.port_batch(batch)["motions"]
    ml = pmot.motion_losses(popt, pred, gt)
    jml = jmot.motion_losses(jopt, jpred, jnp.asarray(batch["motions"]))
    assert set(ml) == set(jml) == {"EndPointError", "MotionL1", "Total Loss", "PSNR_motion"}
    for k in jml:
        np.testing.assert_allclose(float(ml[k]), float(jml[k]), rtol=1e-5, err_msg=k)


@pytest.fixture(scope="module")
def runs():
    jopt = tiny_options(batch_size=B, model_type="SPADE_unet_mask_motion",
                        motion_losses=("10.0_EndPointError",), **SMALL)
    jtr = JaxTrainer(jopt, jmot.MotionRegressor(jopt), steps_per_epoch=10, task="motion")
    batch = motion_batch(5)
    state = P.settled_state(jtr.init_state(jax.random.PRNGKey(0), P.jnp_batch(batch)))
    jruns = P.jax_steps(jtr, state, batch)
    opt = Options(**dataclasses.asdict(jopt))
    model = pmot.MotionRegressor(opt)
    d = MultiscaleDiscriminator(opt, in_channels=2)
    P.load_port(model, d, opt, state)
    tr = Trainer(opt, model, steps_per_epoch=10, d_model=d, deterministic=True, device="cpu",
                 task="motion")
    port = P.port_steps(tr, batch, sync=lambda k: P.sync_port(tr, opt, jruns[k - 1][0]))
    return dict(opt=opt, model=model, d=d, tr=tr, jax=jruns, port=port)


@pytest.mark.parametrize("k", [0, 1])
def test_step_losses_match_jax(runs, k):
    P.check_losses(runs["port"][k][0], runs["jax"][k][1],
                   ("EndPointError", "PSNR_motion", "GAN", "GAN_Feat", "D_Fake", "D_real"))
    assert runs["tr"].vgg is None


def test_step_gradients_and_params_match_jax(runs):
    _, g, d, (sd_g, sd_d) = runs["port"][0]
    groups = P.g_groups(runs["model"])
    assert [n for n, _ in groups] == ["motion_predictor"]
    P.check_grads(runs["opt"], runs["model"], runs["d"], runs["jax"][0][0], g, d, groups)
    js = [s for s, _ in runs["jax"]]
    n = P.check_state(runs["opt"], sd_g, js, 0, runs["model"], "g", groups)
    n += P.check_state(runs["opt"], sd_d, js, 0, runs["d"], "d")
    assert n > 1000


def test_second_step_spectral_vectors_match_jax(runs):
    js = runs["jax"][1][0]
    sd_g, sd_d = runs["port"][1][3]
    for sd, module, cols in ((sd_g, runs["model"], {"params": js.g_params,
                                                    "spectral": js.g_spectral}),
                             (sd_d, runs["d"], {"params": js.d_params,
                                                "spectral": js.d_spectral})):
        want = from_jax_variables(P.np_tree(cols), runs["opt"], module)
        for name in sd:
            if name.endswith(("weight_u", "weight_v")):
                np.testing.assert_allclose(sd[name].numpy(), want[name].numpy(), rtol=0,
                                           atol=P.STATE_TOL[0], err_msg=name)
