"""The port's G+D training step against the JAX ``Trainer``.

Both start from the same G, D and VGG weights (the JAX trainer's init,
carried over by ``from_jax_variables``) at ``tiny_options(W=32,
batch_size=2)`` with T = 4, and run with zero BN noise: the JAX package
always draws its noise from flax's RNG, which the port cannot reproduce, so
its ``NoiseBN`` is called with ``deterministic=True`` through a test-only
``flax.linen.intercept_methods`` interceptor, and the port's trainer runs
``deterministic``. After one and after two steps:

* every logged loss within 1e-4 relative;
* G and D gradients (Adam's first moment, which with b1 = 0 is the last
  gradient) within 5e-4 of the network's largest gradient entry (the two
  frameworks sum convolutions and reductions in different orders; the
  largest difference seen is 8e-5 of it);
* parameters: with b1 = 0 Adam's first update is lr·g/(|g| + 1e-8), about
  ±lr, so a gradient whose sign differs at round-off (conv biases ahead of
  a BN have true gradients of 0 and round-off ones of ~1e-7) moves a
  parameter by 2·lr. Where every step's |g| is above 1e-2 of the
  network's largest gradient entry, parameters are held within 1e-6 after
  one step (the update is ±lr) and within 1e-6 + 0.01·lr after two (the
  second update scales with g2/|g1, g2|, whose relative error there is
  below 1 %); everywhere within 2·k·lr + 1e-6 after k steps;
* BN statistics and spectral vectors within 1e-5 after one step; after two
  within 5e-4, since a bias that moved 2·lr the other way in step one
  shifts the next batch mean by that much and the running mean by 0.1 of
  it.

The compact moving-set step equals the dense step exactly, as
``tests/test_trainer.py:382`` shows for JAX; ``attach_moving_sets`` and the
dataset's items equal JAX's exactly."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import optax
from flax import linen as nn

from conftest import tiny_batch
from slrsfs_tpu.cli.train import attach_moving_sets as jax_attach
from slrsfs_tpu.nn.norm import NoiseBN as JaxNoiseBN
from slrsfs_tpu_torch.cli.train import attach_moving_sets, to_device_batch
from slrsfs_tpu_torch.config import Options
from slrsfs_tpu_torch.engine.trainer import Trainer, make_lr_schedule
from slrsfs_tpu_torch.io.convert import from_jax_variables
from slrsfs_tpu_torch.models.baseline import BaselineTrainable
from slrsfs_tpu_torch.nn.discriminators import MultiscaleDiscriminator
from slrsfs_tpu_torch.nn.vgg import VGG19Features

torch.set_num_threads(1)

LOSS_RTOL = 1e-4
GRAD_REL = 5e-4
STATE_TOL = (1e-5, 5e-4)  # after one step, after two


def _zero_noise(next_fun, args, kwargs, context):
    """Calls every JAX NoiseBN with deterministic=True (zero noise)."""
    if isinstance(context.module, JaxNoiseBN) and context.method_name == "__call__":
        args = (args[0], args[1], True) + tuple(args[3:])
    return next_fun(*args, **kwargs)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _adam_mu(opt_state):
    for s in jax.tree.leaves(opt_state,
                             is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState)):
        if isinstance(s, optax.ScaleByAdamState):
            return s.mu
    raise AssertionError("no Adam state")


def _port_batch(batch):
    return to_device_batch({k: ([np.asarray(x) for x in v] if k == "images"
                                else np.asarray(v)) for k, v in batch.items()},
                           "cpu")


@pytest.fixture(scope="module")
def runs(base_trainer, vgg_vars32):
    """Two JAX steps and two port steps from the same state and batch."""
    jtr, state, batch = (base_trainer["trainer"], base_trainer["state"],
                         base_trainer["batch"])
    step_fn = jtr.make_train_step()

    @jax.jit
    def jstep(s, b):
        with nn.intercept_methods(_zero_noise):
            return step_fn(s, b, jax.random.PRNGKey(1))

    j1, jl1 = jstep(state, batch)
    j2, jl2 = jstep(j1, batch)

    opt = Options(**dataclasses.asdict(base_trainer["opt"]))
    model = BaselineTrainable(opt, train_max_steps=4)
    model.load_state_dict(from_jax_variables(_np(
        {"params": state.g_params, "batch_stats": state.g_stats,
         "spectral": state.g_spectral}), opt, model))
    d = MultiscaleDiscriminator(opt)
    d.load_state_dict(from_jax_variables(_np(
        {"params": state.d_params, "spectral": state.d_spectral}), opt, d))
    vgg = VGG19Features()
    vgg.load_state_dict(from_jax_variables(_np(vgg_vars32), opt, vgg))
    tr = Trainer(opt, model, steps_per_epoch=10, vgg=vgg, d_model=d,
                 deterministic=True, device="cpu")
    pb = _port_batch(batch)
    p_logs, p_grads, p_state = [], [], []
    for _ in range(2):
        p_logs.append(tr.train_step(pb))
        p_grads.append(tr.last_grads)
        p_state.append(({k: v.clone() for k, v in model.state_dict().items()},
                        {k: v.clone() for k, v in d.state_dict().items()}))
    return dict(opt=opt, model=model, d=d, tr=tr, batch=batch,
                jax=[(j1, _np(jl1)), (j2, _np(jl2))], p_logs=p_logs,
                p_grads=p_grads, p_state=p_state)


def _named(module, tensors):
    names = [n for n, p in module.named_parameters() if p.requires_grad]
    return dict(zip(names, tensors))


@pytest.mark.parametrize("k", [0, 1])
def test_losses_match_jax(runs, k):
    want = runs["jax"][k][1]
    got = runs["p_logs"][k]
    for name in ("L1", "Perceptual", "GAN", "GAN_Feat", "D_Fake", "D_real",
                 "psnr", "ssim", "Total Loss"):
        np.testing.assert_allclose(float(got[name]), float(want[name]),
                                   rtol=LOSS_RTOL, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("k", [0, 1])
def test_gradients_match_jax(runs, k):
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
                                       atol=GRAD_REL * scale,
                                       err_msg=f"{which} {name}")


def _jax_vars(js, which, params=None):
    if which == "g":
        return {"params": js.g_params if params is None else params,
                "batch_stats": js.g_stats, "spectral": js.g_spectral}
    return {"params": js.d_params if params is None else params,
            "spectral": js.d_spectral}


@pytest.mark.parametrize("k", [0, 1])
def test_stats_vectors_and_params_match_jax(runs, k):
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
            grads.append(from_jax_variables(_np(_jax_vars(sj, which, mu)), opt,
                                            module))
        params = {n for n, _ in module.named_parameters()}
        scales = [max(np.abs(gj[n].numpy()).max() for n in params)
                  for gj in grads]
        for name, got in sd.items():
            w = want[name].numpy()
            got = got.numpy()
            if name not in params:  # BN statistics, spectral vectors
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


def test_compact_step_equals_dense_step(runs):
    """Masked motion (static top half): the step with host-attached moving
    sets (compact K7) equals the dense step bit for bit."""
    tr = runs["tr"]
    batch = tiny_batch(np.random.default_rng(13))
    np_batch = {k: ([np.asarray(x) for x in v] if k == "images"
                    else np.asarray(v)) for k, v in batch.items()}
    np_batch["motions"] = np_batch["motions"].copy()
    np_batch["motions"][:, :16] = 0.0
    sparse = attach_moving_sets(dict(np_batch))
    assert "mov_pos" in sparse and sparse["mov_valid"].sum(1).max() <= 32 * 16
    state = ({k: v.clone() for k, v in tr.model.state_dict().items()},
             {k: v.clone() for k, v in tr.d_model.state_dict().items()})
    results = []
    for b in (np_batch, sparse):
        tr.model.load_state_dict(state[0])
        tr.d_model.load_state_dict(state[1])
        with torch.no_grad():
            _, logs, gen = tr.g_losses(to_device_batch(b, "cpu"))
        results.append(({k: float(v) for k, v in logs.items()}, gen))
    assert results[0][0] == results[1][0]
    assert torch.equal(results[0][1], results[1][1])


@pytest.mark.parametrize("case", ["plain", "sparse_sticky", "eps", "dense"])
def test_attach_moving_sets_matches_jax(case):
    rng = np.random.default_rng(30)
    m = (rng.standard_normal((2, 40, 40, 2)) * 0.5).astype(np.float32)
    kw = {}
    if case != "dense":
        m[:, :25] = 0.0
    if case == "eps":
        m[:, 25:30] *= 1e-3
        kw = dict(eps=0.01, n_steps=50)
    batches = [{"motions": m}, {"motions": m[:, ::-1].copy()}]
    js, ps = {}, {}
    for b in batches:
        if case == "sparse_sticky":
            want, got = jax_attach(dict(b), state=js), attach_moving_sets(dict(b), state=ps)
        else:
            want, got = jax_attach(dict(b), **kw), attach_moving_sets(dict(b), **kw)
        assert set(want) == set(got)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert js == ps


def test_dataset_items_match_jax(fixture_root):
    from slrsfs_tpu.config import Options as JaxOptions
    from slrsfs_tpu.data.datasets import get_dataset as jax_get_dataset
    from slrsfs_tpu_torch.data.datasets import get_dataset

    jopt, opt = JaxOptions(W=32), Options(W=32)
    for split in ("train", "validation"):
        jd = jax_get_dataset(jopt, fixture_root, split=split, seed=3)
        pd = get_dataset(opt, fixture_root, split=split, seed=3)
        for ds in (jd, pd):
            (ds.totrain if split == "train" else ds.toval)(1)
        for i in range(3):
            want, got = jd[i], pd[i]
            for v in range(3):
                np.testing.assert_array_equal(got["images"][v], want["images"][v])
            np.testing.assert_array_equal(got["motions"], want["motions"])
            np.testing.assert_array_equal(got["index"], want["index"])
    batch = next(pd.batches(2, num_batches=1))
    assert batch["images"][0].shape == (2, 32, 32, 3)


def test_lr_schedule_and_unported_options():
    sched = make_lr_schedule(1e-3, niter=2, niter_decay=4, steps_per_epoch=10)
    assert sched(0) == sched(20) == 1e-3
    np.testing.assert_allclose(sched(30), 1e-3 * 0.75)
    assert sched(60) == sched(100) == 0.0
    model = BaselineTrainable(Options(ngf=8, W=16, refine_model_type=(
        "resnet_TinyTest_de_resnet_pconv2_nonorm"), out_channel=9))
    with pytest.raises(ValueError, match="the JAX package does not run it either"):
        Trainer(Options(train_compute_dtype="bfloat16", train_motion=True), model,
                device="cpu")
