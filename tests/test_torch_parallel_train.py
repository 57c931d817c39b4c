"""The port's data-parallel training step (``Trainer(mesh=...)``) on two
gloo ranks against the one-process port step on the whole batch and
against the JAX step over a 2-device ``make_mesh(2)``.

Every run starts from the JAX trainer's weights (``base_trainer``, carried
over by ``from_jax_variables``) at ``tiny_options(W=32, batch_size=4)``,
T = 4, with SGD (lr 1e-3) in place of Adam, as ``tests/test_trainer.py:45``
compares JAX's sharded and unsharded steps: Adam's first update is ±lr
whatever the gradient's size, so a round-off sign flip would move a
parameter by 2·lr. Two steps on two batches:

* against one process: parameters, BN statistics and spectral vectors
  within 2e-5 and the logged losses within 1e-4 after each step, with BN
  noise off and on (the ranks draw the global batch's noise and keep their
  rows; tests/test_trainer.py:45's tolerances);
* the two ranks' parameters, statistics and vectors bit for bit equal;
* against JAX's sharded step (zero noise, a test-only interceptor): losses
  within 1e-4 relative and G and D gradients within 2.5e-4 of each
  sub-network's largest entry (PERF.md §2's cross-framework step
  tolerances);
* a partial noise-BN's global moments (the mask's counts summed over the
  ranks), its output, input gradient and statistics;
* two micro-batches a step (``num_accumulations`` 2);
* ``parallel/dryrun.py``'s three steps on two ranks."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax import linen as nn

import torch_dist_ranks as ranks
from conftest import tiny_batch, tiny_options
from slrsfs_tpu.engine.trainer import TrainState
from slrsfs_tpu.engine.trainer import Trainer as JaxTrainer
from slrsfs_tpu.models.baseline import BaselineTrainable as JaxBaselineTrainable
from slrsfs_tpu.nn.norm import NoiseBN as JaxNoiseBN
from slrsfs_tpu.parallel.mesh import make_mesh, replicate, shard_batch
from slrsfs_tpu_torch.cli.train import to_device_batch
from slrsfs_tpu_torch.config import Options
from slrsfs_tpu_torch.io.convert import from_jax_variables
from slrsfs_tpu_torch.models.baseline import BaselineTrainable
from slrsfs_tpu_torch.nn.discriminators import MultiscaleDiscriminator
from slrsfs_tpu_torch.nn.norm import NoiseBN
from slrsfs_tpu_torch.nn.vgg import VGG19Features

torch.set_num_threads(1)

B = 4
PARAM_TOL, LOSS_TOL = 2e-5, 1e-4
JAX_LOSS_RTOL, JAX_GRAD_REL = 1e-4, 2.5e-4


def _zero_noise(next_fun, args, kwargs, context):
    """Calls every JAX NoiseBN with deterministic=True (zero noise)."""
    if isinstance(context.module, JaxNoiseBN) and context.method_name == "__call__":
        args = (args[0], args[1], True) + tuple(args[3:])
    return next_fun(*args, **kwargs)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _np_batch(batch):
    return {k: [np.asarray(x) for x in v] if k == "images" else np.asarray(v)
            for k, v in batch.items()}


@pytest.fixture(scope="module")
def env(base_trainer, vgg_vars32):
    """The port's Options, the JAX trainer's weights in the port's layout,
    two numpy batches of 4 and the port modules they load into."""
    jopt = tiny_options(W=32, batch_size=B)
    opt = Options(**dataclasses.asdict(jopt))
    s0 = base_trainer["state"]
    g, d, vgg = BaselineTrainable(opt, train_max_steps=4), MultiscaleDiscriminator(opt), \
        VGG19Features()
    states = {"G": from_jax_variables(_np({"params": s0.g_params, "batch_stats": s0.g_stats,
                                           "spectral": s0.g_spectral}), opt, g),
              "D": from_jax_variables(_np({"params": s0.d_params,
                                           "spectral": s0.d_spectral}), opt, d),
              "VGG": from_jax_variables(_np(vgg_vars32), opt, vgg)}
    batches = [tiny_batch(np.random.default_rng(seed), B=B) for seed in (3, 4)]
    return dict(jopt=jopt, opt=opt, states=states, g=g, d=d, jax_batches=batches,
                batches=[_np_batch(b) for b in batches])


@pytest.fixture(scope="module")
def runs(env, tmp_path_factory):
    """``runs(noise)``: (one process, [rank 0, rank 1], G's parameter
    names) of ``train_steps`` over both batches, computed once a noise
    setting."""
    cache = {}

    def get(noise: bool):
        if noise not in cache:
            tr = ranks.make_trainer(env["opt"], env["states"], deterministic=not noise)
            one = ranks.train_steps(tr, [to_device_batch(b, "cpu") for b in env["batches"]])
            two = ranks.run_ranks(ranks.rank_train, 2, tmp_path_factory.mktemp("dp"),
                                  env["opt"], env["states"], env["batches"], not noise)
            cache[noise] = (one, two, tr.g_names)
        return cache[noise]

    return get


def _close_states(got, want, tol, what):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=tol, atol=tol,
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("noise", [False, True], ids=["noise-off", "noise-on"])
def test_two_rank_steps_match_one_process(runs, noise):
    (logs1, _, states1), two, _ = runs(noise)
    for r, (logs2, _, states2) in enumerate(two):
        for k in range(2):
            assert set(logs2[k]) == set(logs1[k])
            for name, v in logs1[k].items():
                np.testing.assert_allclose(float(logs2[k][name]), float(v), rtol=LOSS_TOL,
                                           atol=1e-6, err_msg=f"rank {r} step {k} {name}")
            _close_states(states2[k], states1[k], PARAM_TOL, f"rank {r} step {k}")
    # the noise really reached the steps
    (logs_off, _, _), _, _ = runs(False)
    if noise:
        assert float(logs1[0]["L1"]) != float(logs_off[0]["L1"])


def test_ranks_end_bit_identical(runs):
    """Parameters, BN statistics and spectral vectors of G and D are equal
    bit for bit on both ranks after two noisy steps."""
    _, ((_, _, s0), (_, _, s1)), _ = runs(True)
    for k in range(2):
        assert set(s0[k]) == set(s1[k])
        for name in s0[k]:
            assert torch.equal(s0[k][name], s1[k][name]), (k, name)
    assert any("stored_mean" in n for n in s0[1]) and any("weight_u" in n for n in s0[1])


def _grad_holder():
    """An optax transform whose update is -g and whose state is the last
    gradient g: parameters move as SGD with lr 1, and the state keeps the
    step's gradients to compare."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda u, s, p=None: (jax.tree.map(lambda x: -x, u), u))


def test_two_rank_step_matches_jax_sharded_step(env, runs, base_trainer):
    """One JAX step over the 2-device mesh on the first batch (zero noise)
    against the port's first two-rank step."""
    jopt = env["jopt"]
    jtr = JaxTrainer(jopt, JaxBaselineTrainable(jopt, train_max_steps=4), steps_per_epoch=10)
    jtr.load_vgg(base_trainer["trainer"].vgg_vars)
    jtr.tx_g = jtr.tx_d = _grad_holder()
    s0 = base_trainer["state"]
    state = TrainState(step=jnp.zeros((), jnp.int32), g_params=s0.g_params,
                       g_stats=s0.g_stats, g_spectral=s0.g_spectral, d_params=s0.d_params,
                       d_spectral=s0.d_spectral, opt_g=jtr.tx_g.init(s0.g_params),
                       opt_d=jtr.tx_d.init(s0.d_params))
    step_fn = jtr.make_train_step()

    @jax.jit
    def jstep(s, b, key):
        with nn.intercept_methods(_zero_noise):
            return step_fn(s, b, key)

    mesh = make_mesh(2)
    js, jlogs = jstep(replicate(state, mesh),
                      shard_batch(env["jax_batches"][0], mesh, batch_size=B),
                      replicate(jax.random.PRNGKey(1), mesh))
    _, two, g_names = runs(False)
    logs, grads, _ = two[0]
    for name in jlogs:
        np.testing.assert_allclose(float(logs[0][name]), float(jlogs[name]),
                                   rtol=JAX_LOSS_RTOL, atol=1e-6, err_msg=name)
    want = {f"G.{k}": v for k, v in from_jax_variables(_np(
        {"params": js.opt_g, "batch_stats": js.g_stats, "spectral": js.g_spectral}),
        env["opt"], env["g"]).items()}
    want.update({f"D.{k}": v for k, v in from_jax_variables(_np(
        {"params": js.opt_d, "spectral": js.d_spectral}), env["opt"], env["d"]).items()})
    names = [f"G.{n}" for n in g_names] + [f"D.{n}" for n, _ in env["d"].named_parameters()]
    assert len(names) == len(grads[0])
    groups = {}
    for n, g in zip(names, grads[0]):
        groups.setdefault(n.split(".")[0] + "." + n.split(".")[1], []).append((n, g))
    assert len(groups) >= 3
    for group, items in groups.items():
        scale = max(np.abs(want[n].numpy()).max() for n, _ in items)
        for n, g in items:
            np.testing.assert_allclose(g.numpy(), want[n].numpy(), rtol=0,
                                       atol=JAX_GRAD_REL * scale, err_msg=f"{group}: {n}")


def test_partial_bn_moments_are_global(tmp_path):
    """A partial noise-BN (zero noise, train mode) on two ranks' rows of a
    batch of 4 against one process on the whole batch: the output and the
    input gradient within 2e-5 (SyncBN's backward: each rank's loss
    reaches every rank's rows through the moments), and the stored
    statistics, which a local count would move elsewhere."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn((4, 6, 5, 5), generator=g) * 2.0 + 0.5
    mask = (torch.rand((4, 1, 5, 5), generator=g) < 0.6).float()
    mask[:2] *= 0.0  # rank 0's rows: an empty mask, so local counts differ
    mask[0, 0, 0, 0] = 1.0
    gy = torch.randn((4, 6, 5, 5), generator=g)
    out = ranks.run_ranks(ranks.rank_partial_bn, 2, tmp_path, x, mask, gy)
    bn = NoiseBN(6, spectral=False, partial=True)
    with torch.no_grad():
        for p in bn.parameters():
            p.copy_(torch.linspace(-0.5, 0.5, p.numel()).reshape(p.shape))
    xr = x.clone().requires_grad_(True)
    y = bn(xr, mask, train=True)
    (y * gy).sum().backward()
    for r, (yr, gr, mean, var) in enumerate(out):
        rows = slice(2 * r, 2 * r + 2)
        torch.testing.assert_close(yr, y.detach()[rows], rtol=2e-5, atol=2e-5)
        torch.testing.assert_close(gr, xr.grad[rows], rtol=2e-5, atol=2e-5)
        torch.testing.assert_close(mean, bn.pbn.stored_mean, rtol=2e-5, atol=2e-5)
        torch.testing.assert_close(var, bn.pbn.stored_var, rtol=2e-5, atol=2e-5)


def test_two_rank_accumulation_matches_one_process(env, tmp_path):
    """``num_accumulations`` 2: one step on two micro-batches of 4, each
    rank on its 2 rows of each, against one process."""
    opt = env["opt"].replace(num_accumulations=2)
    micro = [env["batches"]]
    tr = ranks.make_trainer(opt, env["states"])
    (l1,), _, (s1,) = ranks.train_steps(tr, [[to_device_batch(b, "cpu") for b in micro[0]]])
    two = ranks.run_ranks(ranks.rank_train, 2, tmp_path, opt, env["states"], micro, True)
    for logs2, _, states2 in two:
        for name, v in l1.items():
            np.testing.assert_allclose(float(logs2[0][name]), float(v), rtol=LOSS_TOL,
                                       atol=1e-6, err_msg=name)
        _close_states(states2[0], s1, PARAM_TOL, "accumulated step")


@pytest.fixture(scope="module")
def dryrun_logs(tmp_path_factory):
    return {which: ranks.run_ranks(ranks.rank_dryrun, 2, tmp_path_factory.mktemp(which),
                                   which)
            for which in ("baseline", "slr", "motion")}


@pytest.mark.parametrize("which", ["baseline", "slr", "motion"])
def test_dryrun_two_ranks(dryrun_logs, which):
    """``parallel/dryrun.py``'s step on two gloo ranks: finite totals, the
    step's log keys, and the same logged (rank-averaged) losses on both
    ranks."""
    l0, l1 = dryrun_logs[which]
    assert l0 == l1
    assert np.isfinite(l0["Total Loss"])
    assert {"Total Loss", "D_Fake", "D_real", "GAN"} <= set(l0)


def _option_case(name):
    """(Options, numpy batch of 4) of a step variant at 32²: bf16 compute,
    the origin D, the fix-motion finetune (an embedded depth-4 regressor
    at 32², frozen)."""
    from slrsfs_tpu_torch.cli.train import MODEL_TYPE, stage_options

    jopt = tiny_options(W=32, batch_size=B, motionW=32, motionH=32)
    opt = Options(**dataclasses.asdict(jopt))
    rng = np.random.default_rng(11)
    batch = _np_batch(tiny_batch(rng, B=B))
    if name == "bf16":
        return opt.replace(train_compute_dtype="bfloat16"), batch
    if name == "origin-D":
        return opt.replace(discriminator_losses="pix2pixHDorigin"), batch
    keep = rng.random((B, 32, 32, 1)) < 0.05
    batch["hints"] = (batch["motions"] * keep).astype(np.float32)
    return opt.replace(freeze_motion=True, **stage_options(MODEL_TYPE, True)), batch


@pytest.mark.parametrize("name", ["bf16", "origin-D", "fix-motion"])
def test_two_rank_step_variants_match_one_process(tmp_path, name):
    """bf16 compute, the origin D and the frozen embedded regressor under a
    mesh: one 2-rank SGD step against one process from the same seeded
    weights, losses within 1e-4 (bf16: 1e-2, PERF.md §2's bf16 step
    tolerance) and every parameter, statistic and vector within 2e-5;
    both ranks bit for bit equal."""
    from slrsfs_tpu_torch.cli.train import build

    opt, batch = _option_case(name)
    _, tr0 = build(opt, train_max_steps=4, device="cpu", seed=0)
    states = {"G": tr0.model.state_dict(), "D": tr0.d_model.state_dict()}
    tr = ranks.make_trainer(opt, states)
    (l1,), _, (s1,) = ranks.train_steps(tr, [to_device_batch(batch, "cpu")])
    two = ranks.run_ranks(ranks.rank_train, 2, tmp_path, opt, states, [batch], True)
    tol = 1e-2 if name == "bf16" else LOSS_TOL
    for logs2, _, states2 in two:
        for k, v in l1.items():
            np.testing.assert_allclose(float(logs2[0][k]), float(v), rtol=tol, atol=1e-6,
                                       err_msg=k)
        _close_states(states2[0], s1, PARAM_TOL, name)
    for k in two[0][2][0]:
        assert torch.equal(two[0][2][0][k], two[1][2][0][k]), k
