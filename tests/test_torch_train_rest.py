"""The rest of training against the JAX package, on the CPU: the style
loss, the free-form occlusion mask (its draw, the dataset and both
models' ``forward_train``), gradient accumulation, the bf16 compute mode
and the motion GAN with the pix2pixHD origin discriminator.

Conventions of tests/torch_stage_parity.py: zero BN noise on both sides,
JAX variables drawn with numpy or taken from the JAX trainer's init and
carried over by ``from_jax_variables``.

* ``style`` (and ``SynthesisLoss`` with it first, whose λ Total skips):
  values within 1e-5 relative, the input gradient within 1e-4 of its
  largest entry;
* ``random_ff_mask`` and ``ff_keep_mask`` bit for bit from the same numpy
  ``Generator``; the dataset's train items carry JAX's ``ff_mask`` bit for
  bit, its validation items none;
* ``forward_train`` with an ``ff_mask`` (baseline and SLR, TinyTest archs at
  32²): every pred tensor within 1e-4 of its largest magnitude, and the
  mask changes the prediction;
* accumulation, from settled spectral vectors: two identical
  micro-batches against the one-batch step (losses are per-micro means:
  within 1e-5 relative, since the only drift is the spectral vectors'
  second power iteration, 3e-6 here, and the PSNR, which sits near 0 dB,
  within 1e-4 absolute; gradients within 5e-3 of the largest entry,
  1.7e-3 seen: the second micro-batch's G loss meets D's vectors after
  its power iteration, and the losses' kinks amplify that); with b1 = 0 Adam's first moment under
  'reference' is exactly 4x the one under 'mean'; against JAX's
  ``make_train_step(accum=2)`` the losses within 1e-4 relative;
* bf16: every persistent tensor stays float32; the losses are finite, within
  JAX's own check (``0.12·|f32| + 0.05``, tests/test_trainer.py) of the port's
  float32 step, and within ``BF16_REL`` of JAX's bf16 step (the two
  frameworks round bf16 at other places: the convolutions' internal
  precision and the order of their sums differ);
* the motion GAN with ``discriminator_losses='pix2pixHDorigin'``: the
  origin D (ndf 64, 3 layers, 2 scales) is built, ``GAN_Feat`` is 0, the
  losses within 1e-4 relative of JAX's and D's gradients within 2.5e-4 of
  its largest entry."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn

import torch_stage_parity as P
from conftest import tiny_batch, tiny_options
from slrsfs_tpu.data import augment as jaug
from slrsfs_tpu.engine.trainer import Trainer as JaxTrainer
from slrsfs_tpu.losses import synthesis as jsyn
from slrsfs_tpu.models import baseline as jbase
from slrsfs_tpu.models import motion as jmot
from slrsfs_tpu.models import slr as jslr
from slrsfs_tpu.nn import pix2pixhd as jhd
from slrsfs_tpu.nn.vgg import VGG19Features as JaxVGG
from slrsfs_tpu_torch.cli.train import stage_options
from slrsfs_tpu_torch.config import Options
from slrsfs_tpu_torch.data import augment
from slrsfs_tpu_torch.engine.trainer import Trainer
from slrsfs_tpu_torch.io.convert import from_jax_variables
from slrsfs_tpu_torch.losses import synthesis as psyn
from slrsfs_tpu_torch.models import motion as pmot
from slrsfs_tpu_torch.models.baseline import BaselineTrainable
from slrsfs_tpu_torch.models.slr import SLR_MODEL_TYPE, SLRTrainable
from slrsfs_tpu_torch.nn.discriminators import MultiscaleDiscriminator
from slrsfs_tpu_torch.nn.pix2pixhd import OriginMultiscaleDiscriminator
from slrsfs_tpu_torch.nn.vgg import VGG19Features

torch.set_num_threads(1)

B, HW, T = 2, 32, 4
# The port's bf16 step against JAX's bf16 step, relative to the f32 value:
# both round every layer's output to bf16 (8 significand bits, 3.9e-3
# relative) but at other places and after other sums; the largest
# difference seen here is 2.9e-3 (GAN), the others at most 7e-4.
BF16_REL = 1e-2


# ---- the style loss ---------------------------------------------------------

@pytest.fixture(scope="module")
def vggs(vgg_vars32):
    vgg = VGG19Features()
    vgg.load_state_dict(from_jax_variables(P.np_tree(vgg_vars32), Options(), vgg))
    return vgg_vars32, vgg.requires_grad_(False)


@pytest.mark.parametrize("losses", [("1.0_l1", "10.0_content", "5.0_style"),
                                    ("3.0_style", "1.0_l1")])
def test_style_loss_matches_jax(vggs, losses):
    jvars, vgg = vggs
    rng = np.random.default_rng(len(losses[0]))
    pred = rng.uniform(-1, 1, (B, HW, HW, 3)).astype(np.float32)
    gt = rng.uniform(-1, 1, (B, HW, HW, 3)).astype(np.float32)
    jl = jsyn.SynthesisLoss(losses, JaxVGG(), jvars)
    want = jl(jnp.asarray(pred), jnp.asarray(gt))
    p = torch.from_numpy(pred).requires_grad_(True)
    got = psyn.SynthesisLoss(losses, vgg)(p, torch.from_numpy(gt))
    assert set(got) == set(want) and "Style" in got
    for k in want:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    got["Style"].backward()
    jg = np.asarray(jax.grad(lambda x: jsyn.style(JaxVGG(), jvars, x, jnp.asarray(gt)))(
        jnp.asarray(pred)))
    np.testing.assert_allclose(p.grad.numpy(), jg, rtol=0, atol=1e-4 * np.abs(jg).max())


# ---- the free-form mask -----------------------------------------------------

@pytest.mark.parametrize("seed, h, w", [(0, 32, 32), (1, 64, 48), (7, 256, 256), (9, 20, 90)])
def test_random_ff_mask_matches_jax(seed, h, w):
    got = augment.random_ff_mask(np.random.default_rng(seed), h, w)
    want = jaug.random_ff_mask(np.random.default_rng(seed), h, w)
    assert got.dtype == np.float32 and got.shape == (h, w) and got.any()
    np.testing.assert_array_equal(got, want)
    for rate in (0.0, 0.5, 1.0):
        k_got = augment.ff_keep_mask(np.random.default_rng(seed), h, w, rate=rate)
        k_want = jaug.ff_keep_mask(np.random.default_rng(seed), h, w, rate=rate)
        assert k_got.shape == (h, w, 1)
        np.testing.assert_array_equal(k_got, k_want)


def test_dataset_ff_mask_in_training_batches_only(fixture_root):
    from slrsfs_tpu.config import Options as JaxOptions
    from slrsfs_tpu.data.datasets import get_dataset as jax_get_dataset
    from slrsfs_tpu_torch.data.datasets import get_dataset

    kw = dict(W=32, random_ff_mask=True, random_ff_mask_rate=0.7)
    jd = jax_get_dataset(JaxOptions(**kw), fixture_root, split="train", seed=3)
    pd = get_dataset(Options(**kw), fixture_root, split="train", seed=3)
    n_masked = 0
    for ds in (jd, pd):
        ds.totrain(2)
    for i in range(4):
        want, got = jd[i], pd[i]
        np.testing.assert_array_equal(got["ff_mask"], want["ff_mask"])
        assert got["ff_mask"].shape == (32, 32, 1) and got["ff_mask"].dtype == np.float32
        n_masked += int((got["ff_mask"] == 0).any())
    assert n_masked > 0
    pd.toval(2)
    assert "ff_mask" not in pd[0]


def _ff_batch(seed, slr=False):
    rng = np.random.default_rng(seed)
    batch = {k: ([np.asarray(x) for x in v] if k == "images" else np.asarray(v))
             for k, v in tiny_batch(rng).items()}
    keep = np.stack([augment.ff_keep_mask(np.random.default_rng(seed + s), HW, HW, rate=1.0)
                     for s in range(B)])
    batch["ff_mask"] = keep.astype(np.float32)
    if slr:
        batch["mask_rock"] = (rng.random((B, HW, HW, 1)) < 0.3).astype(np.float32)
        batch["mean_video"] = (rng.standard_normal((B, HW, HW, 3)) * 0.25).astype(np.float32)
    return batch


@pytest.mark.parametrize("slr", [False, True], ids=["baseline", "SLR"])
def test_forward_train_with_ff_mask_matches_jax(slr):
    kw = dict(W=HW, batch_size=B)
    if slr:
        kw.update(model_type=SLR_MODEL_TYPE, **stage_options(SLR_MODEL_TYPE))
    jopt = tiny_options(**kw)
    popt = Options(**dataclasses.asdict(jopt))
    batch = _ff_batch(5, slr)
    jmodel = (jslr.SLRTrainable if slr else jbase.BaselineTrainable)(jopt, train_max_steps=T)
    variables = P.numpy_init(jmodel, P.jnp_batch(batch), seed=8)

    @jax.jit
    def jforward(v, b):
        with nn.intercept_methods(P.zero_noise):
            return jmodel.apply(v, b, True, False, method=jmodel.forward_train,
                                mutable=["batch_stats", "spectral"],
                                rngs={"noise": jax.random.PRNGKey(2)})

    (_, want), _ = jforward(variables, P.jnp_batch(batch))
    model = (SLRTrainable if slr else BaselineTrainable)(popt, train_max_steps=T)
    model.load_state_dict(from_jax_variables(P.np_tree(variables), popt, model))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        _, got = model.forward_train(P.port_batch(batch), train=True, deterministic=True,
                                     plain=True)
        model.load_state_dict(state)
        unmasked = {k: v for k, v in batch.items() if k != "ff_mask"}
        _, free = model.forward_train(P.port_batch(unmasked), train=True, deterministic=True,
                                      plain=True)
    P.check_pred(got, P.np_tree(want))
    assert not torch.equal(got["PredImg"], free["PredImg"])


# ---- accumulation -----------------------------------------------------------

def _port_trainer(base, state=None, **kw):
    """A port trainer on the JAX base trainer's initial state (tiny archs,
    W = 32, B = 2), or ``state``, with zero noise; ``kw`` overrides
    options."""
    state = base["state"] if state is None else state
    opt = Options(**{**dataclasses.asdict(base["opt"]), **kw})
    model = BaselineTrainable(opt, train_max_steps=T)
    d = MultiscaleDiscriminator(opt)
    P.load_port(model, d, opt, state)
    vgg = VGG19Features()
    vgg.load_state_dict(from_jax_variables(
        P.np_tree(base["trainer"].vgg_vars), opt, vgg))
    return Trainer(opt, model, steps_per_epoch=10, vgg=vgg, d_model=d,
                   deterministic=True, device="cpu")


@pytest.fixture(scope="module")
def accum_runs(base_trainer):
    batch = base_trainer["batch"]
    # spectral vectors settled: each micro-batch runs a power iteration, so
    # unsettled vectors would move sigma between the two
    state = P.settled_state(base_trainer["state"])
    pb = P.port_batch(batch)
    out = {}
    for name, kw in (("one", {}), ("mean", dict(num_accumulations=2)),
                     ("reference", dict(num_accumulations=2, accum_scale="reference"))):
        tr = _port_trainer(base_trainer, state, **kw)
        logs = tr.train_step(pb if name == "one" else [pb, pb])
        out[name] = (tr, logs)
    step2 = base_trainer["trainer"].make_train_step(accum=2)

    @jax.jit
    def jstep(s, b):
        with nn.intercept_methods(P.zero_noise):
            return step2(s, [b, b], jax.random.PRNGKey(1))

    out["jax"] = P.np_tree(jstep(state, P.jnp_batch(batch))[1])
    return out


def test_accumulation_of_identical_micro_batches_matches_one_batch(accum_runs):
    one, logs1 = accum_runs["one"]
    acc, logs2 = accum_runs["mean"]
    assert acc.step_count == 1 and acc.accum == 2
    for k in logs1:
        np.testing.assert_allclose(float(logs2[k]), float(logs1[k]), rtol=1e-5,
                                   atol=1e-4 if k in P.METRICS else 1e-7, err_msg=k)
    for which in ("g", "d"):
        a, b = one.last_grads[which], acc.last_grads[which]
        scale = max(float(x.abs().max()) for x in a)
        for x, y in zip(a, b):
            np.testing.assert_allclose(y.numpy(), x.numpy(), rtol=0, atol=5e-3 * scale,
                                       err_msg=which)


def test_reference_scale_moment_is_four_times_the_mean(accum_runs):
    mean, _ = accum_runs["mean"]
    ref, logs = accum_runs["reference"]
    for a, b in ((mean.opt_g, ref.opt_g), (mean.opt_d, ref.opt_d)):
        assert a.b1 == 0.0
        for x, y in zip(a.mu, b.mu):
            assert torch.equal(y, 4.0 * x)
    for k, v in accum_runs["mean"][1].items():
        assert float(logs[k]) == float(v), k


@pytest.mark.parametrize("k", [0, -2])
def test_cli_refuses_fewer_than_one_accumulation(k, tmp_path):
    """``--num-accumulations`` below 1 reaches the Trainer's check unchanged
    and is refused, not read as 1."""
    from slrsfs_tpu_torch.cli import train as port_train

    with pytest.raises(ValueError, match="num_accumulations must be at least 1"):
        port_train.main(["--data-root", str(tmp_path), "--out", str(tmp_path / "run"),
                         "--W", "32", "--ngf", "8", "--num-accumulations", str(k),
                         "--device", "cpu"])


def test_accumulation_losses_match_jax(accum_runs):
    P.check_losses(accum_runs["mean"][1], accum_runs["jax"], ("L1", "GAN", "D_Fake"))


def test_accumulation_takes_a_list_of_micro_batches(base_trainer):
    tr = _port_trainer(base_trainer, num_accumulations=2)
    with pytest.raises(ValueError, match="2 micro-batches"):
        tr.train_step(P.port_batch(base_trainer["batch"]))


# ---- bf16 -------------------------------------------------------------------

@pytest.fixture(scope="module")
def bf16_runs(base_trainer):
    state, batch = base_trainer["state"], base_trainer["batch"]
    jopt = base_trainer["opt"].replace(train_compute_dtype="bfloat16")
    jtr = JaxTrainer(jopt, jbase.BaselineTrainable(jopt, train_max_steps=T), steps_per_epoch=10)
    jtr.load_vgg(base_trainer["trainer"].vgg_vars)
    step = jtr.make_train_step()

    @jax.jit
    def jstep(s, b):
        with nn.intercept_methods(P.zero_noise):
            return step(s, b, jax.random.PRNGKey(1))

    jlogs = P.np_tree(jstep(state, P.jnp_batch(batch))[1])
    pb = P.port_batch(batch)
    out = {"jax": jlogs}
    for dt in ("float32", "bfloat16"):
        tr = _port_trainer(base_trainer, train_compute_dtype=dt)
        out[dt] = (tr, tr.train_step(pb))
    return out


def test_bf16_step_keeps_every_persistent_tensor_float32(bf16_runs):
    tr, logs = bf16_runs["bfloat16"]
    assert tr.compute_dtype == torch.bfloat16
    for module in (tr.model, tr.d_model):
        for name, t in module.state_dict().items():
            assert t.dtype == torch.float32, name
    for adam in (tr.opt_g, tr.opt_d):
        assert adam.count == 1
        for t in adam.mu + adam.nu:
            assert t.dtype == torch.float32
    for g in tr.last_grads["g"]:
        assert g.dtype == torch.float32
    for k, v in logs.items():
        assert v.dtype == torch.float32 and torch.isfinite(v), k


def test_bf16_step_losses_match_f32_and_jax_bf16(bf16_runs):
    logs16, logs32, jlogs = bf16_runs["bfloat16"][1], bf16_runs["float32"][1], bf16_runs["jax"]
    for k in ("L1", "Total Loss"):
        a, b = float(logs16[k]), float(logs32[k])
        assert abs(a - b) <= 0.12 * abs(b) + 0.05, (k, a, b)
    assert float(logs16["L1"]) != float(logs32["L1"])  # the step did run in bf16
    for k in ("L1", "Perceptual", "GAN", "GAN_Feat", "D_Fake", "D_real", "Total Loss"):
        np.testing.assert_allclose(float(logs16[k]), float(jlogs[k]), rtol=0,
                                   atol=BF16_REL * abs(float(logs32[k])) + 1e-6, err_msg=k)


def test_bf16_step_splats_bf16_features_with_an_f32_flow(base_trainer, monkeypatch):
    from slrsfs_tpu_torch.ops import splat

    seen = []
    orig = splat.SoftsplatSum.apply

    def spy(inp, flow, plain):
        seen.append((inp.dtype, flow.dtype))
        return orig(inp, flow, plain)

    monkeypatch.setattr(splat.SoftsplatSum, "apply", spy)
    tr = _port_trainer(base_trainer, train_compute_dtype="bfloat16")
    tr.train_step(P.port_batch(base_trainer["batch"]))
    assert seen == [(torch.bfloat16, torch.float32)] * 2


@pytest.mark.parametrize("deterministic", [False, True], ids=["noise", "zero_noise"])
def test_bf16_step_gradients_move_with_the_splat_order(monkeypatch, deterministic):
    """How far the bf16 step moves when only the order of its splat's bf16
    sum changes (the f32 sum of the same weighted rows rounded once to bf16
    against the sequential bf16 sum), from one snapshot: the losses within
    1e-2 relative (PSNR and SSIM, near 0, also 1e-2 absolute), G's and D's gradients by 0.11–0.14 of their L2 norm at
    these TinyTest widths with random weights (0.114 with noise, 0.135
    without). The card's K3 bf16 forward adds in an atomic order, so its
    step is held against the plain one with the kernel forward's own
    output given to the plain step (tests/test_torch_gpu.py)."""
    from slrsfs_tpu_torch.cli.train import build, to_device_batch
    from slrsfs_tpu_torch.ops import splat

    opt = Options(ngf=8, W=HW, out_channel=9, ndf=8, num_D=1, n_layers_D=2,
                  refine_model_type="resnet_TinyTest_de_resnet_pconv2_nonorm",
                  train_compute_dtype="bfloat16")
    _, tr = build(opt, train_max_steps=T, device="cpu", seed=0)
    tr.deterministic = deterministic
    rng = np.random.default_rng(41)
    batch = to_device_batch(
        {"images": [(rng.standard_normal((B, HW, HW, 3)) * 0.25).astype(np.float32)
                    for _ in range(3)],
         "index": np.array([[0, 1, 4], [0, 3, 4]], np.int32),
         "motions": (rng.standard_normal((B, HW, HW, 2)) * 0.8).astype(np.float32)}, "cpu")
    sequential = splat.softsplat_sum_plain
    runs = []
    for order in ("sequential", "rounded once"):
        if order == "rounded once":
            monkeypatch.setattr(splat, "softsplat_sum_plain", lambda inp, flow: sequential(
                inp.float(), flow).to(inp.dtype))
        snap = tr.snapshot()
        logs = tr.train_step(batch)
        runs.append((logs, [g.clone() for g in tr.last_grads["g"] + tr.last_grads["d"]]))
        tr.restore(snap)
    (l_a, g_a), (l_b, g_b) = runs
    for k in l_a:  # the metrics, near 0 here, within 1e-2 absolute as well
        assert abs(float(l_b[k]) - float(l_a[k])) <= 1e-2 * max(
            abs(float(l_a[k])), 1.0 if k in P.METRICS else 1e-6), k
    l2 = float(torch.cat([(b - a).flatten() for a, b in zip(g_a, g_b)]).norm()
               / torch.cat([a.flatten() for a in g_a]).norm())
    assert 0.05 < l2 < 0.25, l2


# ---- the motion GAN with the pix2pixHD origin discriminator -----------------

def _origin_d_tree_to_torch(tree, d):
    """JAX origin-D params (``import_origin_discriminator``'s layout) as the
    port D's named tensors."""
    out = {}
    for i in range(d.num_D):
        convs = [n for n, m in getattr(d, f"layer{i}").named_children()
                 if isinstance(m, torch.nn.Conv2d)]
        for c, n in enumerate(convs):
            e = tree[f"layer{i}"][f"conv{c}"]
            out[f"layer{i}.{n}.weight"] = torch.from_numpy(
                np.asarray(e["kernel"]).transpose(3, 2, 0, 1).copy())
            out[f"layer{i}.{n}.bias"] = torch.from_numpy(np.asarray(e["bias"]).copy())
    return out


def test_motion_gan_with_origin_discriminator_matches_jax():
    from test_torch_motion_gan import SMALL, motion_batch

    jopt = tiny_options(batch_size=B, model_type="SPADE_unet_mask_motion",
                        motion_losses=("10.0_EndPointError",),
                        discriminator_losses="pix2pixHDorigin", **SMALL)
    opt = Options(**dataclasses.asdict(jopt))
    model = pmot.MotionRegressor(opt)
    tr = Trainer(opt, model, steps_per_epoch=10, deterministic=True, device="cpu",
                 task="motion")
    d = tr.d_model
    assert isinstance(d, OriginMultiscaleDiscriminator) and d.num_D == 2
    assert d.layer0[0].in_channels == 2 and d.layer0[0].out_channels == 64
    rng = np.random.default_rng(3)
    with torch.no_grad():
        for p in d.parameters():
            fan = int(np.prod(p.shape[1:])) if p.ndim > 1 else 1
            p.copy_(torch.from_numpy(rng.standard_normal(p.shape) / np.sqrt(fan) * (
                1.0 if p.ndim > 1 else 0.1)))
    jtr = JaxTrainer(jopt, jmot.MotionRegressor(jopt), steps_per_epoch=10, task="motion")
    batch = motion_batch(5)
    state = P.settled_state(jtr.init_state(jax.random.PRNGKey(0), P.jnp_batch(batch)))
    d_params = jax.tree.map(jnp.asarray,
                            jhd.import_origin_discriminator(d.state_dict())["params"])
    state = state.replace(d_params=d_params, d_spectral={}, opt_d=jtr.tx_d.init(d_params))
    (js, jlogs), = P.jax_steps(jtr, state, batch, n=1)
    model.load_state_dict(from_jax_variables(P.np_tree(
        {"params": state.g_params, "batch_stats": state.g_stats,
         "spectral": state.g_spectral}), opt, model))
    logs = tr.train_step(P.port_batch(batch))
    assert float(logs["GAN_Feat"]) == 0.0
    P.check_losses(logs, jlogs, ("EndPointError", "GAN", "GAN_Feat", "D_Fake", "D_real"))
    want = _origin_d_tree_to_torch(P.adam_mu(js.opt_d), d)
    got = dict(zip([n for n, _ in d.named_parameters()], tr.last_grads["d"]))
    scale = max(float(w.abs().max()) for w in want.values())
    for n, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[n].numpy(), rtol=0,
                                   atol=P.GRAD_REL * scale, err_msg=n)
