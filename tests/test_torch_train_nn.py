"""The port's train-mode layers, VGG19, the discriminator and the losses
against the JAX package, with the JAX variables carried over by
``from_jax_variables``.

* ``settle`` (train-mode BN with plain and partial moments, one power
  iteration per spectral weight, zero noise) on the real baseline archs at
  ngf=16, 32²: the settled BN statistics and spectral vectors at 1e-5, the
  train-mode forward at 1e-4 (features; conv summation order);
* ``NoiseBN``'s gain/bias maps on a numpy noise vector against JAX's
  ``SpectralDense``, train (with the power iteration) and eval, at 1e-6;
* ``VGG19Features`` at 1e-4 of each slice's scale;
* the multiscale discriminator, eval and train (with its power
  iterations), at 1e-4, and its updated vectors at 1e-5;
* every loss of the stage-1 step at 1e-5 relative."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import tiny_options
from slrsfs_tpu.engine.init_utils import settle as jax_settle
from slrsfs_tpu.losses import gan as jax_gan
from slrsfs_tpu.losses import synthesis as jax_synth
from slrsfs_tpu.losses.ssim import ssim as jax_ssim
from slrsfs_tpu.nn.discriminators import MultiscaleDiscriminator as JaxD
from slrsfs_tpu.nn.norm import SpectralDense
from slrsfs_tpu.nn.vgg import VGG19Features as JaxVGG
from slrsfs_tpu_torch.config import Options
from slrsfs_tpu_torch.engine.init_utils import settle
from slrsfs_tpu_torch.io.convert import from_jax_variables
from slrsfs_tpu_torch.losses import gan as port_gan
from slrsfs_tpu_torch.losses import synthesis as port_synth
from slrsfs_tpu_torch.losses.ssim import ssim as port_ssim
from slrsfs_tpu_torch.models.baseline import BaselineModel
from slrsfs_tpu_torch.nn.discriminators import MultiscaleDiscriminator
from slrsfs_tpu_torch.nn.norm import Linear
from slrsfs_tpu_torch.nn.vgg import VGG19Features

torch.set_num_threads(1)


def _np_tree(v):
    return jax.tree.map(np.asarray, v)


def _load(module, variables, opt):
    module.load_state_dict(from_jax_variables(_np_tree(variables), opt, module))
    return module


def _assert_state_close(port_module, jax_variables, opt, rtol, atol, keys):
    """Port buffers whose key ends in one of ``keys`` against the JAX
    variables mapped into the port's layout."""
    want = from_jax_variables(_np_tree(jax_variables), opt, port_module)
    got = port_module.state_dict()
    n = 0
    for k, v in got.items():
        if k.rsplit(".", 1)[-1] in keys:
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=rtol,
                                       atol=atol, err_msg=k)
            n += 1
    assert n > 0


def test_settle_matches_jax(real32_env):
    """settle(from_jax_variables(v)) equals JAX settle(v) (n = 2, zero
    noise): BN statistics (the encoder's plain moments, the decoder's
    partial moments) and spectral vectors of every layer, the noise maps'
    included."""
    opt = real32_env["opt"]
    jmodel, v0 = real32_env["model"], real32_env["variables"]
    img = real32_env["img"]
    want = jax_settle(jmodel, v0, (jnp.asarray(img),), n=2)
    model = _load(BaselineModel(opt), v0, opt)
    settle(model, (torch.from_numpy(img),), n=2)
    _assert_state_close(model, want, opt, 1e-5, 1e-5,
                        ("stored_mean", "stored_var"))
    _assert_state_close(model, want, opt, 1e-5, 1e-5, ("weight_u", "weight_v"))
    # the train-mode forward (batch moments, fresh sigma)
    (want_img, want_z), _ = jax.jit(lambda v, x: jmodel.apply(
        v, x, True, True, mutable=["batch_stats", "spectral"]))(
        want, jnp.asarray(img))
    model2 = _load(BaselineModel(opt), want, opt)
    with torch.no_grad():
        got_img, got_z = model2(torch.from_numpy(img), train=True)
    np.testing.assert_allclose(got_z.numpy(), np.asarray(want_z), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("train", [True, False])
def test_noise_maps_match_spectral_dense(train):
    """gain = 1 + Wg·n and bias = Wb·n on a numpy noise vector."""
    rng = np.random.default_rng(3)
    noise = rng.standard_normal((3, 20)).astype(np.float32)
    dense = SpectralDense(12)
    v = dense.init({"params": jax.random.PRNGKey(2)}, jnp.asarray(noise))
    want, ups = dense.apply(v, jnp.asarray(noise), train, mutable=["spectral"])
    lin = Linear(20, 12, spectral=True)
    holder = torch.nn.ModuleDict({"m": lin})
    holder.load_state_dict(from_jax_variables(
        _np_tree({"params": {"m": v["params"]}, "spectral": {"m": v["spectral"]}}),
        Options(), holder))
    got = lin(torch.from_numpy(noise), train)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)
    new_u = np.asarray(ups["spectral"]["sn"]["u"] if train
                       else v["spectral"]["sn"]["u"])
    np.testing.assert_allclose(lin.weight_u.numpy(), new_u, rtol=1e-6, atol=1e-6)


def test_vgg19_matches_jax(vgg_vars32):
    img = np.random.default_rng(4).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    want = jax.jit(JaxVGG().apply)(vgg_vars32, jnp.asarray(img))
    vgg = _load(VGG19Features(), vgg_vars32, Options())
    assert "features.28.weight" in vgg.state_dict()
    with torch.no_grad():
        got = vgg(torch.from_numpy(img))
    assert len(got) == 5
    for g, w in zip(got, want):
        w = np.asarray(w).transpose(0, 3, 1, 2)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())


@pytest.fixture(scope="module")
def d_pair():
    opt = Options(ndf=16)
    img = np.random.default_rng(5).uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32)
    jd = JaxD(opt)
    v = jax.jit(lambda r: jd.init({"params": r}, jnp.asarray(img), True))(
        jax.random.PRNGKey(6))
    return opt, jd, v, img


@pytest.mark.parametrize("train", [False, True])
def test_discriminator_matches_jax(d_pair, train):
    opt, jd, v, img = d_pair
    want, ups = jax.jit(lambda vv, x: jd.apply(vv, x, train,
                                               mutable=["spectral"]))(
        v, jnp.asarray(img))
    d = _load(MultiscaleDiscriminator(opt), v, opt)
    keys = set(d.state_dict())
    for k in ("discriminator_0.model0.0.weight", "discriminator_1.model1.0.0.weight_orig",
              "discriminator_0.model3.0.0.weight_u", "discriminator_1.model4.0.bias"):
        assert k in keys, k
    with torch.no_grad():
        got = d(torch.from_numpy(img), train)
    assert [len(s) for s in got] == [len(s) for s in want]
    for gs, ws in zip(got, want):
        for g, w in zip(gs, ws):
            w = np.asarray(w).transpose(0, 3, 1, 2)
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                       atol=1e-4 * max(1.0, np.abs(w).max()))
    if train:
        _assert_state_close(d, {**v, **ups}, opt, 1e-5, 1e-5,
                            ("weight_u", "weight_v"))


def _imgs(seed, B=2, S=32):
    rng = np.random.default_rng(seed)
    a = np.tanh(rng.standard_normal((B, S, S, 3))).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.2, a.shape), -1, 1).astype(np.float32)
    return a, b


def test_synthesis_losses_match_jax(vgg_vars32):
    a, b = _imgs(7)
    losses = ("1.0_l1", "10.0_content")
    want = jax_synth.SynthesisLoss(losses, JaxVGG(), vgg_vars32)(
        jnp.asarray(a), jnp.asarray(b))
    vgg = _load(VGG19Features(), vgg_vars32, Options())
    with torch.no_grad():
        got = port_synth.SynthesisLoss(losses, vgg)(torch.from_numpy(a),
                                                    torch.from_numpy(b))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    # the reference quirk: the first loss enters Total without its lambda
    np.testing.assert_allclose(float(got["Total Loss"]),
                               float(got["L1"]) + 10.0 * float(got["Perceptual"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(port_ssim(torch.from_numpy(a),
                                               torch.from_numpy(b))),
                               float(jax_ssim(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-5)


@pytest.mark.parametrize("mode", ["hinge", "ls", "original", "wgan"])
def test_gan_losses_match_jax(d_pair, mode):
    opt, jd, v, img = d_pair
    fake, real = img[:2], img[2:]
    d = _load(MultiscaleDiscriminator(opt), v, opt)
    want_g = jax_gan.generator_gan_losses(jd, v, jnp.asarray(fake),
                                          jnp.asarray(real), mode, 10.0,
                                          train=False)
    with torch.no_grad():
        got_g = port_gan.generator_gan_losses(d, torch.from_numpy(fake),
                                              torch.from_numpy(real), mode,
                                              10.0, train=False)
    assert set(got_g) == set(want_g)
    for k in want_g:
        np.testing.assert_allclose(float(got_g[k]), float(want_g[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    want_d = jax_gan.discriminator_losses(jd, v, jnp.asarray(fake),
                                          jnp.asarray(real), mode, train=False)
    with torch.no_grad():
        got_d = port_gan.discriminator_losses(d, torch.from_numpy(fake),
                                              torch.from_numpy(real), mode,
                                              train=False)
    for k in want_d:
        np.testing.assert_allclose(float(got_d[k]), float(want_d[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_partial_bn_counts_and_noise_draw():
    """The partial noise-BN needs its mask to train; with a generator the
    noise is drawn (gain/bias differ from the zero-noise ones)."""
    from slrsfs_tpu_torch.nn.norm import NoiseBN

    bn = NoiseBN(4, spectral=False, partial=True)
    for p in bn.parameters():
        torch.nn.init.normal_(p)
    x = torch.randn(2, 4, 5, 5)
    with pytest.raises(ValueError):
        bn(x, None, train=True)
    mask = (torch.rand(2, 1, 5, 5) > 0.3).float()
    zero = bn(x, mask, train=False)
    drawn = bn(x, mask, train=False, noise=torch.Generator().manual_seed(0))
    assert not torch.allclose(zero, drawn)
    stats = bn.pbn.stored_mean.clone()
    bn(x, mask, train=True)
    assert not torch.equal(stats, bn.pbn.stored_mean)


def test_tiny_discriminator_keys_follow_the_reference():
    """``netD.netD.*`` keys as the JAX importer reads them (a 2-layer D:
    model0 plain, model1 spectral, model2 the plain head)."""
    d = MultiscaleDiscriminator(tiny_options())
    assert sorted(d.state_dict()) == sorted(
        ["discriminator_0.model0.0.weight", "discriminator_0.model0.0.bias",
         "discriminator_0.model1.0.0.weight_orig",
         "discriminator_0.model1.0.0.weight_u",
         "discriminator_0.model1.0.0.weight_v",
         "discriminator_0.model2.0.weight", "discriminator_0.model2.0.bias"])
