"""The port's baseline encoder/decoder (slrsfs_tpu_torch.nn) against the JAX
modules, with the JAX variables carried over by ``from_jax_variables``.

Real reference archs at ngf=16, 32² (the settled ``real32_env`` variables).
Features are held at 1e-4 and tanh frames at 2e-3, the tolerances of the
JAX package's own chain parity (tests/test_forward_flow_parity.py:103): the
two frameworks sum convolutions in different orders."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from slrsfs_tpu.nn import conv as jax_conv
from slrsfs_tpu_torch.io.convert import from_jax_variables
from slrsfs_tpu_torch.models.baseline import BaselineModel
from slrsfs_tpu_torch.nn import conv as port_conv

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair(real32_env):
    """(JAX env, port model with the same weights)."""
    opt = real32_env["opt"].replace(bn_noise_misc=True)
    variables = jax.tree.map(np.asarray, real32_env["variables"])
    model = BaselineModel(opt).eval()
    model.load_state_dict(from_jax_variables(variables, opt))
    return real32_env, model


def _jax_encode(env, img):
    model = env["model"]
    return jax.jit(lambda v, x: model.apply(v, x, method="encode"))(
        env["variables"], jnp.asarray(img))


def test_encoder_matches_jax(pair):
    env, model = pair
    want_fs, want_z = _jax_encode(env, env["img"])
    with torch.no_grad():
        fs, z = model.encode(torch.from_numpy(env["img"]))
    np.testing.assert_allclose(fs.numpy(), np.asarray(want_fs), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(z.numpy(), np.asarray(want_z), rtol=1e-4, atol=1e-4)


def test_decoder_matches_jax(pair):
    """Decode features with splat holes: whole pixels at exactly 0 (the
    partial convs' mask) and a few single zero channels."""
    env, model = pair
    fs = np.array(_jax_encode(env, env["img"])[0])
    rng = np.random.default_rng(7)
    fs[0, 5:9, 3:20] = 0.0
    fs[0, rng.integers(0, 32, 40), rng.integers(0, 32, 40),
       rng.integers(0, 64, 40)] = 0.0
    jmodel = env["model"]
    want = jax.jit(lambda v, x: jmodel.apply(v, x, method="decode"))(
        env["variables"], jnp.asarray(fs))
    with torch.no_grad():
        got = model.decode(torch.from_numpy(fs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3, atol=2e-3)


def test_state_dict_uses_reference_key_names(pair):
    _, model = pair
    keys = set(model.state_dict())
    for k in ("encoder.gblocks.0.ch_a.0.gain.weight_orig",
              "encoder.gblocks.0.ch_a.0.bn.stored_mean",
              "encoder.gblocks.0.ch_a.2.weight_v",
              "encoder.gblocks.7.ch_b.0.bias",
              "projector.eblocks.0.bn_noise1.pbn.stored_var",
              "projector.eblocks.1.conv_aa.weight_u",
              "projector.eblocks.1.conv_b.weight_orig"):
        assert k in keys, k
    # 'woresbias': pconv shortcuts carry no bias
    assert "projector.eblocks.1.conv_b.bias" not in keys


@pytest.mark.parametrize("name", ["avg_pool_3x3s2", "max_pool_3x3s2",
                                  "upsample_nearest_2x", "upsample_bilinear_2x"])
def test_resampling_matches_jax(name):
    x = np.random.default_rng(1).standard_normal((2, 9, 12, 3)).astype(np.float32)
    want = np.asarray(getattr(jax_conv, name)(jnp.asarray(x)))
    got = getattr(port_conv, name)(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("variant", [{}, {"use_softmax_splatter_v1": True},
                                     {"use_softmax_splatter_v3": True},
                                     {"no_clamp_Z": True}])
def test_z_normalize_and_pack_match_jax(variant):
    from slrsfs_tpu.config import Options as JaxOptions
    from slrsfs_tpu.models import baseline as jax_baseline
    from slrsfs_tpu_torch.config import Options
    from slrsfs_tpu_torch.models import baseline as port_baseline

    rng = np.random.default_rng(8)
    z = (rng.standard_normal((1, 6, 5, 1)) * 15.0).astype(np.float32)
    fs = rng.standard_normal((1, 6, 5, 4)).astype(np.float32)
    want_zn = np.asarray(jax_baseline.z_normalize(JaxOptions(**variant), z, None))
    zn = port_baseline.z_normalize(Options(**variant), torch.from_numpy(z))
    np.testing.assert_allclose(zn.numpy(), want_zn, rtol=1e-6, atol=1e-6)
    want_u = np.asarray(jax_baseline.pack_splat_input(jnp.asarray(fs), want_zn))
    u = port_baseline.pack_splat_input(torch.from_numpy(fs), zn)
    np.testing.assert_allclose(u.numpy(), want_u, rtol=1e-6, atol=1e-6)
