"""The pix2pixHD networks (``slrsfs_tpu_torch.nn.pix2pixhd``) against the
JAX package's, through JAX's own weight importers.

Weights are drawn with numpy (normal, scaled by 1/sqrt(fan-in)) into the
port's modules, whose state_dicts carry the reference ``define_G`` /
``define_D`` keys; ``import_global_generator``, ``import_local_enhancer``
and ``import_origin_discriminator`` turn them into the JAX variables. The
same numpy input goes through both, at 2e-4 of each output's largest
magnitude, as ``tests/test_pix2pixhd.py`` holds the JAX networks against
the reference's."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from slrsfs_tpu.nn import pix2pixhd as jax_hd
from slrsfs_tpu_torch.nn import pix2pixhd

torch.set_num_threads(1)

RTOL = 2e-4


def _numpy_weights(module: torch.nn.Module, seed: int) -> None:
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            fan_in = max(1, int(np.prod(p.shape[1:]))) if p.ndim > 1 else 1
            scale = 1.0 / np.sqrt(fan_in) if p.ndim > 1 else 0.1
            p.copy_(torch.from_numpy(rng.standard_normal(p.shape) * scale))


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * np.abs(want).max())


def _input(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_global_generator_matches_jax():
    net = pix2pixhd.GlobalGenerator(3, 3, ngf=8, n_downsampling=2, n_blocks=2)
    _numpy_weights(net, 0)
    sd = net.state_dict()
    assert "model.1.weight" in sd and "model.10.conv_block.5.weight" in sd
    x = _input(1, (2, 32, 32, 3))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    jnet = jax_hd.GlobalGenerator(out_channels=3, ngf=8, n_downsampling=2, n_blocks=2)
    want = jnet.apply(jax_hd.import_global_generator(sd, n_downsampling=2, n_blocks=2),
                      jnp.asarray(x))
    assert got.shape == (2, 32, 32, 3)
    _close(got, want)


def test_local_enhancer_matches_jax():
    net = pix2pixhd.LocalEnhancer(3, 3, ngf=4, n_downsample_global=2, n_blocks_global=2,
                                  n_blocks_local=2)
    _numpy_weights(net, 2)
    sd = net.state_dict()
    assert {"model1_1.1.weight", "model1_2.2.weight"} <= set(sd)
    x = _input(3, (2, 32, 32, 3))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    jnet = jax_hd.LocalEnhancer(out_channels=3, ngf=4, n_downsample_global=2,
                                n_blocks_global=2, n_blocks_local=2)
    want = jnet.apply(jax_hd.import_local_enhancer(sd, n_downsample_global=2,
                                                   n_blocks_global=2, n_blocks_local=2),
                      jnp.asarray(x))
    _close(got, want)


@pytest.mark.parametrize("in_channels, num_D", [(3, 2), (2, 2), (2, 3)])
def test_origin_discriminator_matches_jax(in_channels, num_D):
    """Every scale's output; the finest (on the full-resolution input) is
    the module named layer{num_D-1}, and the pooling excludes padding."""
    net = pix2pixhd.OriginMultiscaleDiscriminator(in_channels, ndf=8, n_layers=3,
                                                  num_D=num_D)
    _numpy_weights(net, 4 + num_D)
    sd = net.state_dict()
    assert f"layer{num_D - 1}.11.weight" in sd
    x = _input(5, (2, 32, 32, in_channels))
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    jnet = jax_hd.OriginMultiscaleDiscriminator(ndf=8, n_layers=3, num_D=num_D)
    want = jnet.apply(jax_hd.import_origin_discriminator(sd, num_D=num_D, n_layers=3),
                      jnp.asarray(x))
    assert len(got) == len(want) == num_D
    for g, w in zip(got, want):
        assert len(g) == len(w) == 1
        _close(g[0].permute(0, 2, 3, 1).numpy(), w[0])
    with torch.no_grad():  # the finest scale sees the unpooled input
        first = getattr(net, f"layer{num_D - 1}")(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert torch.equal(first, got[0][0])


def test_downsample_excludes_padding():
    x = torch.ones((1, 1, 5, 5))
    assert torch.equal(pix2pixhd.downsample(x), torch.ones((1, 1, 3, 3)))
