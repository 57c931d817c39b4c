"""The port's I3D and FVD (``slrsfs_tpu_torch/eval/i3d.py``) against the JAX
package's on the CPU: ``InceptionI3D`` at the protocol's (1, 9, 224, 224, 3)
with randomised BatchNorm statistics from one pytorch-i3d-layout state_dict
(measured max abs 3.4e-5 of features up to 47.7; limit rtol/atol 2e-3 as
tests/test_fvd.py), the TF-SAME padding of convolutions and max pools on odd
and even sides against ``lax.conv_general_dilated``/``nn.max_pool``,
``frechet_distance`` on a full-rank and a rank-deficient set (N = 4, D =
400; 1e-9 relative, measured equal), ``preprocess_video`` bit for bit and the weight bridge
(``io/convert.py:i3d_from_jax``) as the inverse of JAX's ``import_i3d``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn

from slrsfs_tpu.eval import i3d as ji3d
from slrsfs_tpu_torch.eval import i3d as ti3d
from slrsfs_tpu_torch.eval.random_weights import random_state_dict
from slrsfs_tpu_torch.io import convert

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def i3d_sd():
    with torch.device("meta"):
        model = ti3d.InceptionI3D()
    return random_state_dict(model, np.random.default_rng(11))


def test_inception_i3d_matches_jax(i3d_sd):
    model = ti3d.InceptionI3D().eval()
    model.load_state_dict(i3d_sd)
    video = np.random.default_rng(0).uniform(-1, 1, (1, 9, 224, 224, 3)).astype(np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(video)).numpy()
    apply = jax.jit(ji3d.InceptionI3D().apply)
    want = np.asarray(apply(ji3d.import_i3d(i3d_sd), jnp.asarray(video)))
    assert got.shape == want.shape == (1, 400)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    assert np.abs(want).max() > 1e-2  # the features are not vanishing


@pytest.mark.parametrize("shape", [(1, 9, 13, 11, 3), (1, 10, 12, 14, 3)])
@pytest.mark.parametrize("kernel,stride", [((7, 7, 7), (2, 2, 2)), ((3, 3, 3), (1, 1, 1)),
                                           ((1, 3, 3), (1, 2, 2)), ((2, 2, 2), (2, 2, 2))])
def test_same_padding_matches_flax(shape, kernel, stride):
    """Odd and even sides: the port's padded conv and −inf-padded max pool
    equal flax's SAME convolution and max pool."""
    rng = np.random.default_rng(sum(shape) + sum(kernel))
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal(kernel + (3, 4)).astype(np.float32)  # (kT, kH, kW, I, O)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), stride, "SAME",
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC"),
        precision=jax.lax.Precision.HIGHEST)
    xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3)
    got = torch.nn.functional.conv3d(ti3d.same_pad(xt, kernel, stride),
                                     torch.from_numpy(w.transpose(4, 3, 0, 1, 2)),
                                     stride=stride)
    want = np.asarray(want)  # sums of up to 1029 products: 1e-5 of the largest
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(), want,
                               rtol=1e-5, atol=1e-5 * np.abs(want).max())
    want = nn.max_pool(jnp.asarray(x), kernel, strides=stride, padding="SAME")
    got = ti3d.max_pool_same(xt, kernel, stride).permute(0, 2, 3, 4, 1).numpy()
    assert np.array_equal(got, np.asarray(want))


def test_unit3d_matches_flax_on_an_even_clip(i3d_sd):
    """Conv3d_1a_7x7 (k 7, stride 2: pads 2 before and 3 after an even side)
    with its BN and ReLU at T = 60, the protocol's clip, 32²."""
    x = np.random.default_rng(12).uniform(-1, 1, (1, 60, 32, 32, 3)).astype(np.float32)
    unit = ti3d.Unit3D(3, 64, (7, 7, 7), (2, 2, 2)).eval()
    unit.load_state_dict({k.split(".", 1)[1]: v for k, v in i3d_sd.items()
                          if k.startswith("Conv3d_1a_7x7.")})
    with torch.no_grad():
        got = unit(torch.from_numpy(x).permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1).numpy()
    v = ji3d.import_i3d(i3d_sd)
    want = ji3d.Unit3D(64, (7, 7, 7), (2, 2, 2)).apply(
        {"params": v["params"]["Conv3d_1a_7x7"],
         "batch_stats": v["batch_stats"]["Conv3d_1a_7x7"]}, jnp.asarray(x))
    assert got.shape == (1, 30, 16, 16, 64)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n,d", [(300, 8), (4, 400)])
def test_frechet_distance_matches_jax(n, d):
    """Full rank, and the rank-deficient CLAW case that takes the eps·I
    retry: 1e-9 relative."""
    rng = np.random.default_rng(n + d)
    a = rng.standard_normal((n, d))
    b = rng.standard_normal((n, d)) * 1.3 + 0.2
    want = ji3d.frechet_distance(a, b)
    got = ti3d.frechet_distance(a, b)
    assert np.isfinite(got)
    assert abs(got - want) <= 1e-9 * abs(want), (got, want)
    self_d = ti3d.frechet_distance(a, a)  # sqrtm of a singular product is noisy
    assert abs(self_d - ji3d.frechet_distance(a, a)) <= 1e-9 * abs(want)
    assert abs(self_d) < (1e-6 if n > d else 1e-6 * abs(want))


def test_preprocess_video_is_exact():
    v = np.random.default_rng(13).uniform(-0.1, 1.1, (3, 30, 50, 3)).astype(np.float32)
    got = ti3d.preprocess_video(v)
    assert got.shape == (3, 224, 224, 3) and got.dtype == np.float32
    assert np.array_equal(got, ji3d.preprocess_video(v))


def test_bridge_inverts_import_i3d(i3d_sd):
    back = convert.i3d_from_jax(ji3d.import_i3d(i3d_sd))
    assert set(back) == set(i3d_sd)
    for k, v in i3d_sd.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k


def test_fvd_loads_a_state_dict_or_a_module(tmp_path, i3d_sd):
    """A .pt holding the state_dict or the module scores alike; without
    weights FVD is unavailable, as JAX's."""
    model = ti3d.InceptionI3D()
    model.load_state_dict(i3d_sd)
    torch.save(i3d_sd, tmp_path / "sd.pt")
    torch.save(model, tmp_path / "module.pt")
    a = ti3d.FVD(str(tmp_path / "sd.pt"), device="cpu")
    b = ti3d.FVD(str(tmp_path / "module.pt"), device="cpu")
    assert a.available() and b.available()
    assert not ti3d.FVD(None, device="cpu").available()
    assert not ji3d.FVD(None).available()
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, b.model.state_dict()[k]), k
