"""The port's motion regressor against the JAX package's, on the same
numpy-seeded inputs and weights.

JAX variables are drawn with numpy into ``jax.eval_shape``'s shapes (each
spectral pair settled by power iterations, so that sigma is the kernel's
top singular value) and carried into the port by ``from_jax_variables``:

* ``SPADEUnet4MaskMotion`` and ``Unet4Motion`` through ``MotionRegressor``
  at depth 4, width 4, 32² (as tests/test_motion.py sizes them), and the
  SPADE UNet at the reference's depth 8 (256², width 2): within 1e-5 of
  max |pred|;
* the bridge both ways at depth 8: the port's state_dict, under a
  standalone checkpoint's prefix and under a fluid model's, read by the
  JAX ``import_motion_model`` gives back the JAX variables;
* SPADE's segmap resize for 1, 4 and 6 channels at sizes that are not 2x
  steps (1e-6), ``moving_region_mask`` exact."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from slrsfs_tpu.config import Options as JaxOptions
from slrsfs_tpu.io.checkpoint import import_motion_model
from slrsfs_tpu.models import motion as jax_motion
from slrsfs_tpu_torch.config import Options
from slrsfs_tpu_torch.io.checkpoint import motion_state
from slrsfs_tpu_torch.io.convert import from_jax_variables
from slrsfs_tpu_torch.models import get_model
from slrsfs_tpu_torch.models import motion as port_motion

torch.set_num_threads(1)


def jax_motion_variables(jopt, size: int, seed: int):
    """Numpy-drawn variables of the JAX ``MotionRegressor(jopt)`` at
    ``size``²: LeCun-normal kernels, small biases, and each spectral (u, v)
    the top singular pair of its kernel (30 power iterations on JAX's
    (out, kh·kw·in) matrix)."""
    model = jax_motion.MotionRegressor(jopt)
    x = jnp.zeros((1, size, size, 1))
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, size, size, 3)), x,
        jnp.zeros((1, size, size, 2))))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(np.float32)
        return (rng.standard_normal(leaf.shape) * 0.05).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(draw, shapes["params"])

    def settle(spec, par):
        for k, node in spec.items():
            if k == "sn":
                kernel = par["kernel"]
                w = kernel.transpose(3, 0, 1, 2).reshape(kernel.shape[3], -1)
                u = rng.standard_normal(w.shape[0])
                for _ in range(30):
                    v = w.T @ u
                    v /= np.linalg.norm(v) + 1e-12
                    u = w @ v
                    u /= np.linalg.norm(u) + 1e-12
                node["u"], node["v"] = u.astype(np.float32), v.astype(np.float32)
            else:
                settle(node, par[k])

    spec = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes["spectral"])
    settle(spec, params)
    return model, {"params": params, "spectral": spec}


def _inputs(size: int, seed: int):
    rng = np.random.default_rng(seed)
    img = (rng.standard_normal((1, size, size, 3)) * 0.5).astype(np.float32)
    mask = (rng.random((1, size, size, 1)) > 0.5).astype(np.float32)
    hint = (rng.standard_normal((1, size, size, 2)) * mask).astype(np.float32)
    return img, mask, hint


def _port_regressor(jopt, variables):
    popt = Options(**{f: getattr(jopt, f) for f in jopt.__dataclass_fields__})
    model = get_model(popt).eval()
    model.load_state_dict(from_jax_variables(jax.tree.map(np.asarray, variables),
                                             popt))
    return model


def _check_pred(jopt, size, seed):
    jmodel, variables = jax_motion_variables(jopt, size, seed)
    img, mask, hint = _inputs(size, seed + 1)
    want = np.asarray(jax.jit(jmodel.apply)(variables, img, mask, hint))
    model = _port_regressor(jopt, variables)
    with torch.no_grad():
        got = model(*(torch.from_numpy(a) for a in (img, mask, hint))).numpy()
    assert got.shape == want.shape == (1, size, size, 2)
    err = np.abs(got - want).max()
    assert err <= 1e-5 * np.abs(want).max(), (err, np.abs(want).max())
    return jmodel, variables, model


@pytest.mark.parametrize("model_type", ["SPADE_unet_mask_motion", "unet_motion"])
def test_regressor_matches_jax(model_type):
    jopt = JaxOptions(model_type=model_type, W=32, motionW=32, motionH=32,
                      motion_num_filters=4, motion_unet_downs=4, div_flow=2.0)
    _check_pred(jopt, 32, 3)


def test_spade_full_depth_matches_jax_and_bridges_both_ways():
    """Depth 8, the reference's names: the prediction, and the port's
    state_dict through the JAX importer under both key prefixes."""
    jopt = JaxOptions(model_type="SPADE_unet_mask_motion", W=256, motionW=256,
                      motionH=256, motion_num_filters=2)
    _, variables, model = _check_pred(jopt, 256, 5)
    sd = model.state_dict()
    assert sum(k.startswith("motion_predictor.spade_layer8_") for k in sd) == 8 * 6
    want = jax.tree.map(np.asarray, variables)
    for prefix in ("motion_predictor.", "motion_regressor.motion_predictor."):
        got = import_motion_model(
            {prefix + k[len("motion_predictor."):]: v for k, v in sd.items()}, jopt)
        got = {c: t for c, t in got.items() if t}  # an empty 'batch_stats'
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(g, w)
        # and back: the port reads either prefix
        back = motion_state({"model.module." + prefix + k[len("motion_predictor."):]: v
                             for k, v in sd.items()})
        assert back.keys() == sd.keys()


@pytest.mark.parametrize("c", [1, 4, 6])
@pytest.mark.parametrize("size", [(5, 7), (12, 9), (40, 24)])
def test_resize_segmap_matches_jax(c, size):
    """A segmap's range: image and hint in [-1, 1], the mask 0 or 1. The
    port's ``resize_bilinear`` writes out JAX's two-tap rule with its f32
    steps (source coordinate, floor and clamp, clipped fraction, rows then
    columns), so the two are bit-equal against JAX's op-by-op run, on the
    downscales SPADE takes and on the upscale to 40 rows alike. (Under
    ``jax.jit`` XLA fuses the two taps and rounds differently, by up to
    ~1.6e-6 on the upscale.)"""
    x = np.random.default_rng(c).uniform(-1, 1, (2, 17, 23, c)).astype(np.float32)
    if c >= 4:
        x[..., 3] = x[..., 3] > 0
    want = np.asarray(jax_motion._resize_segmap(jnp.asarray(x), *size))
    got = port_motion._resize_segmap(torch.from_numpy(x).permute(0, 3, 1, 2),
                                     *size).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_moving_region_mask_matches_jax():
    m = np.random.default_rng(0).standard_normal((2, 9, 11, 2)).astype(np.float32)
    m[0, :4] *= 0.01  # below 0.1 of the mean speed
    want = np.asarray(jax_motion.moving_region_mask(jnp.asarray(m)))
    got = port_motion.moving_region_mask(torch.from_numpy(m)).numpy()
    assert 0 < want.mean() < 1
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [dict(model_type="unet_motion"),
                                dict(model_type="softmax_splating",
                                     motion_model_type="unet_motion"),
                                dict(model_type="softmax_splating")])
def test_resolved_motion_model_type_matches_jax(kw):
    assert (port_motion.resolved_motion_model_type(Options(**kw))
            == jax_motion.resolved_motion_model_type(JaxOptions(**kw)))


def test_enc_mults_match_jax():
    for d in range(1, 10):
        assert port_motion._enc_mults(d) == jax_motion._enc_mults(d)
