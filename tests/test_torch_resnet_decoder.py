"""The port's plain ``ResNetDecoder`` (slrsfs_tpu_torch.nn.resnets) against
the JAX ``ResNetDecoder`` on the five arch tables that JAX's own test
builds (tests/test_nn_parity.py:178-184), at ngf 8 on a 16² input, with the
JAX variables carried over by ``from_jax_variables``.

The JAX init is traced by ``jax.eval_shape`` only and the variables are
drawn with numpy into its shapes (LeCun-normal kernels, small biases, unit
BN variance), with each spectral (u, v) set to its kernel's top singular
pair, so that the eval-mode sigma is the kernel's norm and the features
stay O(1) through every block without train-mode settling; the JAX forward
runs under ``jax.jit`` (its eager run of these tables takes ~20 s).
Features are held at 1e-4, the tolerance of ``tests/test_torch_nn.py``'s
encoder (the frameworks sum convolutions in different orders)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from slrsfs_tpu.config import Options as JaxOptions
from slrsfs_tpu.nn.archs import get_resnet_arch
from slrsfs_tpu.nn.resnets import ResNetDecoder as JaxResNetDecoder
from slrsfs_tpu_torch.config import Options
from slrsfs_tpu_torch.io.convert import from_jax_variables
from slrsfs_tpu_torch.nn.resnets import ResNetBGDecoder, ResNetDecoder

torch.set_num_threads(1)

TABLES = ("resnet_256W16UpDown64_nonorm", "resnet_256W5UpDown64BG_nonorm",
          "resnet_256W8UpDown64SingleAlpha_nonorm",
          "resnet_256W5UpDown64Layers_nonorm", "resnet_256W5UpDown64_nonorm")
SIDE = 16


def _settle_spectral(spectral: dict, params: dict) -> None:
    """Each ``sn`` node's (u, v) := the top singular pair of its module's
    kernel, reshaped as ``SpectralWeight`` does (output axis first)."""
    for name, node in spectral.items():
        if name == "sn":
            w = params["kernel"]
            mat = np.moveaxis(w, -1, 0).reshape(w.shape[-1], -1).astype(np.float64)
            u, _, vt = np.linalg.svd(mat, full_matrices=False)
            node["u"], node["v"] = u[:, 0].astype(np.float32), vt[0].astype(np.float32)
        else:
            _settle_spectral(node, params[name])


def _numpy_variables(module, x, seed: int) -> dict:
    shapes = jax.eval_shape(
        lambda r, a: module.init(r, a, False, True),
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jax.ShapeDtypeStruct(x.shape, x.dtype))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            a = rng.standard_normal(leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
        elif name == "stored_var":
            a = np.ones(leaf.shape)
        elif name in ("u", "v", "stored_mean"):
            a = np.zeros(leaf.shape)
        else:
            a = rng.standard_normal(leaf.shape) * 0.1
        return np.asarray(a, np.float32)

    variables = jax.tree_util.tree_map_with_path(draw, shapes)
    _settle_spectral(variables["spectral"], variables["params"])
    return variables


@pytest.mark.parametrize("model_type", TABLES)
def test_resnet_decoder_matches_jax(model_type):
    jopt = JaxOptions(ngf=8, refine_model_type=model_type, addtional_decoder_output=0)
    opt = Options(**dataclasses.asdict(jopt))
    arch = get_resnet_arch(model_type, jopt)
    x = np.random.default_rng(3).standard_normal(
        (1, SIDE, SIDE, arch["layers_dec"][0])).astype(np.float32)
    jdec = JaxResNetDecoder(jopt)
    variables = _numpy_variables(jdec, x, seed=len(model_type))
    want = np.asarray(jax.jit(lambda v, a: jdec.apply(v, a, False, True))(variables, x))
    # the table from opt.refine_model_type, and the same table passed by
    # name beside another refine_model_type
    by_name = opt.replace(refine_model_type="resnet_256W8UpDown64_de_resnet_nonorm")
    for dec in (ResNetDecoder(opt), ResNetDecoder(by_name, model_type=model_type)):
        dec.load_state_dict(from_jax_variables(variables, opt, model=dec))
        with torch.no_grad():
            got = dec.eval()(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        assert got.shape == want.shape == (1, SIDE, SIDE, arch["layers_dec"][-1])
        assert np.isfinite(want).all() and 0.05 < np.abs(want).max() < 50.0
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    assert all(k.startswith("eblocks.") for k in dec.state_dict())


def test_bg_decoder_is_the_plain_decoder_over_its_table():
    """``ResNetBGDecoder`` is ``ResNetDecoder`` over
    ``opt.bg_refine_model_type``: the same keys and shapes."""
    opt = Options(ngf=8, bg_refine_model_type="resnet_256W5UpDown64BG_nonorm")
    bg = ResNetBGDecoder(opt)
    plain = ResNetDecoder(opt, model_type=opt.bg_refine_model_type)
    assert isinstance(bg, ResNetDecoder)
    assert {k: v.shape for k, v in bg.state_dict().items()} == \
        {k: v.shape for k, v in plain.state_dict().items()}
