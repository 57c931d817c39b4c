"""The port's CLAW metrics (``slrsfs_tpu_torch/eval/metrics.py``,
``eval/feature_nets.py``) against the JAX package's on the CPU: PSNR and
SSIM with and without a mask, PNet-VGG16 Perceptual and LPIPS-alex from one
seeded torchvision-layout ``.pth`` loaded by both packages, the weight
gating, and the weight bridge (``io/convert.py``) as the inverse of JAX's
importers. Measured: PSNR within 1e-7 relative (1.9e-6 dB of ~20 dB, masked),
SSIM within 6e-8, Perceptual within 1.5e-7 and LPIPS within 3.4e-7 relative
(limits 1e-6, 1e-6 and 1e-5 relative)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from slrsfs_tpu.eval import feature_nets as jfn
from slrsfs_tpu.eval import metrics as jm
from slrsfs_tpu_torch.eval import metrics as tm
from slrsfs_tpu_torch.eval.feature_nets import load_lpips_alex
from slrsfs_tpu_torch.eval.random_weights import write_random_weights
from slrsfs_tpu_torch.io import convert

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    return write_random_weights(str(tmp_path_factory.mktemp("eval_weights")), seed=3)


def _pair(seed, n=2, h=40, w=56):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (n, h, w, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    mask = (rng.uniform(0, 1, (n, h, w, 1)) > 0.6).astype(np.float32)
    return a, b, mask


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", ["psnr01", "ssim01"])
def test_psnr_ssim_match_jax(name, masked):
    a, b, mask = _pair(1)
    m = mask if masked else None
    want = float(getattr(jm, name)(jnp.asarray(a), jnp.asarray(b),
                                   None if m is None else jnp.asarray(m)))
    got = float(getattr(tm, name)(torch.from_numpy(a), torch.from_numpy(b),
                                  None if m is None else torch.from_numpy(m)))
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want)), (got, want)


def test_ssim_of_equal_images_is_one():
    a, _, mask = _pair(2)
    t = torch.from_numpy(a)
    assert abs(float(tm.ssim01(t, t)) - 1.0) < 1e-6
    assert abs(float(tm.ssim01(t, t, torch.from_numpy(mask))) - 1.0) < 1e-6


@pytest.mark.parametrize("seed", [4, 5])
def test_perceptual_and_lpips_match_jax(weights, seed):
    """64², one frame a call (as the protocol scores): every key within
    1e-5 relative of JAX's from the same .pth files."""
    a, b, _ = _pair(seed, n=1, h=64, w=64)
    args = (weights["vgg16"], weights["alexnet"], weights["lpips_alex"])
    want = jm.PerceptualMetrics(*args).all_metrics(jnp.asarray(a), jnp.asarray(b))
    got = tm.PerceptualMetrics(*args, device="cpu").all_metrics(a, b)
    assert set(got) == set(want) == {"PSNR", "SSIM", "Perceptual", "LPIPS"}
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-5 * abs(want[k]), (k, got[k], want[k])
    assert got["Perceptual"] > 0 and got["LPIPS"] > 0


@pytest.mark.parametrize("flags", [(), ("vgg16",), ("alexnet",), ("alexnet", "lpips_alex"),
                                   ("vgg16", "alexnet", "lpips_alex")])
def test_weight_gating_matches_jax(weights, flags):
    """No weights give PSNR and SSIM only; Perceptual needs VGG16, LPIPS
    both AlexNet and the linear weights."""
    kw = {f"{n}_pth" if n != "lpips_alex" else "lpips_pth": weights[n] for n in flags}
    a, b, _ = _pair(6, n=1, h=32, w=32)
    want = jm.PerceptualMetrics(**kw).all_metrics(jnp.asarray(a), jnp.asarray(b))
    got = tm.PerceptualMetrics(**kw, device="cpu").all_metrics(a, b)
    assert set(got) == set(want)


def test_feature_taps_match_jax(weights):
    """Each of the five VGG16 and AlexNet taps (NCHW in the port, NHWC in
    JAX) within 1e-5 of its largest value."""
    from slrsfs_tpu_torch.eval.feature_nets import AlexNetFeatures, VGG16Features

    x = np.random.default_rng(7).uniform(-1, 1, (1, 48, 48, 3)).astype(np.float32)
    for net, jnet, imp, key in ((VGG16Features(), jfn.VGG16Features(), jfn.import_vgg16, "vgg16"),
                                (AlexNetFeatures(), jfn.AlexNetFeatures(),
                                 jfn.import_alexnet, "alexnet")):
        sd = torch.load(weights[key])
        net.load_state_dict(sd)
        with torch.no_grad():
            got = [t.permute(0, 2, 3, 1).numpy() for t in net(torch.from_numpy(x))]
        want = [np.asarray(f) for f in jnet.apply(imp(sd), jnp.asarray(x))]
        assert len(got) == len(want) == 5
        for g, w in zip(got, want):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max())


def test_bridge_inverts_the_jax_importers(weights):
    """.pth → JAX importer → the port's converter gives the .pth back bit
    for bit, for VGG16, AlexNet and the LPIPS weights (both key forms)."""
    for key, imp, conv in (("vgg16", jfn.import_vgg16, convert.vgg16_from_jax),
                           ("alexnet", jfn.import_alexnet, convert.alexnet_from_jax)):
        sd = torch.load(weights[key])
        back = conv(imp(sd))
        assert set(back) == set(sd)
        for k in sd:
            assert torch.equal(back[k], sd[k]), k
    sd = torch.load(weights["lpips_alex"])
    back = convert.lpips_alex_from_jax(jfn.import_lpips_alex(sd))
    assert set(back) == set(sd) and all(torch.equal(back[k], sd[k]) for k in sd)
    old_keys = {f"lin{i}.model.1.weight": sd[f"lins.{i}.model.1.weight"] for i in range(5)}
    for got, want in zip(load_lpips_alex(old_keys), jfn.import_lpips_alex(old_keys)):
        assert np.array_equal(got.numpy(), want)
    with pytest.raises(KeyError):
        load_lpips_alex({})
