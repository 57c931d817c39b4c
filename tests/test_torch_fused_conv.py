"""K9's plain version (``slrsfs_tpu_torch.ops.fused_conv.conv_chain_plain``)
against the repository's Pallas prototype, ``tools/pallas_conv_prototype.py``
(imported from its path: ``tools/`` is not a package), on the same bf16
inputs drawn with numpy:

* ``fused``, the Pallas kernel, run in interpret mode (``pl.pallas_call``
  with ``interpret=True``) at (1, 32, 16, 128) with TH = 8, which covers the
  first, inner and last row tiles;
* ``xla_chain`` at (2, 32, 48, 128).

Limits: 2^-7 of max |ref|, and at most 0.1 % of the elements more than one
bf16 ulp apart (both sides round the f32 sums of bf16 products to bf16;
the sums run in other orders). Measured here: against ``xla_chain``
3.9e-3 at max |ref| 1.61, with 3.6e-4 of the elements beyond one ulp;
against interpret-mode ``fused`` 3.9e-3 at 1.45, with 3.8e-4.

The wrapper on CPU tensors is the plain version, and it refuses, on every
device, what the kernel does not take. ``pack_weights``, the kernel's
weight stream (swizzled tap images), is checked against a direct formula
for each element's address and round-tripped back to HWIO."""

import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from slrsfs_tpu_torch import kernels
from slrsfs_tpu_torch.ops import fused_conv as port
from slrsfs_tpu_torch.tools import conv_prototype

torch.set_num_threads(1)

PROTOTYPE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "tools", "pallas_conv_prototype.py")


@pytest.fixture(scope="module")
def proto():
    spec = importlib.util.spec_from_file_location("pallas_conv_prototype", PROTOTYPE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(B, H, W, C=128, F=128, seed=0):
    """bf16 numpy-drawn x (B, H, W, C) and HWIO weights, as float32 arrays
    holding bf16 values."""
    rng = np.random.default_rng(seed)
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
                              .astype(jnp.float32))
    return (bf(rng.standard_normal((B, H, W, C)) * 0.5),
            bf(rng.standard_normal((3, 3, C, F)) / np.sqrt(9 * C)),
            bf(rng.standard_normal((3, 3, F, F)) / np.sqrt(9 * F)))


def _port(x, waa, wab):
    return port.conv_chain_plain(*(torch.from_numpy(a).to(torch.bfloat16)
                                   for a in (x, waa, wab)))


def _jax(fn, x, waa, wab):
    return torch.from_numpy(np.asarray(fn(*(jnp.asarray(a).astype(jnp.bfloat16)
                                            for a in (x, waa, wab)))
                                       .astype(jnp.float32)))


def _within(got, ref):
    c = conv_prototype.compare(got, ref)
    assert conv_prototype.within_limits(c), c
    return c


def test_plain_matches_pallas_fused_interpret(proto, monkeypatch):
    monkeypatch.setattr(proto.pl, "pallas_call",
                        functools.partial(proto.pl.pallas_call, interpret=True))
    x, waa, wab = _inputs(1, 32, 16)
    ref = _jax(jax.jit(functools.partial(proto.fused, TH=8)), x, waa, wab)
    _within(_port(x, waa, wab), ref)


def test_plain_matches_xla_chain(proto):
    x, waa, wab = _inputs(2, 32, 48, seed=1)
    ref = _jax(jax.jit(proto.xla_chain), x, waa, wab)
    got = _port(x, waa, wab)
    assert got.shape == (2, 32, 48, 128) and got.dtype == torch.bfloat16
    _within(got, ref)


@pytest.mark.parametrize("shape", [(1, 7, 11, 32, 64), (2, 9, 5, 16, 32)])
def test_plain_matches_xla_chain_ragged(proto, shape):
    """Sizes the kernel's tiles do not divide, and other widths."""
    B, H, W, C, F = shape
    x, waa, wab = _inputs(B, H, W, C, F, seed=2)
    _within(_port(x, waa, wab), _jax(proto.xla_chain, x, waa, wab))


def test_wrapper_on_cpu_is_the_plain_version():
    x, waa, wab = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in _inputs(1, 9, 10, 32, 32, seed=3))
    kernels.reset_counts()
    assert torch.equal(port.fused_conv3x3_relu_conv3x3(x, waa, wab),
                       port.conv_chain_plain(x, waa, wab))
    assert kernels.counts()[kernels.FUSED_CONV.name] == 0


@pytest.mark.parametrize("bad", ["dtype", "layout", "misaligned", "C", "F",
                                 "C_wide", "F_wide", "weights"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    C, F = 32, 32
    if bad == "C":
        C = 24
    elif bad == "F":
        F = 48
    elif bad == "C_wide":
        C = 144  # a multiple of 16 past the 128 of two swizzled rows
    elif bad == "F_wide":
        F = 160  # a multiple of 32 past the 128 packed output channels
    x = torch.zeros((1, 8, 8, C), dtype=torch.bfloat16)
    waa = torch.zeros((3, 3, C, F), dtype=torch.bfloat16)
    wab = torch.zeros((3, 3, F, F), dtype=torch.bfloat16)
    if bad == "dtype":
        x = x.float()
    elif bad == "layout":  # NCHW memory is not the kernel's NHWC
        x = torch.zeros((1, C, 8, 8), dtype=torch.bfloat16).permute(0, 2, 3, 1)
    elif bad == "misaligned":
        x = torch.zeros((1 * 8 * 8 * C + 1,), dtype=torch.bfloat16)[1:].reshape(1, 8, 8, C)
    elif bad == "weights":
        waa = waa.permute(3, 2, 0, 1)  # OIHW, not HWIO
    with pytest.raises((TypeError, ValueError)):
        port.fused_conv3x3_relu_conv3x3(x, waa, wab)


@pytest.mark.parametrize("C, F, ratio", [
    (128, 128, 1.25), (64, 64, 2.5),
    (16, 32, (192 + 128) * 64 * 128 / (128 * (16 * 32 + 32 * 32)))])
def test_work_ratio_counts_the_issued_rows_and_channels(C, F, ratio):
    """At the 8x16 tile conv1 runs on 3 m64 row tiles for the 180 pixels
    of h and conv2 on 2 for 128: (192 + 128) / 256 = 1.25 at C = F = 128.
    Input channels are rounded up to whole 64-channel swizzle rows and the
    outputs to the 128 packed ones: C = F = 64 issues twice that, and C = 16,
    F = 32 issues (192 + 128) · 64 · 128 multiply-adds per 128 · (16 · 32 +
    32 · 32) useful ones."""
    assert port.TILE == (8, 16)
    assert port.work_ratio(C, F) == ratio


def _hwio(C, F, seed):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((3, 3, C, F)).astype(np.float32)
                             ).to(torch.bfloat16),
            torch.from_numpy(rng.standard_normal((3, 3, F, F)).astype(np.float32)
                             ).to(torch.bfloat16))


@pytest.mark.parametrize("C, F", [(128, 128), (16, 32)])
def test_pack_weights_swizzled_addresses(C, F):
    """Every (tap, k, n) of both convs against the direct formula for its
    byte address in the stream: image t of conv1 at t · I1, of conv2 at
    9 · I1 + t · I2 (I = Kp · 128 · 2 bytes, Kp = K rounded up to 64), then
    (k // 64) · 128 rows of 128 bytes, row n, the 16-byte chunk
    ((k % 64) // 8) XOR (n % 8), the element k % 8; zeros elsewhere."""
    waa, wab = _hwio(C, F, seed=4)
    packed = port.pack_weights(waa, wab)
    i1, i2 = port.tap_image_bytes(C), port.tap_image_bytes(F)
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    assert packed.numel() * 2 == 9 * (i1 + i2)
    want = torch.zeros_like(packed)
    for base, w in ((0, waa), (9 * i1, wab)):
        K = w.shape[2]
        img = port.tap_image_bytes(K)
        t, k, n = torch.meshgrid(torch.arange(9), torch.arange(K), torch.arange(F),
                                 indexing="ij")
        addr = (base + t * img + (k // 64) * 128 * 128 + n * 128
                + (((k % 64) // 8) ^ (n % 8)) * 16 + (k % 8) * 2)
        assert (addr % 2 == 0).all()
        want[(addr // 2).reshape(-1)] = w.reshape(9, K, F).reshape(-1)
    assert torch.equal(packed, want)


def _unpack(packed, C, F):
    """``pack_weights``' inverse: the (3, 3, C, F) and (3, 3, F, F) HWIO
    weights, undoing the swizzle chunk by chunk."""
    out, start = [], 0
    for K in (C, F):
        kp = -(-K // 64) * 64
        t = packed[start:start + 9 * kp * 128].reshape(9, kp // 64, 128, 8, 8)
        start += 9 * kp * 128
        n = torch.arange(128)
        pos = torch.arange(8)[None, :] ^ (n % 8)[:, None]  # (n, chunk) -> position
        t = t.gather(3, pos[None, None, :, :, None].expand(t.shape))
        t = t.permute(0, 1, 3, 4, 2).reshape(9, kp, 128)
        out.append(t[:, :K, :F].reshape(3, 3, K, F))
    assert start == packed.numel()
    return out


@pytest.mark.parametrize("C, F", [(128, 128), (16, 32), (48, 96)])
def test_pack_weights_round_trip(C, F):
    waa, wab = _hwio(C, F, seed=5)
    ua, ub = _unpack(port.pack_weights(waa, wab), C, F)
    assert torch.equal(ua, waa) and torch.equal(ub, wab)


def test_prototype_inputs_match_jax():
    """The bench's deterministic inputs are the prototype's (:150-157),
    value for value, at a small shape."""
    B, H, W, C, F = 2, 3, 5, 16, 32
    x, waa, wab = conv_prototype.make_inputs(B, H, W, C, F, "cpu")
    want = (
        ((jnp.arange(B * H * W * C, dtype=jnp.int32).reshape(B, H, W, C) % 17) - 8
         ).astype(jnp.bfloat16) * 0.1,
        ((jnp.arange(9 * C * F, dtype=jnp.int32).reshape(3, 3, C, F) % 13) - 6
         ).astype(jnp.bfloat16) * 0.01,
        ((jnp.arange(9 * F * F, dtype=jnp.int32).reshape(3, 3, F, F) % 11) - 5
         ).astype(jnp.bfloat16) * 0.01)
    for got, w in zip((x, waa, wab), want):
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(w.astype(jnp.float32)))


def test_compare_counts_ulps():
    ref = torch.tensor([1.0, 2.0, 0.0, -4.0], dtype=torch.bfloat16)
    got = torch.tensor([1.0078125, 2.0, 0.0, -4.03125], dtype=torch.bfloat16)
    c = conv_prototype.compare(got, ref)  # one ulp at 1 and at 4: not beyond
    assert c["beyond_ulp_share"] == 0.0 and c["max_abs_err"] == 0.03125
    got[1] = 2.03125  # two ulps at 2
    assert conv_prototype.compare(got, ref)["beyond_ulp_share"] == 0.25
