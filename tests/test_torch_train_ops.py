"""The training pass's ops (K7, K3 with its VJP) against the JAX package.

* K7's plain versions against ``euler_integrate_phased`` and
  ``euler_integrate_phased_compact`` (vmapped as ``train_integrate`` does):
  bit for bit, on t_p = 0, t_f = 0, t_f + t_p = T, trajectories leaving the
  grid, padded rows and a moving pixel at (0, 0).
* K3: ``softsplat_sum`` (the ``torch.autograd.Function``, plain on the CPU)
  and its VJP against ``jax.vjp`` of the JAX ``softsplat_sum``: forward at
  1e-5 with the same exact zeros, ``grad_inp`` and ``grad_flow`` at 1e-5 of
  each output's maximum (summation order)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from slrsfs_tpu.ops.euler import (
    euler_integrate_phased as jax_phased,
    euler_integrate_phased_compact as jax_phased_compact,
)
from slrsfs_tpu.ops.splat import softsplat_sum as jax_softsplat_sum
from slrsfs_tpu_torch.ops import euler as port_euler
from slrsfs_tpu_torch.ops import splat as port_splat

torch.set_num_threads(1)

H, W, T = 20, 24, 9


def _phased_case():
    """Five samples: t_p = 0, t_f = 0, t_f + t_p = T, a middle case and a
    quarter-pixel flow with rounding ties; the bottom rows leave the frame;
    the top third is static; the pixel at (0, 0) moves."""
    rng = np.random.default_rng(0)
    m = (rng.standard_normal((5, H, W, 2)) * 1.3).astype(np.float32)
    m[4] = np.round(m[4] * 4.0) / 4.0
    m[:, H - 4:, :, 1] += 4.0
    m[:, 1: H // 3] = 0.0
    m[:, 0, 0] = [0.5, 1.5]
    t_f = np.array([6, 0, 4, 3, 5], np.int32)
    t_p = np.array([0, 7, 5, 2, 4], np.int32)
    return m, t_f, t_p


def _moving_sets(m, P):
    B = m.shape[0]
    pos = np.zeros((B, P, 2), np.int32)
    val = np.zeros((B, P), np.float32)
    for b in range(B):
        ys, xs = np.nonzero(np.any(m[b] != 0, -1))
        pos[b, :len(xs), 0] = xs
        pos[b, :len(xs), 1] = ys
        val[b, :len(xs)] = 1.0
    return pos, val


def test_k7_plain_matches_jax_bit_for_bit():
    m, t_f, t_p = _phased_case()
    want = jax.jit(jax.vmap(lambda mm, a, b: jax_phased(mm, a, b, T)))(
        m, t_f, t_p)
    got = port_euler.euler_integrate_phased(
        torch.from_numpy(m), torch.from_numpy(t_f), torch.from_numpy(t_p), T)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    oob = max(H, W) + 1
    assert (got[1].numpy() == oob).any()  # trajectories left the grid
    assert (got[0][1].numpy() == 0).all()  # t_f = 0
    assert (got[1][0].numpy() == 0).all()  # t_p = 0
    assert (got[1][2].numpy() != 0).any()  # t_f + t_p = T latches at T


def test_k7_compact_plain_matches_jax_and_dense():
    m, t_f, t_p = _phased_case()
    pos, val = _moving_sets(m, 512)  # padded rows point at (0, 0)
    assert (val == 0).any()
    want = jax.jit(jax.vmap(
        lambda mm, p, v, a, b: jax_phased_compact(mm, p, v, a, b, T)))(
        m, pos, val, t_f, t_p)
    args = [torch.from_numpy(a) for a in (m, pos, val, t_f, t_p)]
    got = port_euler.euler_integrate_phased_compact(*args, T)
    dense = port_euler.euler_integrate_phased_plain(args[0], args[3], args[4], T)
    for g, w, d in zip(got, want, dense):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy(), d.numpy())
    assert (got[0][:, 0, 0].numpy() != 0).any()  # the pixel at (0, 0)


def test_k7_wrappers_check_inputs():
    m = torch.zeros((1, 4, 4, 2))
    t = torch.zeros((1,), dtype=torch.int32)
    with pytest.raises(ValueError):
        port_euler.euler_integrate_phased(m, t.long(), t, 2)
    with pytest.raises(TypeError):
        port_euler.euler_integrate_phased(m.double(), t, t, 2)
    with pytest.raises(ValueError):
        port_euler.euler_integrate_phased_compact(
            m, torch.zeros((1, 4, 2), dtype=torch.int32),
            torch.zeros((1, 3)), t, t, 2)


def _splat_case(C=6, B=2, seed=1):
    rng = np.random.default_rng(seed)
    inp = rng.standard_normal((B, H, W, C)).astype(np.float32)
    flow = (rng.standard_normal((B, H, W, 2)) * 2.5).astype(np.float32)
    flow[:, ::4] = np.round(flow[:, ::4])  # integer landings
    flow[0, :3, :5] = max(H, W) + 1  # the OOB sentinel
    g = rng.standard_normal((B, H, W, C)).astype(np.float32)
    return inp, flow, g


def test_k3_function_and_vjp_match_jax():
    inp, flow, g = _splat_case()
    out_j, vjp = jax.vjp(jax_softsplat_sum, jnp.asarray(inp), jnp.asarray(flow))
    gi_j, gf_j = vjp(jnp.asarray(g))
    x = torch.from_numpy(inp).requires_grad_(True)
    f = torch.from_numpy(flow).requires_grad_(True)
    out = port_splat.softsplat_sum(x, f)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(out.detach().numpy() == 0,
                                  np.asarray(out_j) == 0)
    for got, want in ((x.grad, gi_j), (f.grad, gf_j)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def test_k3_grad_plain_matches_autograd_of_the_forward():
    """The hand-written gather VJP equals autograd through the plain
    scatter forward (bilinear weights differentiated by PyTorch)."""
    inp, flow, g = _splat_case(C=3, seed=2)
    x = torch.from_numpy(inp).double().requires_grad_(True)
    f = torch.from_numpy(flow).double().requires_grad_(True)
    port_splat.softsplat_sum_plain(x, f).backward(torch.from_numpy(g).double())
    gi, gf = port_splat.softsplat_sum_grad_plain(
        x.detach(), f.detach(), torch.from_numpy(g).double())
    np.testing.assert_allclose(gi.numpy(), x.grad.numpy(), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(gf.numpy(), f.grad.numpy(), rtol=1e-10, atol=1e-10)
