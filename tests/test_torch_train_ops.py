"""The training pass's ops (K7, K3 with its VJP) against the JAX package.

* K7's plain versions against ``euler_integrate_phased`` and
  ``euler_integrate_phased_compact`` (vmapped as ``train_integrate`` does):
  bit for bit, on t_p = 0, t_f = 0, t_f + t_p = T, trajectories leaving the
  grid, padded rows and a moving pixel at (0, 0); and a host mirror of the
  CUDA kernel's control flow (split loops, early exit, stored compact rows)
  bit for bit against the JAX scan, with the moving sets' contract.
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


def _k7_mirror(m, t_f, t_p, n_steps, pos=None, val=None):
    """K7's control flow (``csrc/euler_phased.cu``) in plain torch: the
    scan split at t_f into a forward loop of +M and a backward loop of -M
    from the source, each run only when it latches, each trajectory
    leaving its phase at its first step that leaves the frame (a source on
    zero motion not gathering at all), and the loop ending when every
    trajectory has left;
    compact rows with valid != 0 store 0 + out · valid on a zero grid,
    padded rows are skipped."""
    m = torch.from_numpy(m)
    B, Hm, Wm, _ = m.shape
    oob = float(max(Hm, Wm) + 1)
    outs = [torch.zeros((B, Hm * Wm, 2)), torch.zeros((B, Hm * Wm, 2))]
    for b in range(B):
        mb = m[b].reshape(-1, 2)
        if pos is None:
            ys, xs = torch.meshgrid(torch.arange(Hm), torch.arange(Wm), indexing="ij")
            src = torch.stack([xs, ys], -1).reshape(-1, 2).float()
        else:
            src = torch.from_numpy(pos[b]).float()
        tf, tp = int(t_f[b]), int(t_p[b])
        k0 = max(tf, 0)
        phases = [(1.0, tf, 1 <= tf <= n_steps),
                  (-1.0, tf + tp - k0, tp > 0 and 1 <= tf + tp <= n_steps)]
        for out, (sign, steps, latches) in zip(outs, phases):
            if not latches:
                continue
            dest = src.clone()
            at = src.long()  # a source at rest on zero motion never moves
            alive = (mb[at[:, 1] * Wm + at[:, 0]] != 0).any(1)  # still gathering
            valid = torch.ones(src.shape[0], dtype=torch.bool)
            for _ in range(steps):
                if not alive.any():
                    break
                ix = torch.round(dest[alive, 0]).long().clamp(0, Wm - 1)
                iy = torch.round(dest[alive, 1]).long().clamp(0, Hm - 1)
                g = mb[iy * Wm + ix]
                g = -g if sign < 0 else g
                d = dest[alive] + g
                dest[alive] = d
                inside = ~((d[:, 0] > Wm - 1) | (d[:, 0] < 0) | (d[:, 1] > Hm - 1) | (d[:, 1] < 0))
                gone = alive.clone()
                gone[alive] = ~inside
                valid &= ~gone
                alive[alive.clone()] = inside
            disp = torch.where(valid[:, None], dest - src, torch.tensor(oob))
            if pos is None:
                out[b] = disp
            else:
                v = torch.from_numpy(val[b])
                keep = v != 0
                cell = torch.from_numpy(pos[b, :, 1] * Wm + pos[b, :, 0]).long()[keep]
                out[b, cell] = 0.0 + disp[keep] * v[keep][:, None]
    return [o.reshape(B, Hm, Wm, 2) for o in outs]


def _leaving_case():
    """Four samples whose trajectories mostly leave the frame within the
    first steps of each phase: fast motion, a third of it static."""
    rng = np.random.default_rng(5)
    m = (rng.standard_normal((4, H, W, 2)) * 6.0).astype(np.float32)
    m[:, : H // 3, : W // 2] = 0.0
    m[:, 0, 0] = [0.5, -0.5]
    return m, np.array([T, 0, 4, 2], np.int32), np.array([0, T, 5, 3], np.int32)


@pytest.mark.parametrize("case", ["phased", "leaving"])
def test_k7_control_flow_matches_jax_bit_for_bit(case):
    """The exactness argument of K7's design where tests run: leaving a
    phase once invalid, not integrating a source on zero motion, and
    splitting the loop at t_f, give the JAX scan's displacements bit for bit, dense and compact
    (padded rows at (0, 0), a moving pixel there)."""
    m, t_f, t_p = _phased_case() if case == "phased" else _leaving_case()
    want = jax.jit(jax.vmap(lambda mm, a, b: jax_phased(mm, a, b, T)))(m, t_f, t_p)
    got = _k7_mirror(m, t_f, t_p, T)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    pos, val = _moving_sets(m, 512)
    assert (val == 0).any() and (m[:, 0, 0] != 0).all()
    for g, w in zip(_k7_mirror(m, t_f, t_p, T, pos, val), want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if case == "leaving":  # most trajectories leave in each phase
        oob = max(H, W) + 1
        moving = np.any(m != 0, -1)
        for out, b in ((want[0], 0), (want[1], 1)):
            left = np.asarray(out)[b][..., 0][moving[b]] == oob
            assert left.mean() > 0.5


def test_moving_sets_list_each_pixel_once():
    """K7's compact form stores each row's result instead of adding it:
    ``attach_moving_sets`` must give the rows with valid != 0 of a sample
    distinct positions, with the padding at (0, 0) and valid 0, also with
    ``eps`` and a sticky ``state`` whose P exceeds the sample's need."""
    from slrsfs_tpu_torch.cli.train import attach_moving_sets

    rng = np.random.default_rng(9)
    m = (rng.standard_normal((3, 16, 16, 2)) * 0.4).astype(np.float32)
    m[:, :10] = 0.0
    m[1, 12:] = 0.0
    m[2, 0, 0] = [0.3, 0.1]
    state = {"P": 2048}
    for kw in ({}, {"eps": 0.2}, {"state": state}):
        sets = attach_moving_sets({"motions": m}, max_frac=0.9, **kw)
        pos, val = sets["mov_pos"], sets["mov_valid"]
        for b in range(m.shape[0]):
            on = val[b] != 0
            cells = pos[b, on, 1] * 16 + pos[b, on, 0]
            assert len(np.unique(cells)) == on.sum()
            moving = np.any(np.asarray(sets["motions"])[b] != 0, -1)
            assert on.sum() == moving.sum()
            assert (pos[b, ~on] == 0).all() and set(np.unique(val[b])) <= {0.0, 1.0}
        assert (val == 0).any()


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
