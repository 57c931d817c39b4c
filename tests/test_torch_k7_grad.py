"""K7's gradient on the CPU: the motion's gradient through the phased
training integration (``ops/euler.py:euler_integrate_phased``).

* The plain version's autograd against ``jax.grad`` of the JAX
  ``euler_integrate_phased`` vmapped over the batch (as ``train_integrate``
  calls it), on samples with t_p = 0, t_f = 0, t_f + t_p = T and a middle
  case, rows that leave the frame before their latch (bottom band), static
  rows (a band of zero motion) and rows that come to rest on them: within
  1e-5 of the gradient's largest magnitude (each motion pixel's gradient
  is a sum of ±1-weighted cotangents, added in another order).
* A host mirror of the backward's walk (``csrc/euler_phased.cu:
  euler_phased_bwd``: rows whose latched output is the sentinel skipped,
  a static source's steps folded into one add of steps · sign · cot, every
  other valid row re-walked with the forward's rounding, adding
  sign · cot at each step's cell, one add a step as the first design
  issued them) against the plain version's autograd, within the same
  bound, with one cotangent given and with both.
* The CPU wrapper keeps the gradient (the plain version's, bit for bit),
  and the backward kernel's wrapper refuses CPU tensors.
* A direct host mirror of the kernel's block rule (a block's tile of
  sources, its shared-memory window summed in the block's fixed point,
  runs of steps on one cell summed before they are added, runs outside
  the window added to the gradient, the window's non-zero cells added at
  the end), row by row in float32,
  against the plain autograd and ``jax.grad`` within 1e-5 of the largest
  magnitude, on cases that each show what they name (one run a row,
  window misses, partial tiles, the count rules, a static band, rows
  leaving the frame); its counts against ``phased_bwd_window_counts``,
  the vectorised count that ``chip_smoke.py`` prints."""

import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from slrsfs_tpu.ops.euler import euler_integrate_phased as jax_phased
from slrsfs_tpu_torch.ops import euler as port_euler

torch.set_num_threads(1)

H, W, T = 12, 14, 7
GRAD_TOL = 1e-5  # of the gradient's largest magnitude


def _case(seed: int = 3):
    """Five samples (t_p = 0, t_f = 0, t_f + t_p = T, two middle cases),
    bottom rows leaving the frame, a static band, cotangents."""
    rng = np.random.default_rng(seed)
    B = 5
    m = (rng.standard_normal((B, H, W, 2)) * 1.2).astype(np.float32)
    m[:, H - 3:, :, 1] += 3.0
    m[:, 2:5] = 0.0
    t_f = np.array([4, 0, 3, 2, 6], np.int32)
    t_p = np.array([0, 5, 4, 3, 1], np.int32)
    g_f = rng.standard_normal((B, H, W, 2)).astype(np.float32)
    g_p = rng.standard_normal((B, H, W, 2)).astype(np.float32)
    return m, t_f, t_p, g_f, g_p


def _torch_grad(fn, m, t_f, t_p, g_f, g_p):
    motion = torch.from_numpy(m).requires_grad_(True)
    out_f, out_p = fn(motion, torch.from_numpy(t_f), torch.from_numpy(t_p), T)
    loss = (out_f * torch.from_numpy(g_f)).sum() + (out_p * torch.from_numpy(g_p)).sum()
    (grad,) = torch.autograd.grad(loss, motion)
    return grad.numpy()


def _close(got, want, what):
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_TOL * scale, err_msg=what)


def test_case_covers_the_traps():
    """The samples hold every phase rule, leaving and static rows."""
    m, t_f, t_p, _, _ = _case()
    assert {0} <= set(t_f) and {0} <= set(t_p) and T in set(t_f + t_p)
    out_f, out_p = port_euler.euler_integrate_phased_plain(
        torch.from_numpy(m), torch.from_numpy(t_f), torch.from_numpy(t_p), T)
    oob = max(H, W) + 1
    assert int((out_p[..., 0] == oob).sum()) > 0 and int((out_f[..., 0] == oob).sum()) > 0
    assert int((m == 0).all(-1).sum()) >= 5 * 3 * W


def test_plain_gradient_matches_jax():
    m, t_f, t_p, g_f, g_p = _case()
    got = _torch_grad(port_euler.euler_integrate_phased_plain, m, t_f, t_p, g_f, g_p)

    def loss(mm):
        out_f, out_p = jax.vmap(lambda a, b, c: jax_phased(a, b, c, T))(mm, t_f, t_p)
        return jnp.sum(out_f * g_f) + jnp.sum(out_p * g_p)

    want = np.asarray(jax.jit(jax.grad(loss))(jnp.asarray(m)))
    _close(got, want, "plain autograd vs jax.grad")
    # the static band's sources are read at every step: not zero there
    assert np.abs(got[:, 2:5]).max() > 0


def _bwd_mirror(m, t_f, t_p, out_f, out_p, cot_f, cot_p):
    """The backward kernel's walk on the host, row-vectorised."""
    B = m.shape[0]
    oob = float(max(H, W) + 1)
    ys, xs = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
    coord = torch.stack([xs, ys], -1).reshape(-1, 2).float()
    src = torch.arange(H * W)
    grad = torch.zeros((B, H * W, 2))
    for b in range(B):
        mb = m[b].reshape(-1, 2)
        rest = (mb == 0).all(-1)
        tf, tp = int(t_f[b]), int(t_p[b])
        phases = ((1.0, tf, 1 <= tf <= T, out_f, cot_f),
                  (-1.0, tf + tp - max(tf, 0), tp > 0 and 1 <= tf + tp <= T, out_p, cot_p))
        for sign, steps, latched, out, cot in phases:
            if cot is None or not latched:
                continue
            valid = out[b].reshape(-1, 2)[:, 0] != oob
            c = cot[b].reshape(-1, 2)
            r = valid & rest
            grad[b].index_add_(0, src[r], c[r] * (steps * sign))
            mv = valid & ~rest
            d, cm = coord[mv].clone(), c[mv] * sign
            for _ in range(steps):
                ix = torch.round(d[:, 0]).long().clamp(0, W - 1)
                iy = torch.round(d[:, 1]).long().clamp(0, H - 1)
                at = iy * W + ix
                grad[b].index_add_(0, at, cm)
                d = d + mb[at] * sign
    return grad.reshape(m.shape)


@pytest.mark.parametrize("which", ["both", "forward only", "backward only"])
def test_backward_kernel_rule_matches_plain_autograd(which):
    m, t_f, t_p, g_f, g_p = _case(5)
    if which == "forward only":
        g_p = np.zeros_like(g_p)
    if which == "backward only":
        g_f = np.zeros_like(g_f)
    want = _torch_grad(port_euler.euler_integrate_phased_plain, m, t_f, t_p, g_f, g_p)
    mt = torch.from_numpy(m)
    out_f, out_p = port_euler.euler_integrate_phased_plain(
        mt, torch.from_numpy(t_f), torch.from_numpy(t_p), T)
    got = _bwd_mirror(mt, t_f, t_p, out_f, out_p,
                      None if which == "backward only" else torch.from_numpy(g_f),
                      None if which == "forward only" else torch.from_numpy(g_p))
    _close(got.numpy(), want, which)


def test_cpu_wrapper_keeps_the_gradient_and_kernel_refuses_cpu():
    m, t_f, t_p, g_f, g_p = _case(7)
    got = _torch_grad(port_euler.euler_integrate_phased, m, t_f, t_p, g_f, g_p)
    plain = _torch_grad(port_euler.euler_integrate_phased_plain, m, t_f, t_p, g_f, g_p)
    np.testing.assert_array_equal(got, plain)
    mt = torch.from_numpy(m)
    tf, tp = torch.from_numpy(t_f), torch.from_numpy(t_p)
    out_f, out_p = port_euler.euler_integrate_phased_plain(mt, tf, tp, T)
    with pytest.raises(ValueError, match="runs on the card"):
        port_euler.euler_phased_bwd(mt, tf, tp, out_f, out_p, out_f, None, T)


def _window_mirror(m, t_f, t_p, cot_f, cot_p, T, tile, margin):
    """The backward kernel's block rule, row by row in float32: runs summed
    in registers, each added to its window cell in the block's fixed point
    (coarse and fine int32 sums, scaled from the block's bound) or to the
    gradient outside it, then each non-zero window cell in the frame added
    to the gradient. Returns the gradient and the counts
    ``phased_bwd_window_counts`` reports, counted directly (the hit cells as
    sets); asserts that no int32 sum left its range."""
    f32 = np.float32
    B, Hm, Wm, _ = m.shape
    out_f, out_p = (o.numpy() for o in port_euler.euler_integrate_phased_plain(
        torch.from_numpy(m), torch.from_numpy(t_f), torch.from_numpy(t_p), T))
    oob = f32(max(Hm, Wm) + 1)
    win = tile + 2 * margin
    grad = np.zeros(m.shape, np.float32)
    n = dict(reductions=0, repeats=0, hits=0, misses=0, touched=0)
    for b in range(B):
        tf, tp = int(t_f[b]), int(t_p[b])
        n_f, n_p = tf, tf + tp - max(tf, 0)
        phases = ((1, n_f, cot_f, out_f, 1 <= tf <= T),
                  (-1, n_p, cot_p, out_p, tp > 0 and 1 <= tf + tp <= T))
        for ty0 in range(0, Hm, tile):
            for tx0 in range(0, Wm, tile):
                rows = [(x, y) for y in range(ty0, min(ty0 + tile, Hm))
                        for x in range(tx0, min(tx0 + tile, Wm))]
                top = f32(0.0)
                for x, y in rows:
                    for _, _, cot, out, latched in phases:
                        if latched and out[b, y, x, 0] != oob:
                            top = max(top, np.abs(cot[b, y, x]).max())
                bound = f32(tile * tile) * f32(n_f + n_p) * top
                assert np.isfinite(bound) and (bound == 0 or bound >= 1e-30)
                s1 = f32(2.0 ** (30 - np.frexp(bound)[1])) if bound > 0 else f32(1.0)
                fk = f32(2.0 ** (31 - np.frexp(f32(tile * tile * (n_f + n_p + 1)))[1]))
                coarse = np.zeros((win, win, 2), np.int64)
                fine = np.zeros((win, win, 2), np.int64)
                wx0, wy0 = tx0 - margin, ty0 - margin
                reached = set()

                def add(cell, s):
                    lx, ly = cell[0] - wx0, cell[1] - wy0
                    if 0 <= lx < win and 0 <= ly < win:
                        v = s * s1
                        c = np.rint(v)
                        coarse[ly, lx] += c.astype(np.int64)
                        fine[ly, lx] += np.rint((v - c) * fk).astype(np.int64)
                        reached.add((lx, ly))
                        n["hits"] += 1
                    else:
                        grad[b, cell[1], cell[0]] += s
                        n["misses"] += 1

                for x, y in rows:
                    rest = not m[b, y, x].any()
                    run, s, started = (x, y), np.zeros(2, np.float32), False
                    for sign, steps, cot, out, latched in phases:
                        if not latched or out[b, y, x, 0] == oob:
                            continue
                        started = True
                        if rest:
                            s += f32(steps * sign) * cot[b, y, x]
                            n["reductions"] += 1
                            continue
                        c = f32(sign) * cot[b, y, x]
                        d = np.array([x, y], np.float32)
                        for k in range(steps):
                            at = (int(np.clip(np.round(d[0]), 0, Wm - 1)),
                                  int(np.clip(np.round(d[1]), 0, Hm - 1)))
                            n["reductions"] += 1
                            if at != run:
                                add(run, s)
                                run, s = at, np.zeros(2, np.float32)
                            elif k:
                                n["repeats"] += 1
                            s += c
                            d = d + m[b, at[1], at[0]] * f32(sign)
                    if started and s.any():
                        add(run, s)
                n["touched"] += len(reached)
                assert np.abs(coarse).max() < 2 ** 31 and np.abs(fine).max() < 2 ** 31
                value = ((coarse.astype(np.float32) + fine.astype(np.float32) * (f32(1) / fk))
                         * (f32(1) / s1))
                for ly in range(win):
                    for lx in range(win):
                        gx, gy = wx0 + lx, wy0 + ly
                        if value[ly, lx].any() and 0 <= gx < Wm and 0 <= gy < Hm:
                            grad[b, gy, gx] += value[ly, lx]
    n["runs"] = n["hits"] + n["misses"]
    return grad, n


TILE, MARGIN = port_euler.PHASED_BWD_TILE, port_euler.PHASED_BWD_MARGIN
WINDOW_CASES = ["one run a row", "drift leaves the window", "partial tiles 37x53",
                "count rules", "static band", "rows leave the frame"]


def _window_case(name: str):
    """(motion, t_f, t_p, T, cot_f, cot_p) of a case, from a numpy seed."""
    rng = np.random.default_rng(40 + WINDOW_CASES.index(name))
    T, B, Hc, Wc = 7, 3, 37, 53
    t_f = np.array([4, 0, 3], np.int32)
    t_p = np.array([3, 7, 2], np.int32)
    if name == "one run a row":
        m = rng.standard_normal((B, Hc, Wc, 2)).astype(np.float32) * 0.01
    elif name == "drift leaves the window":
        # ~3 px a step to the right: sources in a tile's left half end past
        # its window's right edge, inside the 100-pixel-wide frame
        T, Hc, Wc = 14, 34, 100
        m = rng.standard_normal((2, Hc, Wc, 2)).astype(np.float32) * 0.1
        m[..., 0] += 3.0
        t_f, t_p = np.array([14, 12], np.int32), np.array([0, 2], np.int32)
    elif name == "count rules":
        B = 5
        m = (rng.standard_normal((B, Hc, Wc, 2)) * 1.2).astype(np.float32)
        t_f = np.array([7, 0, 3, 2, 6], np.int32)
        t_p = np.array([0, 7, 4, 3, 1], np.int32)
    else:
        m = (rng.standard_normal((B, Hc, Wc, 2)) * 1.2).astype(np.float32)
        if name == "static band":
            m[:, 3:11] = 0.0
        if name == "rows leave the frame":
            m[:, Hc - 6:, :, 1] += 3.0
    cot_f = rng.standard_normal(m.shape).astype(np.float32)
    cot_p = rng.standard_normal(m.shape).astype(np.float32)
    return m, t_f, t_p, T, cot_f, cot_p


def _shows_what_it_names(name, m, t_f, t_p, T, n, grad):
    oob = max(m.shape[1], m.shape[2]) + 1
    out_f, out_p = port_euler.euler_integrate_phased_plain(
        torch.from_numpy(m), torch.from_numpy(t_f), torch.from_numpy(t_p), T)
    sentinels = int((out_f[..., 0] == oob).sum()) + int((out_p[..., 0] == oob).sum())
    if name == "one run a row":
        # every row still latched in the frame (sources on the border step
        # out of it) is one run
        lat_f = torch.from_numpy((t_f >= 1) & (t_f <= T))[:, None, None]
        lat_p = torch.from_numpy((t_p > 0) & (t_f + t_p >= 1) & (t_f + t_p <= T))[:, None, None]
        rows = ((lat_f & (out_f[..., 0] != oob)) | (lat_p & (out_p[..., 0] != oob))).sum()
        assert n["runs"] == int(rows) > 0.8 * m[..., 0].size
        assert n["reductions"] > n["runs"] * T / 2
    elif name == "drift leaves the window":
        assert n["misses"] > 0 and n["hits"] > 0
    elif name == "partial tiles 37x53":
        assert m.shape[1] % TILE and m.shape[2] % TILE and n["touched"] > 0
    elif name == "count rules":
        assert 0 in t_f and 0 in t_p and T in t_f + t_p
    elif name == "static band":
        static = ~m.any(-1)
        assert static.sum() >= 8 * m.shape[2] and np.abs(grad[static]).max() > 0
    else:
        assert sentinels > 0


@pytest.mark.parametrize("name", WINDOW_CASES)
def test_window_rule_matches_plain_autograd_and_jax(name):
    m, t_f, t_p, T, cot_f, cot_p = _window_case(name)
    got, n = _window_mirror(m, t_f, t_p, cot_f, cot_p, T, TILE, MARGIN)
    _shows_what_it_names(name, m, t_f, t_p, T, n, got)
    motion = torch.from_numpy(m).requires_grad_(True)
    out_f, out_p = port_euler.euler_integrate_phased_plain(
        motion, torch.from_numpy(t_f), torch.from_numpy(t_p), T)
    loss = (out_f * torch.from_numpy(cot_f)).sum() + (out_p * torch.from_numpy(cot_p)).sum()
    _close(got, torch.autograd.grad(loss, motion)[0].numpy(), f"{name}: vs plain autograd")

    def jax_loss(mm):
        a, b = jax.vmap(lambda u, v, w: jax_phased(u, v, w, T))(mm, t_f, t_p)
        return jnp.sum(a * cot_f) + jnp.sum(b * cot_p)

    _close(got, np.asarray(jax.jit(jax.grad(jax_loss))(jnp.asarray(m))),
           f"{name}: vs jax.grad")


@pytest.mark.parametrize("name", WINDOW_CASES)
def test_window_counts_match_a_direct_count(name):
    m, t_f, t_p, T, cot_f, cot_p = _window_case(name)
    _, want = _window_mirror(m, t_f, t_p, cot_f, cot_p, T, TILE, MARGIN)
    got = port_euler.phased_bwd_window_counts(
        torch.from_numpy(m), torch.from_numpy(t_f), torch.from_numpy(t_p), T)
    assert got == want
    assert want["touched"] <= want["hits"] and want["runs"] <= want["reductions"]


def test_window_counts_at_a_small_tile():
    """A tile and margin other than the kernel's (8 and 3: many windows,
    many misses) count alike, and the rule holds the gradient there too."""
    m, t_f, t_p, T, cot_f, cot_p = _window_case("count rules")
    grad, want = _window_mirror(m, t_f, t_p, cot_f, cot_p, T, 8, 3)
    got = port_euler.phased_bwd_window_counts(
        torch.from_numpy(m), torch.from_numpy(t_f), torch.from_numpy(t_p), T, tile=8,
        margin=3)
    assert got == want and want["misses"] > 0
    plain = _torch_grad(port_euler.euler_integrate_phased_plain, m, t_f, t_p, cot_f, cot_p)
    _close(grad, plain, "tile 8, margin 3")


def test_window_geometry_is_the_kernels():
    """``PHASED_BWD_TILE`` and ``PHASED_BWD_MARGIN`` are the source's
    ``kBwdTile`` and ``kBwdMargin``."""
    path = os.path.join(os.path.dirname(port_euler.__file__), os.pardir, "csrc",
                        "euler_phased.cu")
    with open(path) as f:
        src = f.read()
    for name, value in (("kBwdTile", TILE), ("kBwdMargin", MARGIN)):
        assert re.search(rf"constexpr int {name} = (\d+);", src).group(1) == str(value)
