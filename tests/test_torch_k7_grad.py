"""K7's gradient on the CPU: the motion's gradient through the phased
training integration (``ops/euler.py:euler_integrate_phased``).

* The plain version's autograd against ``jax.grad`` of the JAX
  ``euler_integrate_phased`` vmapped over the batch (as ``train_integrate``
  calls it), on samples with t_p = 0, t_f = 0, t_f + t_p = T and a middle
  case, rows that leave the frame before their latch (bottom band), static
  rows (a band of zero motion) and rows that come to rest on them: within
  1e-5 of the gradient's largest magnitude (each motion pixel's gradient
  is a sum of ±1-weighted cotangents, added in another order).
* A host mirror of the backward kernel's walk (``csrc/euler_phased.cu:
  euler_phased_bwd``: rows whose latched output is the sentinel skipped,
  a static source's steps folded into one add of steps · sign · cot, every
  other valid row re-walked with the forward's rounding, adding
  sign · cot at each step's cell) against the plain version's autograd,
  within the same bound, with one cotangent given and with both: the
  kernel's rule, checked where no card is needed.
* The CPU wrapper keeps the gradient (the plain version's, bit for bit),
  and the backward kernel's wrapper refuses CPU tensors."""

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
