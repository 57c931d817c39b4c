"""The motion gradient through the port's Euler integrators.

* ``_refuse_motion_grad``, which every card branch of K1, K4 and K7 calls
  before it allocates or launches: it raises for a motion that requires
  grad under grad mode, and passes under ``torch.no_grad()`` or for a
  motion that does not require grad. It does not look at the device, so it
  is tested here on CPU tensors.
* The CPU wrappers still carry the gradient: ``torch.autograd.grad``
  through ``euler_integrate_phased`` (the plain version on the CPU) against
  the same through ``euler_integrate_phased_plain``, and against
  ``jax.grad`` of the JAX ``euler_integrate_phased`` (vmapped as
  ``train_integrate`` does) on the same numpy inputs: the wrapper equals
  the plain version bit for bit, and JAX within 1e-6 (each motion pixel's
  gradient is a sum of ±1-weighted cotangents, added in another order)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from slrsfs_tpu.ops.euler import euler_integrate_phased as jax_phased
from slrsfs_tpu_torch.ops import euler as port_euler

torch.set_num_threads(1)

H, W, T = 12, 14, 7


@pytest.mark.parametrize("case", ["grad", "no_grad", "no_requires_grad"])
def test_refuse_motion_grad(case):
    m = torch.zeros((H, W, 2), requires_grad=case != "no_requires_grad")
    if case == "grad":
        with pytest.raises(RuntimeError, match="no backward"):
            port_euler._refuse_motion_grad(m)
    elif case == "no_grad":
        with torch.no_grad():
            port_euler._refuse_motion_grad(m)
    else:
        port_euler._refuse_motion_grad(m)


def _case():
    """Three samples (t_p = 0, t_f + t_p = T, a middle case), bottom rows
    leaving the frame, a static band, and a cotangent per output."""
    rng = np.random.default_rng(3)
    m = (rng.standard_normal((3, H, W, 2)) * 1.2).astype(np.float32)
    m[:, H - 3:, :, 1] += 3.0
    m[:, 2:5] = 0.0
    t_f = np.array([4, 3, 2], np.int32)
    t_p = np.array([0, 4, 3], np.int32)
    g_f = rng.standard_normal((3, H, W, 2)).astype(np.float32)
    g_p = rng.standard_normal((3, H, W, 2)).astype(np.float32)
    return m, t_f, t_p, g_f, g_p


def _torch_grad(fn, m, t_f, t_p, g_f, g_p):
    motion = torch.from_numpy(m).requires_grad_(True)
    out_f, out_p = fn(motion, torch.from_numpy(t_f), torch.from_numpy(t_p), T)
    loss = (out_f * torch.from_numpy(g_f)).sum() + (out_p * torch.from_numpy(g_p)).sum()
    (grad,) = torch.autograd.grad(loss, motion)
    return grad.numpy()


def test_cpu_phased_wrapper_keeps_the_motion_gradient():
    m, t_f, t_p, g_f, g_p = _case()
    got = _torch_grad(port_euler.euler_integrate_phased, m, t_f, t_p, g_f, g_p)
    plain = _torch_grad(port_euler.euler_integrate_phased_plain, m, t_f, t_p, g_f, g_p)
    np.testing.assert_array_equal(got, plain)
    assert np.abs(got).max() > 0

    def loss(mm):
        out_f, out_p = jax.vmap(lambda a, b, c: jax_phased(a, b, c, T))(mm, t_f, t_p)
        return jnp.sum(out_f * g_f) + jnp.sum(out_p * g_p)

    want = np.asarray(jax.jit(jax.grad(loss))(jnp.asarray(m)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
