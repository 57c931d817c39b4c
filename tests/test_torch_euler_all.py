"""K4's plain versions (slrsfs_tpu_torch.ops.euler, the dense and
single-direction integrators) against the JAX ``euler_integrate_all``,
``euler_integrate``, ``euler_integrate_compact`` and
``euler_integrate_all_dual`` on the same inputs. Both round half to even
and compare in the same order, so every output must be equal: continuous
motion, half-integer landings (rounding ties), trajectories that leave the
frame (the ``max(H, W) + 1`` sentinel) and ``n_steps = 0``. On CPU tensors
the wrappers are the plain versions and launch nothing."""

import numpy as np
import pytest
import torch

from slrsfs_tpu.ops import euler as jax_euler
from slrsfs_tpu_torch import kernels
from slrsfs_tpu_torch.engine.rollout import prepare_scene_sparse
from slrsfs_tpu_torch.ops import euler as port_euler

torch.set_num_threads(1)

H, W = 18, 22
KINDS = ["continuous", "half_integer", "out_of_bounds"]


def _motion(kind: str, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    m = (rng.standard_normal((H, W, 2)) * 1.3).astype(np.float32)
    if kind == "half_integer":
        m = np.round(m * 2.0) / 2.0  # destinations land on x.5: ties
    elif kind == "out_of_bounds":
        m[H - 4:, :, 1] += 6.0
        m[:, :3, 0] -= 4.0
    m[: H // 3] = 0.0
    return m.astype(np.float32)


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _no_launch(fn, *args):
    kernels.reset_counts()
    out = fn(*args)
    assert kernels.counts()[kernels.EULER_ALL.name] == 0
    return out


@pytest.mark.parametrize("n_steps", [0, 1, 7])
@pytest.mark.parametrize("kind", KINDS)
def test_euler_integrate_all_matches_jax(kind, n_steps):
    m = _motion(kind, 0)
    want_d, want_v = jax_euler.euler_integrate_all(m, n_steps)
    got_d, got_v = port_euler.euler_integrate_all_plain(torch.from_numpy(m), n_steps)
    _eq(got_d, want_d)
    _eq(got_v, want_v)
    assert got_d.shape == (n_steps + 1, H, W, 2) and got_v.dtype == torch.float32
    if kind == "out_of_bounds" and n_steps == 7:
        assert (got_d.numpy() == max(H, W) + 1).any() and (got_v.numpy() == 0).any()
    wd, wv = _no_launch(port_euler.euler_integrate_all, torch.from_numpy(m), n_steps)
    assert torch.equal(wd, got_d) and torch.equal(wv, got_v)


@pytest.mark.parametrize("n_steps", [0, 5])
@pytest.mark.parametrize("kind", KINDS)
def test_euler_integrate_matches_jax(kind, n_steps):
    m = _motion(kind, 1)
    want_d, want_v = jax_euler.euler_integrate(m, n_steps)
    got_d, got_v = port_euler.euler_integrate_plain(torch.from_numpy(m), n_steps)
    _eq(got_d, want_d)
    _eq(got_v, want_v)
    wd, wv = _no_launch(port_euler.euler_integrate, torch.from_numpy(m), n_steps)
    assert torch.equal(wd, got_d) and torch.equal(wv, got_v)


@pytest.mark.parametrize("n_steps", [0, 6])
@pytest.mark.parametrize("kind", KINDS)
def test_euler_integrate_compact_matches_jax(kind, n_steps):
    m = _motion(kind, 2)
    pos, _ = prepare_scene_sparse(m, pad_multiple=64)  # padded rows at (0, 0)
    want_d, want_v = jax_euler.euler_integrate_compact(m, pos, n_steps)
    got_d, got_v = port_euler.euler_integrate_compact_plain(
        torch.from_numpy(m), torch.from_numpy(pos), n_steps)
    _eq(got_d, want_d)
    _eq(got_v, want_v)
    wd, wv = _no_launch(port_euler.euler_integrate_compact, torch.from_numpy(m),
                        torch.from_numpy(pos), n_steps)
    assert torch.equal(wd, got_d) and torch.equal(wv, got_v)


@pytest.mark.parametrize("steps", [(0, 0), (0, 3), (5, 6)])
@pytest.mark.parametrize("kind", KINDS)
def test_euler_integrate_all_dual_matches_jax(kind, steps):
    m = _motion(kind, 3)
    want_f, want_b = jax_euler.euler_integrate_all_dual(m, *steps)
    got_f, got_b = port_euler.euler_integrate_all_dual_plain(torch.from_numpy(m),
                                                             *steps)
    _eq(got_f, want_f)
    _eq(got_b, want_b)
    wf, wb = _no_launch(port_euler.euler_integrate_all_dual, torch.from_numpy(m),
                        *steps)
    assert torch.equal(wf, got_f) and torch.equal(wb, got_b)


def test_dense_forms_agree_with_each_other():
    """The dense dual form's +M half is the single-direction form, its -M
    half the single-direction form of -M, and the compact form over every
    pixel is the dense form."""
    m = torch.from_numpy(_motion("out_of_bounds", 4))
    f, b = port_euler.euler_integrate_all_dual_plain(m, 6, 4)
    assert torch.equal(f, port_euler.euler_integrate_all_plain(m, 6)[0])
    assert torch.equal(b, port_euler.euler_integrate_all_plain(-m, 4)[0])
    grid = port_euler._grid(H, W, m.device)
    d, v = port_euler.euler_integrate_compact_plain(m, grid, 6)
    dd, vv = port_euler.euler_integrate_all_plain(m, 6)
    assert torch.equal(d.reshape(dd.shape), dd) and torch.equal(v.reshape(vv.shape), vv)


@pytest.mark.parametrize("bad", ["dtype", "shape", "steps", "layout", "device"])
def test_k4_wrappers_refuse_what_the_kernel_does_not_take(bad):
    m = torch.zeros((8, 8, 2))
    steps = 2
    if bad == "dtype":
        m = m.double()
    elif bad == "shape":
        m = m[..., :1]
    elif bad == "steps":
        steps = -1
    elif bad == "layout":
        m = m.transpose(0, 1)
    else:
        m = m.to("meta")
    for fn in (port_euler.euler_integrate_all, port_euler.euler_integrate):
        with pytest.raises((TypeError, ValueError)):
            fn(m, steps)
    with pytest.raises((TypeError, ValueError)):
        port_euler.euler_integrate_all_dual(m, steps, steps)
