"""The port's ops (slrsfs_tpu_torch.ops) against the JAX ops on the same
inputs (the kernels against their plain versions: tests/test_torch_gpu.py).

K1 (compact dual Euler) must match the JAX scan exactly: both round half to
even, negate the gathered vector and compare in the same order. K2 and the
dense splat sum in another order than the XLA scatter, so they are held at
1e-5."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from slrsfs_tpu.ops.euler import euler_integrate_all_dual, euler_integrate_compact_dual
from slrsfs_tpu.ops.splat import softsplat_sum, softsplat_sum_at_quad_dual
from slrsfs_tpu_torch import kernels
from slrsfs_tpu_torch.engine.rollout import prepare_scene_sparse
from slrsfs_tpu_torch.ops import euler as port_euler
from slrsfs_tpu_torch.ops import splat as port_splat

torch.set_num_threads(1)

H, W = 24, 20


def _motion(kind: str, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    m = (rng.standard_normal((H, W, 2)) * 1.3).astype(np.float32)
    if kind == "half_integer":
        # destinations land on x.5, so the gather index is a rounding tie
        m = np.round(m * 2.0) / 2.0
    elif kind == "out_of_bounds":
        m[H - 4:, :, 1] += 6.0  # pushed off the bottom within a few steps
        m[:, :3, 0] -= 4.0  # and off the left edge
    m[: H // 3] = 0.0  # a static band, as scenes have
    return m.astype(np.float32)


@pytest.mark.parametrize("kind", ["continuous", "half_integer", "out_of_bounds"])
def test_euler_compact_dual_matches_jax(kind):
    motion = _motion(kind)
    positions, _ = prepare_scene_sparse(motion, pad_multiple=64)
    n_fwd, n_bwd = 6, 7
    want_f, want_b = euler_integrate_compact_dual(motion, positions, n_fwd, n_bwd)
    got_f, got_b = port_euler.euler_compact_dual_plain(
        torch.from_numpy(motion), torch.from_numpy(positions), n_fwd, n_bwd)
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    if kind == "out_of_bounds":
        assert (got_b.numpy() == max(H, W) + 1).any()

    # the wrapper on CPU tensors is the plain version and launches nothing
    kernels.reset_counts()
    wf, wb = port_euler.euler_compact_dual(
        torch.from_numpy(motion), torch.from_numpy(positions), n_fwd, n_bwd)
    assert torch.equal(wf, got_f) and torch.equal(wb, got_b)
    assert kernels.counts()["euler_compact_dual"] == 0


@pytest.mark.parametrize("kind", ["continuous", "half_integer", "out_of_bounds"])
def test_euler_all_dual_matches_jax(kind):
    motion = _motion(kind, seed=1)
    want_f, want_b = euler_integrate_all_dual(motion, 4, 5)
    got_f, got_b = port_euler.euler_integrate_all_dual(
        torch.from_numpy(motion), 4, 5)
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))


def _splat_inputs(case: str, seed: int = 2):
    rng = np.random.default_rng(seed)
    motion = _motion("continuous", seed)
    positions, valid = prepare_scene_sparse(motion, pad_multiple=64)
    C1 = 9
    ez = np.exp(-rng.uniform(0, 3, (H, W, 1))).astype(np.float32)
    u = np.concatenate([rng.standard_normal((H, W, C1 - 1)).astype(np.float32)
                        * ez, ez], -1)
    static = np.all(motion == 0, axis=-1).astype(np.float32)
    u_static = u * static[..., None]
    u_mov = u[positions[:, 1], positions[:, 0]] * valid[:, None]
    disp_f, disp_b = euler_integrate_compact_dual(motion, positions, 5, 6)
    da, db = np.array(disp_f[3]), np.array(disp_b[3])
    if case == "sentinel_integer_border":
        da[0::3] = max(H, W) + 1  # OOB sentinel: every corner dropped
        da[1::3] = [3.0, -2.0]  # exact integer shift: one corner, weight 1
        da[2::3] = [-0.75, -5.5]  # fractional landings across the border
    return u_mov, positions, valid, da, db, u_static


def _jax_splat_normalize(u_mov, positions, da, db, w_a, w_b, u_static):
    g = softsplat_sum_at_quad_dual(u_mov, positions, da, db, w_a, w_b, H, W)
    g = np.asarray(g + u_static, np.float32)
    return g[..., :-1] / np.maximum(g[..., -1:], 1e-8)


@pytest.mark.parametrize("case", ["trajectory", "sentinel_integer_border"])
def test_splat_dual_normalize_matches_jax(case):
    u_mov, positions, valid, da, db, u_static = _splat_inputs(case)
    a = np.float32(1.0) - np.float32(2) / np.float32(6)
    b = np.float32(1.0) - a
    want = _jax_splat_normalize(u_mov, positions, da, db, a, b, u_static)
    got = port_splat.splat_dual_normalize_plain(
        *map(torch.from_numpy, (u_mov, positions, valid, da, db)), float(a),
        float(b), torch.from_numpy(u_static), torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # cells no moving tap reaches keep the exact zeros of u_static, which the
    # decoder reads as holes
    np.testing.assert_array_equal(got == 0, want == 0)

    out = torch.empty((H, W, u_mov.shape[1] - 1), dtype=torch.bfloat16)
    port_splat.splat_dual_normalize(
        *map(torch.from_numpy, (u_mov, positions, valid, da, db)), float(a),
        float(b), torch.from_numpy(u_static), out=out)
    # bf16 output: the f32 result rounded once (rel. spacing 2^-8)
    np.testing.assert_allclose(out.float().numpy(), want, rtol=2 ** -8,
                               atol=1e-5)


def test_softsplat_sum_matches_jax():
    rng = np.random.default_rng(3)
    inp = rng.standard_normal((2, 12, 10, 5)).astype(np.float32)
    flow = (rng.standard_normal((2, 12, 10, 2)) * 2.0).astype(np.float32)
    flow[1, :4] = [1.0, -1.0]  # integer shifts, partly off the grid
    want = np.asarray(softsplat_sum(jnp.asarray(inp), jnp.asarray(flow)))
    got = port_splat.softsplat_sum(torch.from_numpy(inp), torch.from_numpy(flow))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bad", ["dtype", "shape", "device", "layout"])
def test_wrappers_reject_bad_inputs(bad):
    motion = torch.zeros((8, 8, 2))
    positions = torch.zeros((16, 2), dtype=torch.int32)
    if bad == "dtype":
        motion = motion.double()
    elif bad == "shape":
        positions = positions[:, :1]
    elif bad == "layout":  # the kernels read dense rows
        motion = motion.transpose(0, 1)
    else:  # neither CPU nor CUDA: no silent path
        motion, positions = motion.to("meta"), positions.to("meta")
    with pytest.raises((TypeError, ValueError)):
        port_euler.euler_compact_dual(motion, positions, 2, 2)

    u_static = torch.zeros((8, 8, 5))
    if bad == "layout":
        u_static = u_static.transpose(0, 1)
    u_mov = torch.zeros((16, 5))
    out = torch.empty((8, 8, 4), dtype=torch.float16 if bad == "dtype"
                      else torch.float32)
    disp = torch.zeros((16, 2))
    valid = torch.ones(16)
    args = [u_mov, positions, valid, disp, disp, 0.5, 0.5, u_static]
    if bad == "device":
        args = [a.to("meta") if torch.is_tensor(a) else a for a in args]
        out = out.to("meta")
    with pytest.raises((TypeError, ValueError)):
        port_splat.splat_dual_normalize(*args, out=out)


def test_kernel_libraries_are_keyed_by_source():
    """Each library's name carries its source's name and a hash of the
    source and flags, so a changed source never loads a stale build; entry
    points of one source share its library."""
    for k in kernels.KERNELS:
        lib = k._lib_path()
        assert lib.startswith(kernels.BUILD_DIR)
        stem = os.path.splitext(os.path.basename(k.source))[0]
        assert lib.endswith(".so") and os.path.basename(lib).startswith(stem + "-")
    assert kernels.SPLAT._lib_path() == kernels.SPLAT_SLR._lib_path()
    assert len({k.name for k in kernels.KERNELS}) == len(kernels.KERNELS)
    assert "sm_90a" in " ".join(kernels.NVCC_FLAGS)
