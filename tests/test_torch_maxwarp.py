"""The port's maximum-warp norms (K5 sparse, K6 dense; slrsfs_tpu_torch.ops.
maxwarp) against the JAX ``maximum_warp_norm_sparse`` /
``maximum_warp_norm_splat`` on the same inputs.

Max is exact and order-free, so both plain versions must match the JAX ops
exactly, on trajectory displacements and on rows that carry the Euler OOB
sentinel, exact integer shifts, border landings and padding (valid = 0).
The cases include those a kernel's persistent grid must cover: every row
padded, every pixel moving (no static stencil) and a non-square grid. The
kernels are held against these plain versions on a card
(tests/test_torch_gpu.py)."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from slrsfs_tpu.ops.euler import euler_integrate_all_dual, euler_integrate_compact_dual
from slrsfs_tpu.ops.splat import maximum_warp_norm_sparse as jax_sparse
from slrsfs_tpu.ops.splat import maximum_warp_norm_splat as jax_dense
from slrsfs_tpu_torch import kernels
from slrsfs_tpu_torch.engine.rollout import prepare_scene_sparse
from slrsfs_tpu_torch.ops import maxwarp

torch.set_num_threads(1)

H, W = 24, 20


def _motion(seed: int, h: int = H, w: int = W) -> np.ndarray:
    rng = np.random.default_rng(seed)
    m = (rng.standard_normal((h, w, 2)) * 1.3).astype(np.float32)
    m[h - 4:, :, 1] += 6.0  # leaves the bottom within a few steps
    m[: h // 3] = 0.0  # a static band
    m[:, : w // 4] = 0.0
    return m


def _special(d: np.ndarray) -> np.ndarray:
    """Rows with the OOB sentinel, exact integer shifts and fractional
    landings across the border."""
    d = np.array(d)
    d[0::4] = max(H, W) + 1
    d[1::4] = [3.0, -2.0]
    d[2::4] = [-0.75, -5.5]
    return d


def _z(seed: int, h: int = H, w: int = W) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((h, w)) * 4.0).astype(np.float32)


@pytest.mark.parametrize("case", ["t1", "t5", "sentinel_integer_border",
                                  "quarter_pixel", "all_rows_padded",
                                  "every_pixel_moving"])
def test_sparse_matches_jax(case):
    m = _motion(0)
    if case == "every_pixel_moving":
        m = m + np.float32(0.25)
    positions, valid = prepare_scene_sparse(m, pad_multiple=64)
    assert (valid == 0).any()  # padded rows present
    if case == "all_rows_padded":
        valid = np.zeros_like(valid)
    disp_f, _ = euler_integrate_compact_dual(m, positions, 6, 6)
    d = np.array(disp_f[1 if case == "t1" else 5])
    if case == "sentinel_integer_border":
        d = _special(d)
    elif case == "quarter_pixel":
        d = np.round(d * 4.0) / 4.0
    z = _z(1)
    static = np.all(m == 0, axis=-1).astype(np.float32)
    assert static.any() == (case != "every_pixel_moving")
    z_mov = z[positions[:, 1], positions[:, 0]]
    want_d, want_m = jax_sparse(jnp.asarray(z), jnp.asarray(static),
                                jnp.asarray(z_mov), jnp.asarray(positions),
                                jnp.asarray(valid), jnp.asarray(d), H, W)
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in
            (z, static, z_mov, positions, valid, d)]
    got_d, got_m = maxwarp.maximum_warp_norm_sparse_plain(*args)
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))

    # the wrapper on CPU tensors is the plain version and launches nothing
    kernels.reset_counts()
    wd, wm = maxwarp.maximum_warp_norm_sparse(*args)
    assert torch.equal(wd, got_d) and torch.equal(wm, got_m)
    assert kernels.counts()["maximum_warp_norm_sparse"] == 0


@pytest.mark.parametrize("case", ["trajectory", "sentinel_integer_border",
                                  "batch2_channels2", "non_square_40x72"])
def test_dense_matches_jax(case):
    h, w = (40, 72) if case == "non_square_40x72" else (H, W)
    m = _motion(2, h, w)
    disp_f, _ = euler_integrate_all_dual(m, 5, 5)
    flow = np.array(disp_f[4])[None]
    z = _z(3, h, w)[None, ..., None]
    if case == "sentinel_integer_border":
        flow = _special(flow.reshape(-1, 2)).reshape(flow.shape)
    elif case == "batch2_channels2":
        flow = np.concatenate([flow, np.array(disp_f[2])[None]])
        z = np.concatenate([z, z * -0.5], axis=-1)
        z = np.concatenate([z, z[:, ::-1]])
    z = np.ascontiguousarray(z, np.float32)
    flow = np.ascontiguousarray(flow, np.float32)
    want = np.asarray(jax_dense(jnp.asarray(z), jnp.asarray(flow)))
    got = maxwarp.maximum_warp_norm_splat_plain(torch.from_numpy(z),
                                                torch.from_numpy(flow))
    np.testing.assert_array_equal(got.numpy(), want)
    if z.shape[-1] == 1:
        kernels.reset_counts()
        w = maxwarp.maximum_warp_norm_splat(torch.from_numpy(z),
                                            torch.from_numpy(flow))
        assert torch.equal(w, got)
        assert kernels.counts()["maximum_warp_norm_splat"] == 0


def test_sparse_equals_dense_on_a_scene():
    """K5's stencils reproduce K6 at static pixels and on the moving set,
    as the JAX docstring states (zero motion exactly zero)."""
    m = _motion(4)
    positions, valid = prepare_scene_sparse(m, pad_multiple=64)
    n = int(valid.sum())
    fd, _ = euler_integrate_all_dual(m, 3, 3)
    fc, _ = euler_integrate_compact_dual(m, positions, 3, 3)
    z = _z(5)
    static = np.all(m == 0, axis=-1).astype(np.float32)
    dense = maxwarp.maximum_warp_norm_splat_plain(
        torch.from_numpy(z[None, ..., None]),
        torch.from_numpy(np.array(fd[3])[None]))[0, ..., 0].numpy()
    zd, zm = maxwarp.maximum_warp_norm_sparse_plain(
        *[torch.from_numpy(np.ascontiguousarray(a)) for a in
          (z, static, z[positions[:, 1], positions[:, 0]], positions, valid,
           np.array(fc[3]))])
    np.testing.assert_array_equal(zd.numpy()[static > 0], dense[static > 0])
    np.testing.assert_array_equal(zm.numpy()[:n],
                                  dense[positions[:n, 1], positions[:n, 0]])


@pytest.mark.parametrize("bad", ["dtype", "shape", "device", "layout",
                                 "channels"])
def test_wrappers_reject_bad_inputs(bad):
    z = torch.zeros((8, 8))
    static = torch.ones((8, 8))
    z_mov, valid = torch.zeros(16), torch.ones(16)
    positions = torch.zeros((16, 2), dtype=torch.int32)
    disp = torch.zeros((16, 2))
    zd, flow = torch.zeros((1, 8, 8, 1)), torch.zeros((1, 8, 8, 2))
    if bad == "dtype":
        z, zd = z.double(), zd.double()
    elif bad == "shape":
        positions, flow = positions[:, :1], flow[..., :1]
    elif bad == "layout":
        z = z.t()
        flow = torch.zeros((1, 8, 2, 8)).transpose(2, 3)
    elif bad == "channels":  # the kernel takes one channel
        static = static[:, :4]
        zd = torch.zeros((1, 8, 8, 2))
    else:  # neither CPU nor CUDA: no silent path
        z, static, z_mov, positions, valid, disp = (
            t.to("meta") for t in (z, static, z_mov, positions, valid, disp))
        zd, flow = zd.to("meta"), flow.to("meta")
    with pytest.raises((TypeError, ValueError)):
        maxwarp.maximum_warp_norm_sparse(z, static, z_mov, positions, valid, disp)
    with pytest.raises((TypeError, ValueError)):
        maxwarp.maximum_warp_norm_splat(zd, flow)


def test_k5_and_k6_share_one_source_with_one_cooperative_launch_each():
    """Both entries live in csrc/maxwarp.cu, built once into one library;
    each calls the one cooperative launch helper, and nothing launches with
    the triple-chevron syntax."""
    assert kernels.MAXWARP_SPARSE.source == kernels.MAXWARP_SPLAT.source \
        == "slrsfs_tpu_torch/csrc/maxwarp.cu"
    assert kernels.MAXWARP_SPARSE._lib_path() == kernels.MAXWARP_SPLAT._lib_path()
    assert not os.path.exists(os.path.join(os.path.dirname(
        kernels.MAXWARP_SPLAT._src_path), "maxwarp_sparse.cu"))
    with open(kernels.MAXWARP_SPLAT._src_path) as f:
        src = f.read()
    for k in (kernels.MAXWARP_SPARSE, kernels.MAXWARP_SPLAT):
        assert f'extern "C" int {k.symbol}(' in src
    assert src.count("cudaLaunchCooperativeKernel(") == 1
    assert src.count("return (int)launch(") == 2
    assert "<<<" not in src
