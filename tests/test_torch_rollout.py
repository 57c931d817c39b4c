"""The port's rollouts (slrsfs_tpu_torch.engine.rollout) against the JAX
rollouts on the same scene and weights (real archs, ngf=16, 32², N=6).

* port dense and sparse vs JAX: 2e-3 on [-1, 1] frames (conv summation
  order, as tests/test_forward_flow_parity.py:103);
* port sparse vs port dense: 2e-5, the sparse path's exactness claim as the
  JAX package states it (tests/test_rollout_sparse.py:184);
* bf16 mode: its distance to JAX f32 within twice the distance JAX's own
  bf16 mode shows, measured here."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from slrsfs_tpu.engine import rollout as jax_rollout
from slrsfs_tpu_torch import kernels
from slrsfs_tpu_torch.engine import rollout as port_rollout
from slrsfs_tpu_torch.io.convert import from_jax_variables
from slrsfs_tpu_torch.models.baseline import BaselineModel, init_random_weights

torch.set_num_threads(1)

N = 6
DB = 3


@pytest.fixture(scope="module")
def scene(real32_env):
    rng = np.random.default_rng(11)
    H = W = 32
    flow = (rng.standard_normal((H, W, 2)) * 1.2).astype(np.float32)
    flow[: H // 2] = 0.0  # top half static
    flow[:, : W // 4] = 0.0
    positions, valid = jax_rollout.prepare_scene_sparse(flow, pad_multiple=64)
    opt = real32_env["opt"].replace(bn_noise_misc=True)
    model = BaselineModel(opt).eval()
    model.load_state_dict(from_jax_variables(
        jax.tree.map(np.asarray, real32_env["variables"]), opt))
    jmodel, jvars = real32_env["model"], real32_env["variables"]
    img = real32_env["img"]

    def jax_sparse(dtype):
        return np.asarray(jax.jit(lambda v, i, f, p, va: jax_rollout.baseline_rollout_sparse(
            jmodel, v, i, f, N, p, va, decode_batch=DB, compute_dtype=dtype))(
            jvars, jnp.asarray(img), jnp.asarray(flow), jnp.asarray(positions),
            jnp.asarray(valid)))

    t = dict(img=torch.from_numpy(img), flow=torch.from_numpy(flow),
             positions=torch.from_numpy(positions), valid=torch.from_numpy(valid))

    def port_sparse(dtype):
        return port_rollout.baseline_rollout_sparse(
            model, t["img"], t["flow"], N, t["positions"], t["valid"],
            decode_batch=DB, compute_dtype=dtype).numpy()

    jax_dense = np.asarray(jax.jit(lambda v, i, f: jax_rollout.baseline_rollout(
        jmodel, v, i, f, N))(jvars, jnp.asarray(img), jnp.asarray(flow)))
    return dict(
        jax_dense=jax_dense,
        jax_sparse=jax_sparse(jnp.float32),
        jax_sparse_bf16=jax_sparse(jnp.bfloat16),
        port_dense=port_rollout.baseline_rollout(model, t["img"], t["flow"], N).numpy(),
        port_sparse=port_sparse(torch.float32),
        port_sparse_bf16=port_sparse(torch.bfloat16),
    )


def test_dense_rollout_matches_jax(scene):
    assert scene["port_dense"].shape == (N, 32, 32, 3)
    np.testing.assert_allclose(scene["port_dense"], scene["jax_dense"],
                               rtol=2e-3, atol=2e-3)


def test_sparse_rollout_matches_jax(scene):
    np.testing.assert_allclose(scene["port_sparse"], scene["jax_sparse"],
                               rtol=2e-3, atol=2e-3)


def test_sparse_equals_dense(scene):
    np.testing.assert_allclose(scene["port_sparse"], scene["port_dense"],
                               rtol=2e-5, atol=2e-5)


def test_bf16_within_twice_jax_bf16_delta(scene):
    jax_delta = np.abs(scene["jax_sparse_bf16"] - scene["jax_sparse"]).max()
    port_delta = np.abs(scene["port_sparse_bf16"] - scene["jax_sparse"]).max()
    assert jax_delta > 0.0  # the bf16 mode really ran in bf16
    assert port_delta <= 2.0 * jax_delta, (port_delta, jax_delta)


@pytest.mark.parametrize("n,pad,ratio", [(1, 16, None), (33, 16, None),
                                         (200, 16, 1.25), (4000, 16, 1.0005),
                                         (33, 16, 1.01)])
def test_prepare_scene_sparse_matches_jax(n, pad, ratio):
    flow = np.zeros((64, 64, 2), np.float32)
    flow.reshape(-1, 2)[np.random.default_rng(n).permutation(64 * 64)[:n], 0] = 1.0
    want = jax_rollout.prepare_scene_sparse(flow, pad_multiple=pad,
                                            bucket_ratio=ratio)
    got = port_rollout.prepare_scene_sparse(flow, pad_multiple=pad,
                                            bucket_ratio=ratio)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_cpu_rollout_launches_no_kernel(real32_env):
    """On CPU tensors the wrappers take the plain versions; the counts only
    move when a kernel launches."""
    kernels.reset_counts()
    flow = torch.zeros((16, 16, 2))
    flow[8:, :, 0] = 0.5
    pos, val = port_rollout.prepare_scene_sparse(flow.numpy(), pad_multiple=16)
    opt = real32_env["opt"].replace(bn_noise_misc=True)
    model = BaselineModel(opt).eval()
    init_random_weights(model, seed=0)
    out = port_rollout.baseline_rollout_sparse(
        model, torch.zeros((1, 16, 16, 3)), flow, 2, torch.from_numpy(pos),
        torch.from_numpy(val), decode_batch=2)
    assert bool(torch.isfinite(out).all())
    assert out.shape == (2, 16, 16, 3)
    counts = kernels.counts()
    assert "euler_compact_dual" in counts and "splat_dual_normalize" in counts
    assert set(counts.values()) == {0}, counts
