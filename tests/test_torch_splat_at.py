"""K8's plain versions (slrsfs_tpu_torch.ops.splat: the single-ended
sparse splats and the raw two-ended splat) and K2's bf16 accumulation mode
against the JAX package on the same inputs, and the ``bfloat16-fast``
sparse baseline rollout against JAX's (compute and splat dtype bf16).

* float32: every JAX layout (``softsplat_sum_at``, ``_paired``, ``_quad``)
  and the raw ``softsplat_sum_at_quad_dual`` within atol/rtol 1e-5, with the
  same exact zeros (the port sums in the quad layout's order);
* bfloat16: within one bf16 ulp of max |out| (measured here: 0.5 ulp on
  the trajectory case and 1.0 ulp on the sentinel/integer/border case, for
  every layout; the plain version rounds the rows and each add to bf16 in
  the quad layout's order, and XLA rounds some of the sums elsewhere);
* K2 with bf16 rows (``splat_dual_normalize_plain``) against the JAX bf16
  splat + f32 normalisation: within one bf16 ulp of the largest field
  value;
* the bf16-fast rollout within 2e-2 on [-1, 1] frames, the JAX package's
  own bound for this mode (tests/test_rollout_sparse.py:88);
* ``softsplat``'s four modes over K3 within 1e-5, and the ops package's
  exported names."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from slrsfs_tpu.engine import rollout as jax_rollout
from slrsfs_tpu.ops import splat as jax_splat
from slrsfs_tpu.ops.euler import euler_integrate_compact_dual
from slrsfs_tpu_torch import kernels
from slrsfs_tpu_torch.engine import rollout as port_rollout
from slrsfs_tpu_torch.io.convert import from_jax_variables
from slrsfs_tpu_torch.models.baseline import BaselineModel
from slrsfs_tpu_torch.ops import splat as port_splat

torch.set_num_threads(1)

H, W, C = 20, 24, 9
BF16 = {"jax": jnp.bfloat16, "torch": torch.bfloat16}
F32 = {"jax": jnp.float32, "torch": torch.float32}


def _inputs(case: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    motion = (rng.standard_normal((H, W, 2)) * 1.3).astype(np.float32)
    motion[: H // 3] = 0.0
    motion[H - 3:, :, 1] += 6.0  # some trajectories leave the frame
    positions, valid = port_rollout.prepare_scene_sparse(motion, pad_multiple=64)
    u = (rng.standard_normal((len(valid), C)) * np.exp(rng.uniform(-2, 2, (len(valid), 1)))
         ).astype(np.float32) * valid[:, None]  # padding rows zero
    disp_f, disp_b = euler_integrate_compact_dual(motion, positions, 5, 6)
    da, db = np.array(disp_f[4]), np.array(disp_b[3])
    if case == "sentinel_integer_border":
        da[0::3] = max(H, W) + 1  # OOB sentinel: every corner dropped
        da[1::3] = [3.0, -2.0]  # exact integer shift
        da[2::3] = [-0.75, -5.5]  # fractional landings across the border
    return u, positions, valid, da, db


def _ulp(x: float) -> float:
    """One bf16 ulp at magnitude x: 2^(floor(log2 x) - 7)."""
    return 2.0 ** (np.floor(np.log2(x)) - 7)


def _check(got, want, dtype):
    got = got.float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    if dtype is F32:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(got == 0, want == 0)
    else:
        err = np.abs(got - want).max()
        assert err <= _ulp(np.abs(want).max()), (err, np.abs(want).max())


LAYOUTS = ["softsplat_sum_at", "softsplat_sum_at_paired", "softsplat_sum_at_quad"]


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ["trajectory", "sentinel_integer_border"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_splat_at_matches_jax_layouts(layout, case, dtype):
    u, pos, _, da, _ = _inputs(case)
    uj = jnp.asarray(u).astype(dtype["jax"])
    want = getattr(jax_splat, layout)(uj, jnp.asarray(pos), jnp.asarray(da), H, W)
    ut = torch.from_numpy(np.asarray(uj.astype(jnp.float32))).to(dtype["torch"])
    args = (ut, torch.from_numpy(pos), torch.from_numpy(da), H, W)
    got = getattr(port_splat, layout + "_plain")(*args)
    assert got.dtype == dtype["torch"] and got.shape == (H, W, C)
    _check(got, want, dtype)
    kernels.reset_counts()  # the wrapper on CPU tensors is the plain version
    assert torch.equal(getattr(port_splat, layout)(*args), got)
    assert kernels.counts()[kernels.SPLAT_SUM_AT.name] == 0


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ["trajectory", "sentinel_integer_border"])
def test_splat_at_quad_dual_matches_jax(case, dtype):
    u, pos, _, da, db = _inputs(case, seed=1)
    a = np.float32(1.0) - np.float32(2) / np.float32(7)
    b = np.float32(1.0) - a
    uj = jnp.asarray(u).astype(dtype["jax"])
    want = jax_splat.softsplat_sum_at_quad_dual(
        uj, jnp.asarray(pos), jnp.asarray(da), jnp.asarray(db), jnp.asarray(a),
        jnp.asarray(b), H, W)
    ut = torch.from_numpy(np.asarray(uj.astype(jnp.float32))).to(dtype["torch"])
    args = (ut, torch.from_numpy(pos), torch.from_numpy(da), torch.from_numpy(db),
            float(a), float(b), H, W)
    got = port_splat.softsplat_sum_at_quad_dual_plain(*args)
    _check(got, want, dtype)
    kernels.reset_counts()
    assert torch.equal(port_splat.softsplat_sum_at_quad_dual(*args), got)
    assert kernels.counts()[kernels.SPLAT_SUM_AT.name] == 0


@pytest.mark.parametrize("slr", [False, True])
@pytest.mark.parametrize("case", ["trajectory", "sentinel_integer_border"])
def test_splat_dual_normalize_bf16_matches_jax(case, slr):
    """K2's bf16 mode: JAX's bf16 scatter plus the bf16 static identity,
    normalised in f32 (``rollout.py:577-581``; the SLR epilogue of
    ``slr_unpack_splatted``)."""
    u, pos, valid, da, db = _inputs(case, seed=2)
    rng = np.random.default_rng(3)
    ez = np.exp(-rng.uniform(0, 3, (len(valid), 1))).astype(np.float32)
    rows = np.concatenate([u[:, :-1] * ez, ez], -1) * valid[:, None]
    if slr:  # [fs·e^Z, af·e^C, e^C, e^Z]
        ec = np.exp(rng.uniform(0, 1, (len(valid), 1))).astype(np.float32)
        rows = np.concatenate([rows[:, :-2], rows[:, :1] * ec, ec * valid[:, None],
                               rows[:, -1:]], -1)
    static = (rng.uniform(0, 1, (H, W, 1)) > 0.5).astype(np.float32)
    u_static = np.abs(rng.standard_normal((H, W, rows.shape[1]))).astype(np.float32) * static
    a = np.float32(1.0) - np.float32(3) / np.float32(7)
    b = np.float32(1.0) - a
    rj, sj = jnp.asarray(rows).astype(jnp.bfloat16), jnp.asarray(u_static).astype(jnp.bfloat16)
    g = np.asarray((jax_splat.softsplat_sum_at_quad_dual(
        rj, jnp.asarray(pos), jnp.asarray(da), jnp.asarray(db), jnp.asarray(a),
        jnp.asarray(b), H, W) + sj).astype(jnp.float32))
    if slr:
        want = np.concatenate([g[..., :-3] / np.maximum(g[..., -1:], 1e-8),
                               g[..., -3:-2] / np.maximum(g[..., -2:-1], 1e-8)], -1)
        plain = port_splat.splat_dual_normalize_slr_plain
    else:
        want = g[..., :-1] / np.maximum(g[..., -1:], 1e-8)
        plain = port_splat.splat_dual_normalize_plain
    to_bf16 = lambda x: torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16)
    got = plain(to_bf16(rj), torch.from_numpy(pos), torch.from_numpy(valid),
                torch.from_numpy(da), torch.from_numpy(db), float(a), float(b),
                to_bf16(sj), torch.float32).numpy()
    # the division amplifies one bf16 rounding of the sums; held at one ulp
    # of the largest field value
    assert np.abs(got - want).max() <= _ulp(np.abs(want).max())
    # cells no moving tap reaches keep u_static's exact zeros (the decoders'
    # hole mask); where signed sums cancel, a bf16 rounding may differ
    reached = np.asarray(jax_splat.softsplat_sum_at_quad_dual(
        jnp.abs(jnp.asarray(rows)), jnp.asarray(pos), jnp.asarray(da),
        jnp.asarray(db), jnp.asarray(a), jnp.asarray(b), H, W)) != 0
    np.testing.assert_array_equal(got[~reached[..., :got.shape[-1]]] == 0,
                                  want[~reached[..., :got.shape[-1]]] == 0)


def test_bf16_fast_rollout_matches_jax(real32_env):
    """The baseline's bfloat16-fast sparse rollout (bf16 networks and bf16
    splat accumulation) against JAX's at compute_dtype = splat_dtype =
    bfloat16, within 2e-2, and nearer JAX's bf16-fast frames than the f32
    frames are."""
    rng = np.random.default_rng(11)
    flow = (rng.standard_normal((32, 32, 2)) * 1.2).astype(np.float32)
    flow[:16] = 0.0
    pos, valid = jax_rollout.prepare_scene_sparse(flow, pad_multiple=64)
    N, DB = 6, 3
    jm, jv, img = real32_env["model"], real32_env["variables"], real32_env["img"]
    want = np.asarray(jax.jit(lambda v, i, f, p, va: jax_rollout.baseline_rollout_sparse(
        jm, v, i, f, N, p, va, decode_batch=DB, compute_dtype=jnp.bfloat16,
        splat_dtype=jnp.bfloat16))(jv, jnp.asarray(img), jnp.asarray(flow),
                                   jnp.asarray(pos), jnp.asarray(valid)))
    opt = real32_env["opt"].replace(bn_noise_misc=True)
    model = BaselineModel(opt).eval()
    model.load_state_dict(from_jax_variables(jax.tree.map(np.asarray, jv), opt))
    args = (model, torch.from_numpy(img), torch.from_numpy(flow), N,
            torch.from_numpy(pos), torch.from_numpy(valid))
    got = port_rollout.baseline_rollout_sparse(
        *args, decode_batch=DB, compute_dtype=torch.bfloat16,
        splat_dtype=torch.bfloat16).numpy()
    f32 = port_rollout.baseline_rollout_sparse(*args, decode_batch=DB).numpy()
    err = np.abs(got - want).max()
    assert err <= 2e-2, err
    assert np.abs(got - f32).max() > 0.0  # the mode really ran in bf16


@pytest.mark.parametrize("mode", ["summation", "average", "linear", "softmax"])
def test_softsplat_modes_match_jax(mode):
    """``softsplat``'s four modes over K3 (its plain version on the CPU)
    against the JAX ``softsplat``, at 1e-5."""
    rng = np.random.default_rng(5)
    inp = rng.standard_normal((2, 12, 10, 5)).astype(np.float32)
    flow = (rng.standard_normal((2, 12, 10, 2)) * 2.0).astype(np.float32)
    flow[0, :3] = np.round(flow[0, :3])  # integer landings leave empty cells
    metric = rng.standard_normal((2, 12, 10, 1)).astype(np.float32)
    want = jax_splat.softsplat(jnp.asarray(inp), jnp.asarray(flow),
                               jnp.asarray(metric), mode)
    got = port_splat.softsplat(torch.from_numpy(inp), torch.from_numpy(flow),
                               torch.from_numpy(metric), mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_ops_export_the_jax_names():
    """The port's ops package exports every name of the JAX one, K6's two
    halves (max_splat, inverse_max_gather) included."""
    import slrsfs_tpu.ops as jax_ops
    import slrsfs_tpu_torch.ops as port_ops

    missing = set(jax_ops.__all__) - set(port_ops.__all__)
    assert missing == set(), missing
    for name in port_ops.__all__:
        assert callable(getattr(port_ops, name)), name
