"""A host mirror of K1's and K4's CUDA control flow (``csrc/euler.cu``),
held bit for bit against the JAX integrators where tests run.

The kernel does not round as the JAX scan does: it adds 1.5 * 2^23 and
reads the integer from the low bits of the sum, exact below 2^22 and,
once clamped to a side below 2^22, beyond. It takes the first step's
gather at the source itself (clamped) and issues each next gather from the
destination as soon as it is known, a pinned invalid trajectory's from its
source. ``_k1_mirror`` applies those rules in plain torch, one row at a
time as the kernel's threads do; its outputs must equal
``euler_integrate_compact_dual``, ``euler_integrate_all``,
``euler_integrate``, ``euler_integrate_compact`` and
``euler_integrate_all_dual`` of the JAX package on continuous,
half-integer (rounding ties), out-of-bounds and leaving motion, a moving
pixel at (0, 0), padded rows at a static (0, 0), an odd P and n = 0.
The limit helpers the wrappers call before any launch are checked here
too (no test here reaches a limit on the card)."""

import numpy as np
import pytest
import torch

from slrsfs_tpu.ops import euler as jax_euler
from slrsfs_tpu_torch import kernels
from slrsfs_tpu_torch.engine.rollout import prepare_scene_sparse
from slrsfs_tpu_torch.ops import euler as port_euler
from slrsfs_tpu_torch.ops import splat as port_splat

torch.set_num_threads(1)

H, W = 19, 23
KINDS = ["continuous", "half_integer", "out_of_bounds", "leaving"]


def _round_even(x: torch.Tensor) -> torch.Tensor:
    """The kernel's round_even: the integer in the low bits of x + 1.5·2^23,
    float32 throughout."""
    s = x.to(torch.float32) + torch.tensor(12582912.0, dtype=torch.float32)
    return (s.view(torch.int32) - 0x4B400000).long()


def _k1_mirror(m: np.ndarray, pos, n: int, neg: bool):
    """The kernel's rules for one direction (``neg``: -M) of rows ``pos``
    (R, 2) int32 [x, y], or the dense grid when None, each row on its own
    as the kernel's threads are. Returns (entries (n + 1, R, 2),
    visibility (n + 1, R))."""
    flat = torch.from_numpy(m).reshape(-1, 2)
    Hm, Wm, _ = m.shape
    if pos is None:
        ys, xs = torch.meshgrid(torch.arange(Hm), torch.arange(Wm), indexing="ij")
        src = torch.stack([xs, ys], -1).reshape(-1, 2)
    else:
        src = torch.from_numpy(np.asarray(pos)).long()
    R = src.shape[0]
    oob = torch.tensor(float(max(Hm, Wm) + 1))
    cx, cy = src[:, 0].float(), src[:, 1].float()
    dx, dy = cx, cy
    valid = torch.ones(R, dtype=torch.bool)
    entries, vis = [torch.zeros((R, 2))], [torch.ones(R)]
    if n > 0:  # step 1's gather, at the source itself, clamped
        g = flat[src[:, 1].clamp(0, Hm - 1) * Wm + src[:, 0].clamp(0, Wm - 1)]
    for s in range(n):
        g = -g if neg else g
        nx, ny = dx + g[:, 0], dy + g[:, 1]
        valid = valid & ~((nx > Wm - 1) | (nx < 0) | (ny > Hm - 1) | (ny < 0))
        dx, dy = torch.where(valid, nx, cx), torch.where(valid, ny, cy)
        if s + 1 < n:  # the next gather, from the pinned source once invalid
            ix = _round_even(dx).clamp(0, Wm - 1)
            iy = _round_even(dy).clamp(0, Hm - 1)
            g = flat[iy * Wm + ix]
        entries.append(torch.where(valid[:, None], torch.stack([nx - cx, ny - cy], -1), oob))
        vis.append(valid.float())
    return torch.stack(entries), torch.stack(vis)


def _motion(kind: str, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    m = (rng.standard_normal((H, W, 2)) * 1.3).astype(np.float32)
    if kind == "half_integer":
        m = np.round(m * 2.0) / 2.0  # destinations land on x.5: ties
    elif kind == "out_of_bounds":
        m[H - 4:, :, 1] += 6.0
        m[:, :3, 0] -= 4.0
    elif kind == "leaving":
        m = (rng.standard_normal((H, W, 2)) * 9.0).astype(np.float32)
    m[: H // 3] = 0.0  # static rows, with the pixel at (0, 0)
    return m.astype(np.float32)


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("steps", [(0, 0), (4, 5), (9, 10)])
@pytest.mark.parametrize("kind", KINDS)
def test_mirror_matches_jax_compact_dual(kind, steps):
    """K1: both directions of the moving pixels, padded (P a multiple of
    64) with rows at a static (0, 0)."""
    m = _motion(kind, 0)
    pos, _ = prepare_scene_sparse(m, pad_multiple=64)
    assert (pos[-1] == 0).all() and (m[0, 0] == 0).all()
    want_f, want_b = jax_euler.euler_integrate_compact_dual(m, pos, *steps)
    got_f, _ = _k1_mirror(m, pos, steps[0], False)
    got_b, _ = _k1_mirror(m, pos, steps[1], True)
    _eq(got_f, want_f)
    _eq(got_b, want_b)


@pytest.mark.parametrize("P", [1, 37, 64])
def test_mirror_matches_jax_odd_rows_and_a_moving_origin(P):
    """An odd P (the kernel's last warp part empty) and a moving pixel at
    (0, 0), in the moving set and as the padding."""
    m = _motion("out_of_bounds", 1)
    m[0, 0] = [0.5, 1.5]
    pos, _ = prepare_scene_sparse(m, pad_multiple=1)
    n_mov = max(P - 3, 1)  # the first is (0, 0); then three padded rows there
    pos = np.concatenate([pos[:n_mov], np.zeros((3, 2), np.int32)])[:P]
    want_f, want_b = jax_euler.euler_integrate_compact_dual(m, pos, 7, 8)
    _eq(_k1_mirror(m, pos, 7, False)[0], want_f)
    _eq(_k1_mirror(m, pos, 8, True)[0], want_b)
    assert (np.asarray(want_f)[1:, -1] != 0).any()  # the padding moves


@pytest.mark.parametrize("n_steps", [0, 1, 7])
@pytest.mark.parametrize("kind", KINDS)
def test_mirror_matches_jax_dense_forms(kind, n_steps):
    """K4: the dense form with visibility, its last step, and the dense
    dual form."""
    m = _motion(kind, 2)
    want_d, want_v = jax_euler.euler_integrate_all(m, n_steps)
    d, v = _k1_mirror(m, None, n_steps, False)
    _eq(d.reshape(n_steps + 1, H, W, 2), want_d)
    _eq(v.reshape(n_steps + 1, H, W), want_v)
    last_d, last_v = jax_euler.euler_integrate(m, n_steps)
    _eq(d[-1].reshape(H, W, 2), last_d)
    _eq(v[-1].reshape(H, W), last_v)
    want_f, want_b = jax_euler.euler_integrate_all_dual(m, n_steps, n_steps + 1)
    _eq(d.reshape(n_steps + 1, H, W, 2), want_f)
    b, _ = _k1_mirror(m, None, n_steps + 1, True)
    _eq(b.reshape(n_steps + 2, H, W, 2), want_b)


@pytest.mark.parametrize("n_steps", [0, 6])
@pytest.mark.parametrize("kind", KINDS)
def test_mirror_matches_jax_compact_with_visibility(kind, n_steps):
    m = _motion(kind, 3)
    pos, _ = prepare_scene_sparse(m, pad_multiple=64)
    want_d, want_v = jax_euler.euler_integrate_compact(m, pos, n_steps)
    d, v = _k1_mirror(m, pos, n_steps, False)
    _eq(d, want_d)
    _eq(v, want_v)


def test_round_even_matches_rint_below_the_limit_and_clamped_beyond():
    """The magic add rounds half to even as ``torch.round`` for |x| below
    2^22 and, clamped to a side below 2^22, as the clamped round beyond."""
    x = torch.tensor([-2.5, -1.5, -0.5, -0.0, 0.0, 0.49999997, 0.5, 1.5, 2.5,
                      254.5, 255.5, 4194302.5, 4194303.5, -4194303.5],
                     dtype=torch.float32)
    assert torch.equal(_round_even(x), torch.round(x).long())
    far = torch.tensor([4194304.0, 5e6, 8388607.0, 3e7, 1e30, -4194304.0, -1e7,
                        -3e38], dtype=torch.float32)
    side = (1 << 22) - 1
    assert torch.equal(_round_even(far).clamp(0, side - 1),
                       torch.round(far.double()).clamp(0, side - 1).long())


def test_limit_helpers_name_the_limit():
    """What the wrappers check before any launch: the integrators' side
    below 2^22 and 32-bit indices, K3's side below 32768, and K3's
    backward rows within a block's shared memory."""
    port_euler.check_euler_limits("K1", (1 << 22) - 1, 1)
    for H_, W_ in ((1 << 22, 8), (8, 1 << 22)):
        with pytest.raises(ValueError, match="below 4194304"):
            port_euler.check_euler_limits("K1 (euler_compact_dual)", H_, W_)
    with pytest.raises(ValueError, match="2\\^31"):
        port_euler.check_euler_limits("K4 (euler_all)", 1 << 16, 1 << 15)
    port_splat._check_dense_sides("K3", 32767, 32767)
    with pytest.raises(ValueError, match="below 32768"):
        port_splat._check_dense_sides("K3's forward", 32768, 4)
    kernels.check_shared_memory("K3's backward", 1000, 1000, "rows")
    with pytest.raises(ValueError, match="1001 bytes .* above the card's 1000"):
        kernels.check_shared_memory("K3's backward", 1001, 1000, "rows")


def test_wrappers_refuse_an_empty_field_with_rows():
    positions = torch.zeros((3, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="empty motion"):
        port_euler.euler_compact_dual(torch.zeros((0, 4, 2)), positions, 2, 2)
    f, b = port_euler.euler_compact_dual(torch.zeros((0, 4, 2)), positions, 0, 0)
    assert f.shape == b.shape == (1, 3, 2)
