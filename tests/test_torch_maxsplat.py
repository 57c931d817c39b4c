"""K6's two halves as entry points of their own (K6a ``max_splat``, K6b
``inverse_max_gather``; slrsfs_tpu_torch.ops.maxwarp, kernels in
csrc/maxsplat.cu) against the JAX ``max_splat`` and ``inverse_max_gather``
on the same inputs, and ``maximum_warp_norm_splat`` for any channel count.

Max is exact and order-free, so the plain versions must equal JAX bit for
bit; ``assert_array_equal`` treats -0 and +0 as equal, as the kernels'
float atomic max does (it gives ``fmaxf``'s bits up to the sign of a
zero). The cases: C in {1, 3, 65}, B = 2, a ragged 13 x 19 grid, and a
flow that sends whole rows off the grid, some pixels to the Euler
sentinel max(H, W) + 1, some by exact integer shifts and some to
fractional landings across the border. The kernels are held against these
plain versions on a card (tests/test_torch_gpu.py, chip_smoke.py phase
25)."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from slrsfs_tpu.ops import splat as jax_splat
from slrsfs_tpu_torch import kernels
from slrsfs_tpu_torch.ops import maxwarp

torch.set_num_threads(1)

B, H, W = 2, 13, 19


def _inputs(C: int, seed: int):
    """(inp, flow) as numpy: a random flow of a few pixels with its special
    rows (sentinel, integer shifts, border landings, off the grid)."""
    rng = np.random.default_rng(seed)
    inp = (rng.standard_normal((B, H, W, C)) * 3.0).astype(np.float32)
    flow = (rng.standard_normal((B, H, W, 2)) * 2.5).astype(np.float32)
    flow[0, 0::5] = max(H, W) + 1  # the Euler sentinel: all four corners off
    flow[0, 1::5] = [3.0, -2.0]  # exact integer shifts: three zero weights
    flow[1, 2::5] = [-0.75, -H + 0.5]  # fractional landings across the top edge
    flow[1, :, -3:] = [W + 4.0, 0.25]  # off the right edge
    return inp, flow


def _jax(fn, *arrays):
    return np.asarray(fn(*map(jnp.asarray, arrays)))


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("C", [1, 3, 65])
def test_max_splat_matches_jax(C):
    inp, flow = _inputs(C, C)
    want = _jax(jax_splat.max_splat, inp, flow)
    got = maxwarp.max_splat_plain(*_torch(inp, flow))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == -1000.0).any() and (want > -1000.0).any()  # empty and reached cells
    kernels.reset_counts()
    assert torch.equal(maxwarp.max_splat(*_torch(inp, flow)), got)
    assert kernels.counts()["max_splat"] == 0  # the CPU runs the plain version


@pytest.mark.parametrize("C", [1, 3, 65])
def test_inverse_max_gather_matches_jax(C):
    """On a max map that JAX's own max-splat made, and on a random one (so
    that a gathered value beats ``init`` at many pixels)."""
    inp, flow = _inputs(C, 10 + C)
    rng = np.random.default_rng(C)
    for maxmap in (_jax(jax_splat.max_splat, inp, flow),
                   (rng.standard_normal(inp.shape) * 3.0).astype(np.float32)):
        want = _jax(jax_splat.inverse_max_gather, maxmap, flow, inp)
        got = maxwarp.inverse_max_gather_plain(*_torch(maxmap, flow, inp))
        np.testing.assert_array_equal(got.numpy(), want)
        kernels.reset_counts()
        assert torch.equal(maxwarp.inverse_max_gather(*_torch(maxmap, flow, inp)), got)
        assert kernels.counts()["inverse_max_gather"] == 0
    assert (want > inp).any() and (want == inp).any()


@pytest.mark.parametrize("C", [1, 3])
def test_maximum_warp_norm_splat_matches_jax(C):
    """The composition, through the plain version and through the wrapper
    (K6 at C = 1, the K6a → K6b pair above it, both plain on the CPU)."""
    z, flow = _inputs(C, 20 + C)
    want = _jax(jax_splat.maximum_warp_norm_splat, z, flow)
    plain = maxwarp.maximum_warp_norm_splat_plain(*_torch(z, flow))
    np.testing.assert_array_equal(plain.numpy(), want)
    kernels.reset_counts()
    np.testing.assert_array_equal(maxwarp.maximum_warp_norm_splat(*_torch(z, flow)).numpy(),
                                  want)
    assert sum(kernels.counts().values()) == 0


@pytest.mark.parametrize("bad", ["dtype", "shape", "layout", "device", "rank"])
@pytest.mark.parametrize("op", ["max_splat", "inverse_max_gather"])
def test_wrappers_reject_bad_inputs(op, bad):
    """f32 only (a ``TypeError`` naming the dtype), (B, H, W, C) beside a
    (B, H, W, 2) flow, contiguous, on the CPU or the card: a ``ValueError``
    otherwise, before anything is launched."""
    x, flow = torch.zeros((1, 6, 5, 3)), torch.zeros((1, 6, 5, 2))
    if bad == "dtype":
        x = x.double()
    elif bad == "shape":
        flow = flow[:, :5]
    elif bad == "layout":
        x = torch.zeros((1, 6, 3, 5)).transpose(2, 3)
    elif bad == "device":  # neither CPU nor CUDA: no silent path
        x, flow = x.to("meta"), flow.to("meta")
    else:
        x = x[0]
    args = (x, flow) if op == "max_splat" else (x, flow, x)
    err = TypeError if bad == "dtype" else ValueError
    with pytest.raises(err, match="float64" if bad == "dtype" else None):
        getattr(maxwarp, op)(*args)


def test_the_pair_shares_k6s_corners_through_one_header():
    """K6a and K6b live in csrc/maxsplat.cu, one library; it and K6's
    csrc/maxwarp.cu both include csrc/maxwarp_corners.cuh, which alone
    defines the corners, the grid test and the float atomic max, so the
    two cannot drift; both libraries' hashes cover it."""
    csrc = os.path.dirname(kernels.MAX_SPLAT._src_path)
    assert kernels.MAX_SPLAT.source == kernels.INVERSE_MAX_GATHER.source \
        == "slrsfs_tpu_torch/csrc/maxsplat.cu"
    assert kernels.MAX_SPLAT._lib_path() == kernels.INVERSE_MAX_GATHER._lib_path()
    header = os.path.join(csrc, "maxwarp_corners.cuh")
    for k in (kernels.MAX_SPLAT, kernels.MAXWARP_SPLAT):
        assert header in kernels.source_files(k._src_path)
        with open(k._src_path) as f:
            src = f.read()
        for name in ("Corners corners_of(", "bool in_grid(", "void atomic_max_f32("):
            assert name not in src, (k.source, name)
    with open(header) as f:
        shared = f.read()
    for name in ("Corners corners_of(", "bool in_grid(", "void atomic_max_f32("):
        assert name in shared
    with open(kernels.MAX_SPLAT._src_path) as f:
        src = f.read()
    for k in (kernels.MAX_SPLAT, kernels.INVERSE_MAX_GATHER):
        assert f'extern "C" int {k.symbol}(' in src
