"""K3's bf16 mode (``slrsfs_tpu_torch.ops.splat``) against the JAX
``softsplat_sum`` on bf16 features and a float32 flow, on the CPU.

The plain forward repeats the JAX ``_splat_sum_single`` op for op (weights
in f32 cast to bf16, the products rounded to bf16, each quarter summed in
row order with every add rounded to bf16, the four quarters combined left
to right in bf16), so it is held bit for bit. The plain backward sums both
cotangents in f32 and rounds ``grad_inp`` to bf16 once, as JAX does:
``grad_inp`` is held within one bf16 ulp, at fewer than 0.1 % of its
elements (XLA's jitted f32 sum of the four corners may round at another
place; eager, the two agree bit for bit), ``grad_flow`` within 1e-5 of its
largest entry (the channel sums of the inner products run in another
order). The
kernels themselves run on the card only (``tests/test_torch_gpu.py``)."""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from slrsfs_tpu.ops.splat import softsplat_sum as jax_softsplat_sum
from slrsfs_tpu_torch.ops import splat as port_splat

torch.set_num_threads(1)

B, H, W = 2, 32, 32


def _flow(kind: str, rng) -> np.ndarray:
    if kind == "random":
        return (rng.standard_normal((B, H, W, 2)) * 3.0).astype(np.float32)
    if kind == "integer":  # corners on cells: weights 0 and 1
        return rng.integers(-3, 4, (B, H, W, 2)).astype(np.float32)
    if kind == "leaving":  # most corners off the grid
        return (rng.standard_normal((B, H, W, 2)) * 30.0).astype(np.float32)
    return np.zeros((B, H, W, 2), np.float32)


def _inputs(kind: str, C: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    g = rng.standard_normal((B, H, W, C)).astype(np.float32)
    return x, _flow(kind, rng), g


@pytest.fixture(scope="module")
def jax_fns():
    fwd = jax.jit(jax_softsplat_sum)

    @jax.jit
    def vjp(x, f, g):
        _, back = jax.vjp(jax_softsplat_sum, x, f)
        return back(g)

    return fwd, vjp


def _bf(a):
    return torch.from_numpy(a).to(torch.bfloat16)


@pytest.mark.parametrize("C", [9, 67])
@pytest.mark.parametrize("kind", ["random", "integer", "leaving", "zero"])
def test_bf16_forward_matches_jax_bit_for_bit(jax_fns, kind, C):
    x, f, _ = _inputs(kind, C)
    want = np.asarray(jax_fns[0](jnp.asarray(x, jnp.bfloat16), jnp.asarray(f))
                      .astype(jnp.float32))
    got = port_splat.softsplat_sum_plain(_bf(x), torch.from_numpy(f))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("C", [9, 67])
@pytest.mark.parametrize("kind", ["random", "integer", "leaving"])
def test_bf16_backward_matches_jax(jax_fns, kind, C):
    x, f, g = _inputs(kind, C, seed=1)
    wi, wf = jax_fns[1](jnp.asarray(x, jnp.bfloat16), jnp.asarray(f),
                        jnp.asarray(g, jnp.bfloat16))
    gi, gf = port_splat.softsplat_sum_grad_plain(_bf(x), torch.from_numpy(f), _bf(g))
    assert gi.dtype == torch.bfloat16 and gf.dtype == torch.float32
    # one bf16 ulp: XLA's jitted f32 sum of the four corners may round at
    # another place, and a sum at a rounding boundary then moves by an ulp
    wi = np.asarray(wi.astype(jnp.float32))
    np.testing.assert_allclose(gi.float().numpy(), wi, rtol=2.0 ** -7, atol=0)
    assert (gi.float().numpy() != wi).mean() < 1e-3
    wf = np.asarray(wf)
    np.testing.assert_allclose(gf.numpy(), wf, rtol=0, atol=1e-5 * np.abs(wf).max())


def test_autograd_runs_the_bf16_plain_versions_on_the_cpu():
    """``softsplat_sum`` on bf16 CPU tensors: the forward is the plain bf16
    sum, the backward hands a bf16 grad_inp and an f32 grad_flow, equal to
    the plain VJP."""
    x, f, g = _inputs("random", 11, seed=2)
    xt = _bf(x).requires_grad_(True)
    ft = torch.from_numpy(f).requires_grad_(True)
    out = port_splat.softsplat_sum(xt, ft)
    assert torch.equal(out, port_splat.softsplat_sum_plain(_bf(x), torch.from_numpy(f)))
    out.backward(_bf(g))
    wi, wf = port_splat.softsplat_sum_grad_plain(_bf(x), torch.from_numpy(f), _bf(g))
    assert xt.grad.dtype == torch.bfloat16 and ft.grad.dtype == torch.float32
    assert torch.equal(xt.grad, wi) and torch.equal(ft.grad, wf)


@pytest.mark.parametrize("n, span", [(0, 5), (1, 1), (200, 3), (200, 200), (300, 1)])
def test_index_add_in_order_rounds_every_add(n, span):
    """``_index_add_in_order`` equals a loop of single adds, each rounded to
    bf16, in row order."""
    rng = np.random.default_rng(n + span)
    q = torch.from_numpy(rng.integers(0, span, n))
    upd = torch.from_numpy(rng.standard_normal((n, 3)).astype(np.float32)).to(torch.bfloat16)
    got = torch.zeros((span, 3), dtype=torch.bfloat16)
    port_splat._index_add_in_order(got, q, upd)
    want = torch.zeros((span, 3), dtype=torch.bfloat16)
    for i in range(n):
        want[q[i]] = want[q[i]] + upd[i]
    assert torch.equal(got, want)


@pytest.mark.parametrize("C", [1, 8, 65, 67, 2048])
def test_bf16_forward_allocates_only_its_output(C, monkeypatch):
    """The bf16 forward's wrapper, its launch replaced by a recorder: one
    allocation, the zeroed bf16 output of inp's shape, handed to the kernel
    with inp and flow as 4-byte aligned pointers (no scratch)."""
    inp = torch.ones((2, 3, 5, C), dtype=torch.bfloat16)
    flow = torch.zeros((2, 3, 5, 2))
    allocs, launches = [], []
    for fn in ("empty", "empty_like", "zeros", "zeros_like"):
        real = getattr(torch, fn)

        def record(*a, _real=real, **k):
            t = _real(*a, **k)
            allocs.append(t)
            return t
        monkeypatch.setattr(port_splat.torch, fn, record)

    class Recorder:
        def launch(self, *args):
            launches.append(args)

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(port_splat.kernels, "SPLAT_DENSE_FWD_BF16", Recorder())
    monkeypatch.setattr(port_splat.torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(port_splat.torch.cuda, "current_stream", lambda: Stream())
    out = port_splat.softsplat_sum_fwd_bf16_kernel(inp, flow)
    assert len(allocs) == 1 and allocs[0] is out
    assert out.dtype == torch.bfloat16 and out.shape == inp.shape
    assert bool((out == 0).all())
    assert len(launches) == 1
    ptrs, rest = launches[0][:3], launches[0][3:]
    assert ptrs == (inp.data_ptr(), flow.data_ptr(), out.data_ptr())
    assert all(p % 4 == 0 for p in ptrs)
    assert rest == (2, 3, 5, C, 0)


@pytest.mark.parametrize("which", ["forward", "backward"])
def test_bf16_wrappers_refuse_what_the_kernels_do_not_take(which, monkeypatch):
    """Through the wrappers, before anything is allocated or launched: the
    channel limit, the 32-bit pixel count, the side limit and the dtypes.
    An allocation or a launch here fails the test with its own error."""
    def trap(*a, **k):
        raise AssertionError("allocated or launched before the checks")

    for fn in ("empty", "empty_like", "zeros", "zeros_like"):
        monkeypatch.setattr(port_splat.torch, fn, trap)
    for k in ("SPLAT_DENSE_FWD_BF16", "SPLAT_DENSE_BWD_BF16"):
        monkeypatch.setattr(port_splat.kernels, k, None)

    def call(inp, flow):
        if which == "forward":
            return port_splat.softsplat_sum_fwd_bf16_kernel(inp, flow)
        return port_splat.softsplat_sum_bwd_bf16_kernel(inp, flow, inp)

    bf16 = torch.bfloat16
    flow = torch.ones((1, 4, 4, 2))
    with pytest.raises(ValueError, match="at most 2048 channels"):
        call(torch.ones((1, 4, 4, 2049), dtype=bf16), flow)
    huge = torch.ones((1, 1, 1, 9), dtype=bf16).expand(2 ** 16, 256, 256, 9)
    with pytest.raises(ValueError, match="pixels"):
        call(huge, torch.ones((1, 1, 1, 2)).expand(2 ** 16, 256, 256, 2))
    with pytest.raises(ValueError, match="below 32768"):
        call(torch.ones((1, 1, 32768, 9), dtype=bf16), torch.ones((1, 1, 32768, 2)))
    with pytest.raises(TypeError, match="bfloat16 inp"):
        call(torch.ones((1, 4, 4, 9)), flow)
    with pytest.raises(TypeError, match="float32 flow"):
        call(torch.ones((1, 4, 4, 9), dtype=bf16), flow.double())
