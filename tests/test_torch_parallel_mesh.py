"""The port's ``parallel/mesh.py`` against the JAX ``parallel/mesh.py``.

``shard_batch``: for each case the JAX ``shard_batch`` on a 2-device
``make_mesh(2)`` either replicates a leaf (the port's every rank keeps it
whole) or shards it (the port's rank r keeps exactly JAX's shard on device
r), or both raise ``ValueError``. The collectives run on two gloo ranks
(``tests/torch_dist_ranks.py``): ``replicate`` sets rank 1's weights and
buffers to rank 0's, ``all_reduce_sum``'s value and gradient are SyncBN's
(with no warning), ``all_reduce_mean`` averages across several buckets."""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import PartitionSpec as P

import torch_dist_ranks as ranks
from slrsfs_tpu.parallel import mesh as jax_mesh
from slrsfs_tpu_torch.parallel import mesh as port_mesh

torch.set_num_threads(1)


def _case(name):
    rng = np.random.default_rng(5)

    def a(*shape, dtype=np.float32):
        return rng.standard_normal(shape).astype(dtype)

    return {
        # (batch, batch_size)
        "divisible": ({"images": [a(4, 2, 2, 3) for _ in range(3)], "index": a(4, 3)}, 4),
        "non_batch_leaf": ({"motions": a(4, 2, 2, 2), "hints": a(5, 2)}, 4),
        "indivisible_raises": ({"images": [a(3, 2, 2, 3)], "index": a(3, 3)}, 3),
        "moving_sets": ({"motions": a(4, 2, 2, 2), "mov_pos": a(4, 7, 2).astype(np.int32),
                         "mov_valid": a(4, 7), "step": np.float32(1.0)}, 4),
        "no_batch_size": ({"odd": a(3, 2), "even": a(6), "scalar": np.float32(2.0)}, None),
    }[name]


CASES = ("divisible", "non_batch_leaf", "indivisible_raises", "moving_sets", "no_batch_size")


@pytest.mark.parametrize("name", CASES)
def test_shard_batch_follows_jax_rules(name):
    batch, batch_size = _case(name)
    jm = jax_mesh.make_mesh(2)
    fakes = [port_mesh.Mesh(None, r, 2, torch.device("cpu")) for r in range(2)]
    if name.endswith("raises"):
        with pytest.raises(ValueError, match="not divisible"):
            jax_mesh.shard_batch(batch, jm, batch_size=batch_size)
        for m in fakes:
            with pytest.raises(ValueError, match="not divisible"):
                port_mesh.shard_batch(batch, m, batch_size=batch_size)
        return
    want = jax_mesh.shard_batch(batch, jm, batch_size=batch_size)
    got = [port_mesh.shard_batch(batch, m, batch_size=batch_size) for m in fakes]
    leaves_w = jax.tree.leaves(want)
    leaves_x = jax.tree.leaves(batch)
    n_sharded = 0
    for r in range(2):
        leaves_g = jax.tree.leaves(got[r])
        assert len(leaves_g) == len(leaves_w) == len(leaves_x)
        for x, w, g in zip(leaves_x, leaves_w, leaves_g):
            if w.sharding.spec == P():
                np.testing.assert_array_equal(g, x)
            else:
                assert w.sharding.spec == P("data")
                shards = sorted(w.addressable_shards, key=lambda s: s.device.id)
                np.testing.assert_array_equal(g, np.asarray(shards[r].data))
                n_sharded += 1
    assert n_sharded > 0


def test_replicate_sets_every_rank_to_rank0(tmp_path):
    (b0, a0), (b1, a1) = ranks.run_ranks(ranks.rank_replicate, 2, tmp_path)
    assert not torch.equal(b0["weight"], b1["weight"])
    for k in b0:
        assert torch.equal(a0[k], b0[k]) and torch.equal(a1[k], b0[k]), k


def test_all_reduce_sum_is_syncbn_both_ways(tmp_path):
    out = ranks.run_ranks(ranks.rank_all_reduce_sum, 2, tmp_path)
    x = [torch.arange(6, dtype=torch.float32) * (r + 1) for r in range(2)]
    w = [torch.linspace(-1.0, 2.0, 6) * (r + 2) for r in range(2)]
    y = x[0] ** 2 + x[1] ** 2
    for r, (got_y, got_grad, warned) in enumerate(out):
        torch.testing.assert_close(got_y, y, rtol=0, atol=0)
        # d/dx_r of sum_r' (y · w_r'): the cotangents summed over the ranks
        torch.testing.assert_close(got_grad, 2.0 * x[r] * (w[0] + w[1]))
        assert warned == [], warned


def test_all_reduce_mean_over_buckets(tmp_path):
    out = ranks.run_ranks(ranks.rank_all_reduce_mean, 2, tmp_path, 64)
    want = []
    for r in range(2):
        g = torch.Generator().manual_seed(7 + r)
        ts = [torch.randn(s, generator=g) for s in ((3, 4), (50,), (2, 2, 2))]
        ts.insert(1, torch.randn((7,), generator=g).double())
        want.append(ts)
    for got in out:
        assert [t.dtype for t in got] == [torch.float32, torch.float64,
                                          torch.float32, torch.float32]
        for a, b0, b1 in zip(got, *want):
            torch.testing.assert_close(a, (b0 + b1) / 2)
