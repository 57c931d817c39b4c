"""Gloo ranks for the port's multi-process CPU tests (not collected).

``run_ranks(fn, world, tmp_path, *args)`` spawns ``world`` processes that
join one gloo group through a file in ``tmp_path`` (never a TCP port: the
suite's workers would collide), run ``fn(mesh, *args)`` with one thread
each and save its result; the parent polls them against a deadline, kills
them and fails when it passes (a rank that dies mid-collective would leave
the others waiting forever), and returns the ranks' results in rank order.
The rank functions below import the port only, never JAX.
"""

from __future__ import annotations

import os
import time

import torch
import torch.multiprocessing as mp

DEADLINE_S = 60.0


def _entry(rank: int, world: int, root: str, fn, args):
    import torch.distributed as dist

    from slrsfs_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{root}/rendezvous",
                            rank=rank, world_size=world)
    try:
        result = fn(make_mesh(world, device="cpu"), *args)
        torch.save(result, os.path.join(root, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, tmp_path, *args, deadline_s: float = DEADLINE_S):
    """``[fn(mesh, *args) of rank r for r in range(world)]``, each rank a
    spawned gloo process; fails after ``deadline_s`` seconds."""
    root = str(tmp_path / f"ranks_{fn.__name__}_{time.monotonic_ns()}")
    os.makedirs(root)
    ctx = mp.start_processes(_entry, args=(world, root, fn, args), nprocs=world,
                             join=False, start_method="spawn")
    end = time.monotonic() + deadline_s
    try:
        while not ctx.join(timeout=0.5):
            if time.monotonic() > end:
                raise AssertionError(f"{fn.__name__} on {world} ranks passed its "
                                     f"{deadline_s:.0f} s deadline")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=5)
    return [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


class SGD:
    """A test-only stand-in for ``engine/trainer.py:Adam`` (its ``step``,
    ``count``, ``mu`` and ``nu``): p -= lr·g, so that parameters move in
    proportion to the gradients, as ``tests/test_trainer.py`` swaps optax's
    Adam for SGD to compare sharded and unsharded steps."""

    def __init__(self, params, lr: float = 1e-3):
        self.params, self.lr, self.count = list(params), lr, 0
        self.mu, self.nu = [], []

    @torch.no_grad()
    def step(self, grads):
        self.count += 1
        for p, g in zip(self.params, grads):
            p.sub_(self.lr * g)


def state_of(tr) -> dict:
    """Copies of every parameter and buffer of G and D."""
    return {**{f"G.{k}": v.clone() for k, v in tr.model.state_dict().items()},
            **{f"D.{k}": v.clone() for k, v in tr.d_model.state_dict().items()}}


def make_trainer(opt, states, mesh=None, deterministic=True, sgd=True):
    """The stage-1, SLR or motion trainer of ``opt`` (``cli/train.py:
    build``, T = 4) on the CPU with ``states``' G and D weights (and VGG's,
    under "VGG"), with ``SGD`` in place of both Adams when ``sgd``."""
    from slrsfs_tpu_torch.cli.train import build

    _, tr = build(opt, train_max_steps=4, device="cpu", seed=0, mesh=mesh)
    tr.model.load_state_dict(states["G"])
    tr.d_model.load_state_dict(states["D"])
    if "VGG" in states:
        tr.vgg.load_state_dict(states["VGG"])
    tr.deterministic = deterministic
    if sgd:
        tr.opt_g, tr.opt_d = SGD(tr.g_params), SGD(tr.d_params)
    return tr


def train_steps(tr, batches):
    """One ``train_step`` a batch: (logs, gradients, states) a step."""
    logs, grads, states = [], [], []
    for b in batches:
        logs.append({k: v.clone() for k, v in tr.train_step(b).items()})
        grads.append([g.clone() for g in tr.last_grads["g"] + tr.last_grads["d"]])
        states.append(state_of(tr))
    return logs, grads, states


# ---- rank functions -------------------------------------------------------

def rank_replicate(mesh):
    """A linear layer seeded by the rank, then ``replicate``: its weights
    before and after."""
    from slrsfs_tpu_torch.parallel.mesh import replicate

    torch.manual_seed(100 + mesh.rank)
    layer = torch.nn.Linear(5, 3)
    layer.register_buffer("stat", torch.full((3,), float(mesh.rank)))
    before = {k: v.clone() for k, v in layer.state_dict().items()}
    replicate(layer, mesh)
    return before, {k: v.clone() for k, v in layer.state_dict().items()}


def rank_all_reduce_sum(mesh):
    """``all_reduce_sum`` of a rank-dependent x under a rank-dependent loss:
    (y, x.grad, the warnings raised)."""
    import warnings

    from slrsfs_tpu_torch.parallel.mesh import all_reduce_sum

    x = (torch.arange(6, dtype=torch.float32) * (mesh.rank + 1)).requires_grad_(True)
    w = torch.linspace(-1.0, 2.0, 6) * (mesh.rank + 2)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        y = all_reduce_sum(x * x, mesh)
        (y * w).sum().backward()
    return y.detach(), x.grad, [str(c.message) for c in caught]


def rank_all_reduce_mean(mesh, bucket_bytes):
    """``all_reduce_mean`` over tensors of two dtypes and sizes across
    several buckets of at most ``bucket_bytes`` (set as this rank's
    ``BUCKET_BYTES``): the reduced tensors."""
    from slrsfs_tpu_torch.parallel import mesh as mesh_module
    from slrsfs_tpu_torch.parallel.mesh import all_reduce_mean

    mesh_module.BUCKET_BYTES = bucket_bytes
    g = torch.Generator().manual_seed(7 + mesh.rank)
    ts = [torch.randn(s, generator=g) for s in ((3, 4), (50,), (2, 2, 2))]
    ts.insert(1, torch.randn((7,), generator=g).double())
    return all_reduce_mean(ts, mesh)


def rank_rollouts(mesh, cases):
    """Each case's frame-sharded rollout, (slr, opt, state, args, kw): the
    baseline (or SLR) model built from ``opt`` and ``state`` and its
    outputs on this rank."""
    from slrsfs_tpu_torch.engine import rollout
    from slrsfs_tpu_torch.models.baseline import BaselineModel
    from slrsfs_tpu_torch.models.slr import SLRModel

    outs = []
    for slr, opt, state, args, kw in cases:
        model = (SLRModel if slr else BaselineModel)(opt).eval()
        model.load_state_dict(state)
        fn = (rollout.slr_rollout_frame_sharded if slr
              else rollout.baseline_rollout_frame_sharded)
        outs.append(fn(model, *args, mesh, **kw))
    return outs


def rank_render(mesh, root, image, flow, kw):
    """``SceneRenderer(shard_frames=True)`` on the CPU rendering one scene
    into ``root/rank<r>``: the files found there after ``close()``."""
    from slrsfs_tpu_torch.cli.render import SceneRenderer

    r = SceneRenderer(shard_frames=True, device="cpu", **kw)
    assert r.mesh.world == mesh.world and r.mesh.rank == mesh.rank
    save_dir = os.path.join(root, f"rank{mesh.rank}")
    r.render(image, flow, save_dir, name="scene")
    r.close()
    return sorted(os.path.relpath(os.path.join(d, f), save_dir)
                  for d, _, fs in os.walk(save_dir) for f in fs)


def rank_train(mesh, opt, states, batches, deterministic):
    """Data-parallel ``SGD`` steps, one a numpy batch (or list of
    micro-batches), each on this rank's rows: ``train_steps``' logs,
    gradients and states."""
    from slrsfs_tpu_torch.cli.train import to_device_batch
    from slrsfs_tpu_torch.parallel.mesh import shard_batch

    tr = make_trainer(opt, states, mesh, deterministic=deterministic)

    def mine(b):
        return to_device_batch(shard_batch(b, mesh, batch_size=opt.batch_size), "cpu")

    return train_steps(tr, [mine(b) if isinstance(b, dict) else [mine(x) for x in b]
                            for b in batches])


def rank_partial_bn(mesh, x, mask, gy):
    """A partial ``NoiseBN`` in train mode with zero noise on this rank's
    rows: (y, x.grad, the stored statistics)."""
    from slrsfs_tpu_torch.nn.norm import NoiseBN
    from slrsfs_tpu_torch.parallel.mesh import attach

    bn = NoiseBN(x.shape[1], spectral=False, partial=True)
    with torch.no_grad():
        for p in bn.parameters():
            p.copy_(torch.linspace(-0.5, 0.5, p.numel()).reshape(p.shape))
    attach(bn, mesh)
    B = x.shape[0] // mesh.world
    rows = slice(mesh.rank * B, (mesh.rank + 1) * B)
    xr = x[rows].clone().requires_grad_(True)
    y = bn(xr, mask[rows], train=True)
    (y * gy[rows]).sum().backward()
    return y.detach(), xr.grad, bn.pbn.stored_mean.clone(), bn.pbn.stored_var.clone()


def rank_dryrun(mesh, which):
    """``parallel/dryrun.py``'s step ``which`` on this rank: its logs."""
    from slrsfs_tpu_torch.parallel import dryrun

    return dryrun.STEPS[which](mesh)
