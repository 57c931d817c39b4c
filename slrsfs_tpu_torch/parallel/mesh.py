"""Process groups for data-parallel training and frame-sharded renders
(PyTorch port of ``slrsfs_tpu/parallel/mesh.py``).

The JAX package runs one program over a 1-D 'data' mesh of the chips it
sees: batches sharded over it, parameters replicated, BN moments global
because ``jnp.mean`` over a sharded axis all-reduces. The port runs one
process a card (``torchrun --nproc_per_node=K``) in one
``torch.distributed`` group: NCCL between cards, gloo on the CPU. A
``Mesh`` holds the group, this process's rank, the world size and its
device. What JAX's partitioner does implicitly is explicit here:
``shard_batch`` keeps this rank's rows, ``replicate`` broadcasts rank 0's
weights, ``all_reduce_mean`` averages the gradients and ``all_reduce_sum``
(autograd-aware) sums the BN moments, which ``nn/norm.py`` reads from the
``Mesh`` that ``attach`` hands its layers.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional

import torch
import torch.distributed as dist

Tensor = torch.Tensor

# gradient buckets of at most this many bytes, as DDP's default bucket
BUCKET_BYTES = 25 * 2 ** 20


@dataclass
class Mesh:
    """One process's view of the group: ``group`` (the default process
    group), ``rank``, ``world`` and this rank's ``device``. ``owns_group``:
    ``make_mesh`` formed the group and ``close`` destroys it."""

    group: object
    rank: int
    world: int
    device: torch.device
    owns_group: bool = False

    def __deepcopy__(self, memo):
        # a copied model (``engine/rollout.py:cast_for_compute``) shares
        # its layers' group
        return self

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)

    def close(self) -> None:
        """Destroy the group if ``make_mesh`` formed it."""
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()
        self.owns_group = False


def make_mesh(n: Optional[int] = None, device: str = "cuda") -> Mesh:
    """The mesh of every rank of the group. An existing group is joined; a
    torchrun environment (``WORLD_SIZE`` and ``MASTER_ADDR`` set) forms its
    group; otherwise a 1-rank group in this process, as the JAX mesh holds
    the one device it sees. ``device`` 'cuda' puts this rank on
    ``cuda:LOCAL_RANK`` and forms an NCCL group, 'cpu' puts it on the CPU
    and forms a gloo group. ``n``, when given, must be the world size."""
    dev_type = torch.device(device).type
    if dev_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' "
                               "for gloo ranks on the CPU")
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    elif dev_type == "cpu":
        dev = torch.device("cpu")
    else:
        raise ValueError(f"unsupported device {device!r}")
    backend = "nccl" if dev_type == "cuda" else "gloo"
    owns = False
    if not dist.is_initialized():
        owns = True
        if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
            dist.init_process_group(backend, init_method="env://", device_id=(
                dev if dev_type == "cuda" else None))
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1)
    mesh = Mesh(dist.group.WORLD, dist.get_rank(), dist.get_world_size(), dev, owns)
    if n is not None and n != mesh.world:
        raise ValueError(f"a mesh of {n} ranks was asked for, the group has {mesh.world}")
    return mesh


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(batch, mesh: Mesh, batch_size: Optional[int] = None):
    """This rank's part of a batch (a dict, list or tuple tree of numpy
    arrays or tensors), by the JAX ``shard_batch`` rules: a leaf whose
    leading dimension divides by the world size is cut into ``world``
    contiguous blocks and this rank keeps its own; with ``batch_size`` a
    leaf whose leading dimension is not ``batch_size`` is replicated (kept
    whole) and a batch leaf that does not divide raises ``ValueError``;
    without it a leaf that does not divide is replicated. Scalars are
    replicated. The moving sets ``mov_pos`` (B, P, 2) and ``mov_valid``
    (B, P) are batch leaves like any other."""
    n = mesh.world

    def put(x):
        if getattr(x, "ndim", 0) < 1:
            return x
        lead = x.shape[0]
        if batch_size is not None and lead != batch_size:
            return x
        if lead % n:
            if batch_size is None:
                return x
            raise ValueError(f"batch leaf with leading dim {lead} not divisible by "
                             f"mesh size {n}: shape {tuple(x.shape)}")
        per = lead // n
        return x[mesh.rank * per:(mesh.rank + 1) * per]

    return _map(put, batch)


@torch.no_grad()
def replicate(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Every parameter and buffer of ``module`` set to rank 0's, in place
    (one broadcast each). Returns the module."""
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src=0, group=mesh.group)
    return module


@torch.no_grad()
def all_reduce_mean(tensors: List[Tensor], mesh: Mesh) -> List[Tensor]:
    """Each tensor replaced, in place, by its mean over the ranks: the
    tensors are flattened into buckets of one dtype and at most
    ``BUCKET_BYTES`` (a larger tensor is a bucket alone), each bucket
    summed by one all-reduce and divided by the world size. Returns the
    tensors."""
    buckets, cur, size = [], [], 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if cur and (size + nbytes > BUCKET_BYTES or t.dtype != cur[0].dtype):
            buckets.append(cur)
            cur, size = [], 0
        cur.append(t)
        size += nbytes
    if cur:
        buckets.append(cur)
    for b in buckets:
        flat = torch.cat([t.reshape(-1) for t in b])
        dist.all_reduce(flat, group=mesh.group)
        flat.div_(mesh.world)
        off = 0
        for t in b:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()
    return tensors


class _AllReduceSum(torch.autograd.Function):
    """y = the sum over the ranks of x, on every rank. Its VJP is the sum
    over the ranks of the cotangents (SyncBN's backward): each rank's loss
    reaches every rank's x through y."""

    @staticmethod
    def forward(ctx, x: Tensor, group) -> Tensor:
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g: Tensor):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: Tensor, mesh: Mesh) -> Tensor:
    """Differentiable sum of ``x`` over the ranks (``_AllReduceSum``)."""
    return _AllReduceSum.apply(x, mesh.group)


class _AllReduceMax(torch.autograd.Function):
    """y = the maximum over the ranks of a scalar x, on every rank. Its VJP
    sends the sum over the ranks of the cotangents to the ranks whose x is
    the maximum, shared equally among them, as the maximum's gradient
    within one process goes to its argmax."""

    @staticmethod
    def forward(ctx, x: Tensor, group) -> Tensor:
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
        ctx.save_for_backward(x == y)
        return y

    @staticmethod
    def backward(ctx, g: Tensor):
        (own,) = ctx.saved_tensors
        s = torch.stack([g.reshape(()), own.to(g.dtype).reshape(())])
        dist.all_reduce(s, group=ctx.group)
        return torch.where(own, s[0] / s[1], torch.zeros_like(g)), None


def all_reduce_max(x: Tensor, mesh: Mesh) -> Tensor:
    """Differentiable maximum of the scalar ``x`` over the ranks
    (``_AllReduceMax``)."""
    return _AllReduceMax.apply(x, mesh.group)


def attach(module: torch.nn.Module, mesh: Optional[Mesh]) -> torch.nn.Module:
    """Hand ``mesh`` to every submodule of ``module`` whose class declares
    a ``mesh`` (``nn/norm.py``'s BN layers: global moments and the global
    batch's noise; the trainable models: the global Z maximum of
    ``z_normalize``), which act on it with more than one rank. ``None``
    detaches. Returns the module."""
    for m in module.modules():
        if hasattr(type(m), "mesh"):
            m.mesh = mesh
    return module


def frame_block(n_frames: int, mesh: Mesh) -> range:
    """This rank's contiguous block of frames (``P('data')`` over
    ``arange(N)`` in JAX): N / world frames from rank · N / world. Raises
    ``ValueError`` when the world size does not divide N."""
    if n_frames % mesh.world:
        raise ValueError(f"n_frames={n_frames} must divide over {mesh.world} ranks")
    per = n_frames // mesh.world
    return range(mesh.rank * per, (mesh.rank + 1) * per)


def all_gather_frames(local: Tensor, mesh: Mesh) -> Tensor:
    """(world · n, ...) on every rank from each rank's (n, ...) block, in
    rank order: one ``all_gather_into_tensor`` on NCCL, ``all_gather`` on
    gloo (which has no gather into one tensor)."""
    local = local.contiguous()
    out = torch.empty((mesh.world * local.shape[0],) + tuple(local.shape[1:]),
                      dtype=local.dtype, device=local.device)
    if mesh.backend == "nccl":
        dist.all_gather_into_tensor(out, local, group=mesh.group)
    else:
        dist.all_gather(list(out.chunk(mesh.world)), local, group=mesh.group)
    return out
