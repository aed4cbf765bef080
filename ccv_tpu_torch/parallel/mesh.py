"""Mesh and collectives of the port (counterpart of ccv_tpu/parallel/mesh.py;
reference: the data-parallel transform, lib/nnc/ccv_nnc_symbolic_graph_
parallel.c:24, and its NCCL collectives, lib/nnc/cmd/comm/ccv_nnc_comm.c).

``ccv_tpu`` is one process over global arrays, GSPMD placing the
collectives. The port is one process per rank (``torchrun``,
``torch.distributed``): a mesh is a ``DeviceMesh`` with ``ccv_tpu``'s axis
names, each axis's collectives run on ``mesh.get_group(axis)``, and the
shard bodies (the ring, GPipe, the Megatron blocks, the expert dispatch)
work on each rank's local tensors.

The collectives take a process group (``None``: the whole world) and are
differentiable by the reference's rules (comm.c:97-160), under which every
rank's loss is its own term of the global loss:

- ``comm_allreduce``: a sum; its backward is an allreduce;
- ``comm_broadcast``: every rank takes root's value (``ccv_tpu``'s masked
  psum); its backward is the reduce of the gradients to root (0 elsewhere);
- ``comm_reduce``: the sum on every rank, as ``ccv_tpu``'s psum (the
  reference leaves non-roots' outputs unspecified); backward as allreduce;
- ``all_gather``: (n, ...) of every rank's tensor; backward the sum of the
  gradients, each rank keeping its own slice (a reduce-scatter);
- ``reduce_scatter``: x (n, ...) -> this rank's slice of the sum; backward
  an all-gather;
- ``ppermute``: ``perm``'s (source, destination) pairs by batched send and
  receive, zeros where no rank sends; backward the inverse permutation.
  gloo sends and receives host tensors only, so on a gloo group a CUDA
  tensor goes through pinned host memory (``STAGED`` counts the copies).

Where every rank of a group computes the same loss (tensor parallelism, the
expert combine, GPipe's replicated output), the Megatron pair is right
instead: ``copy_to`` (identity forward, allreduce backward) where a
replicated activation enters a sharded computation, ``reduce_from``
(allreduce forward, identity backward) where partial sums leave it, and
``gather_from`` (all-gather along a dimension forward, this rank's slice of
the gradient backward).

``reduce_scatter`` and ``all_gather``'s backward are an allreduce and a
slice: every backend takes an allreduce (gloo on CUDA tensors too).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.autograd import Function
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

from ccv_tpu_torch import device as _device


def device_count(kind: Optional[str] = None) -> int:
    """ccv_nnc_device_count twin (ccv_nnc.h:1070): the CUDA devices this
    process sees."""
    return torch.cuda.device_count()


def world_size(group=None) -> int:
    """The ranks of ``group`` (the world with None); 1 when no process
    group is initialised."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def make_mesh(axes: dict, device: _device.DeviceLike = None) -> DeviceMesh:
    """A ``DeviceMesh`` from {axis name: size} over every rank of the
    initialised process group (``distributed.init``); the sizes must
    multiply to its world size. ``device``: the mesh's device type
    (default: the card)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group: "
                           "call ccv_tpu_torch.parallel.distributed.init "
                           "first")
    names, sizes = tuple(axes), tuple(int(s) for s in axes.values())
    world = dist.get_world_size()
    if math.prod(sizes) != world:
        raise ValueError(f"a mesh {dict(axes)} needs {math.prod(sizes)} "
                         f"ranks; the process group has {world}")
    return init_device_mesh(_device.resolve(device).type, sizes,
                            mesh_dim_names=names)


def data_parallel_mesh(n: Optional[int] = None,
                       device: _device.DeviceLike = None) -> DeviceMesh:
    """The ``ccv_cnnp_model_set_data_parallel(n)`` mesh: one 'data' axis
    over the world (n, if given, must be the world size)."""
    return make_mesh({"data": n or world_size()}, device)


def shard_batch(mesh: DeviceMesh, axis: str = "data") -> Tuple:
    """The placements of a batch split on its first dimension over
    ``axis`` (``P(axis)``), replicated over the other axes."""
    return tuple(Shard(0) if name == axis else Replicate()
                 for name in mesh.mesh_dim_names)


def replicate(mesh: DeviceMesh) -> Tuple:
    """The placements of a tensor every rank holds whole (``P()``)."""
    return tuple(Replicate() for _ in mesh.mesh_dim_names)


def local_shard(x: torch.Tensor, mesh: DeviceMesh,
                placements: Sequence) -> torch.Tensor:
    """This rank's block of the global ``x`` under ``placements`` (one per
    mesh axis): along each ``Shard(d)`` axis, the rank's equal slice of
    dimension d (which must divide)."""
    for name, place in zip(mesh.mesh_dim_names, placements):
        if isinstance(place, Shard):
            n = mesh.size(mesh.mesh_dim_names.index(name))
            i = mesh.get_local_rank(name)
            if x.shape[place.dim] % n:
                raise ValueError(f"dimension {place.dim} of {tuple(x.shape)}"
                                 f" does not divide over {n} ranks of "
                                 f"'{name}'")
            x = x.chunk(n, place.dim)[i]
    return x


# -- collectives with the reference's autograd rules ----------------------

def _global(group, rank: int) -> int:
    """The world rank of ``group``'s rank ``rank``."""
    return rank if group is None else dist.get_global_rank(group, rank)


def _allreduce(x: torch.Tensor, group) -> torch.Tensor:
    y = x.contiguous().clone()
    dist.all_reduce(y, group=group)
    return y


def _gather(x: torch.Tensor, group) -> torch.Tensor:
    outs = [torch.empty_like(x) for _ in range(world_size(group))]
    dist.all_gather(outs, x.contiguous(), group=group)
    return torch.stack(outs)


class _AllReduce(Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _allreduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _allreduce(g, ctx.group), None


class _Broadcast(Function):
    @staticmethod
    def forward(ctx, x, group, root):
        ctx.group, ctx.root = group, root
        y = x.contiguous().clone()
        dist.broadcast(y, src=_global(group, root), group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = _allreduce(g, ctx.group)
        if dist.get_rank(ctx.group) != ctx.root:
            g = torch.zeros_like(g)
        return g, None, None


class _AllGather(Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather(x, group)

    @staticmethod
    def backward(ctx, g):
        return _allreduce(g, ctx.group)[dist.get_rank(ctx.group)], None


class _ReduceScatter(Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        if x.shape[0] != world_size(group):
            raise ValueError(f"reduce_scatter: leading dimension "
                             f"{x.shape[0]} against {world_size(group)} "
                             f"ranks")
        return _allreduce(x, group)[dist.get_rank(group)]

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group), None


# copies through pinned host memory that ppermute made for gloo on CUDA
# tensors: "copies" (card to host before a send, host to card after a
# receive) and their "bytes"
STAGED = {"copies": 0, "bytes": 0}


def _stages(x: torch.Tensor, group) -> bool:
    """Whether ``ppermute`` stages ``x`` through host memory: gloo's send
    and receive take host tensors only (on a CUDA tensor it fails with
    "writev ... Bad address" or the rank aborts), where its allreduce and
    all-gather take CUDA tensors. Other backends get the tensor as it is."""
    return x.device.type == "cuda" and dist.get_backend(group) == "gloo"


def _pinned_like(x: torch.Tensor) -> torch.Tensor:
    return torch.empty(x.shape, dtype=x.dtype, pin_memory=True)


def _permute(x: torch.Tensor, group, perm) -> torch.Tensor:
    """x sent along ``perm``'s (source, destination) pairs of group ranks;
    what this rank receives, zeros if no rank sends to it. On a gloo group
    a CUDA tensor is sent from a pinned host copy and received into a
    pinned host buffer, then copied to the card (``STAGED`` counts the
    copies)."""
    me = dist.get_rank(group)
    out = torch.zeros_like(x)
    x = x.contiguous()
    staged = _stages(x, group)
    sends = [dst for src, dst in perm if src == me and dst != me]
    recv_from = [src for src, dst in perm if dst == me and src != me]
    if any(src == me and dst == me for src, dst in perm):
        out = x.clone()
    wire, inbox = x, out
    if staged and sends:
        wire = _pinned_like(x)
        wire.copy_(x)          # synchronous: the card's values are in
        STAGED["copies"] += 1
        STAGED["bytes"] += x.numel() * x.element_size()
    if staged and recv_from:
        inbox = _pinned_like(x)
    ops = [dist.P2POp(dist.isend, wire, _global(group, dst), group)
           for dst in sends]
    ops += [dist.P2POp(dist.irecv, inbox, _global(group, src), group)
            for src in recv_from]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if staged and recv_from:
        out.copy_(inbox)
        STAGED["copies"] += 1
        STAGED["bytes"] += x.numel() * x.element_size()
    return out


class _Ppermute(Function):
    @staticmethod
    def forward(ctx, x, group, perm):
        ctx.group, ctx.perm = group, perm
        return _permute(x, group, perm)

    @staticmethod
    def backward(ctx, g):
        inverse = [(dst, src) for src, dst in ctx.perm]
        return _permute(g, ctx.group, inverse), None, None


def comm_allreduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """CCV_NNC_COMM_ALLREDUCE_FORWARD (sum, the one reduction the reference
    has)."""
    return _AllReduce.apply(x, group)


def comm_broadcast(x: torch.Tensor, group=None, root: int = 0
                   ) -> torch.Tensor:
    """CCV_NNC_COMM_BROADCAST_FORWARD: every rank takes the value of group
    rank ``root``."""
    return _Broadcast.apply(x, group, root)


def comm_reduce(x: torch.Tensor, group=None, root: int = 0) -> torch.Tensor:
    """CCV_NNC_COMM_REDUCE_FORWARD: the sum, delivered to ``root`` and, as
    ``ccv_tpu``'s psum, to every other rank too."""
    del root  # every rank gets the sum
    return _AllReduce.apply(x, group)


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """(n, *x.shape): every rank's x in group-rank order."""
    return _AllGather.apply(x, group)


def reduce_scatter(x: torch.Tensor, group=None) -> torch.Tensor:
    """x (n, ...): this rank's slice of the sum over the group."""
    return _ReduceScatter.apply(x, group)


def ppermute(x: torch.Tensor, group, perm: Sequence[Tuple[int, int]]
             ) -> torch.Tensor:
    """x moved along the (source, destination) pairs of group ranks."""
    return _Ppermute.apply(x, group, [tuple(p) for p in perm])


# -- the Megatron pair, for computations every rank's loss repeats ----------

class _CopyTo(Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _allreduce(g, ctx.group), None


class _ReduceFrom(Function):
    @staticmethod
    def forward(ctx, x, group):
        return _allreduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return torch.cat(list(_gather(x, group)), dim)

    @staticmethod
    def backward(ctx, g):
        n, i = world_size(ctx.group), dist.get_rank(ctx.group)
        return g.chunk(n, ctx.dim)[i].contiguous(), None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's f: identity forward, allreduce of the gradient backward
    (a replicated activation entering a column-parallel matmul)."""
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's g: allreduce forward, identity backward (partial sums of
    a row-parallel matmul leaving for a replicated computation)."""
    return _ReduceFrom.apply(x, group)


def gather_from(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """Every rank's x concatenated along ``dim`` (in group-rank order);
    backward keeps this rank's slice of the gradient."""
    return _GatherFrom.apply(x, group, dim % x.ndim)
