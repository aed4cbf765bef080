"""The global batch under data and sequence parallelism.

Under GSPMD ``ccv_tpu`` computes batch statistics, loss means and dropout
masks over the global batch. A rank of the port holds only its block of
it, so the ops that reach across the batch read the block's layout here:
inside ``sharded((0, data_group), (1, seq_group))`` a tensor's dimension 0
is one of ``data_group``'s equal slices of the global dimension, and its
dimension 1 one of ``seq_group``'s (ranks in group order). Then

- ``global_sum`` sums over those ranks (differentiable: an allreduce both
  ways, every rank's loss being its own term of the global loss);
- ``parts`` is how many blocks the global batch has;
- ``mean`` is this rank's share of the global batch's mean, the one
  convention of every loss under data parallelism: each rank returns its
  share, and the shares add up to the one-rank loss (``global_batch_loss``
  marks a loss that keeps it);
- ``rand`` draws the global tensor's uniforms from the generator, which
  every rank seeds alike, and keeps this rank's block, so a dropout mask is
  the one-rank step's mask, row for row.

Batch norm in training (``nn.ops.batch_norm``), the transformers' masked
cross entropy and dropout, ``nn.ops.dropout`` and ``Trainable``'s losses
read it. Outside ``sharded`` every helper is the one-rank identity, and
a group that is None or holds one rank splits nothing (so a world of one
runs the one-rank step itself).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ccv_tpu_torch.parallel import mesh as _mesh


@dataclasses.dataclass(frozen=True)
class BatchShard:
    """(tensor dimension, process group) pairs: along each dimension the
    global batch is split evenly over the group's ranks."""
    dims: Tuple[Tuple[int, Any], ...]


_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "ccv_tpu_torch_batch_shard", default=None)


def _split(group) -> int:
    """How many ranks ``group`` splits the batch over: 1 for None (unlike
    the collectives, where None is the world)."""
    return 1 if group is None else _mesh.world_size(group)


@contextlib.contextmanager
def sharded(*dims: Tuple[int, Any]):
    """Run the enclosed forward (and its loss) on this rank's block of the
    global batch, split along each (dimension, group) of ``dims``; pairs
    whose group splits nothing are left out, and with none left the
    enclosed code runs as on one rank."""
    dims = tuple((d, g) for d, g in dims if _split(g) > 1)
    token = _CURRENT.set(BatchShard(dims) if dims else None)
    try:
        yield
    finally:
        _CURRENT.reset(token)


def current() -> Optional[BatchShard]:
    return _CURRENT.get()


def parts(dims: Optional[Sequence[int]] = None) -> int:
    """How many blocks the global batch has (1 outside ``sharded``); with
    ``dims``, only along those tensor dimensions."""
    shard = current()
    if shard is None:
        return 1
    return math.prod(_mesh.world_size(g) for d, g in shard.dims
                     if dims is None or d in dims)


def global_sum(t: torch.Tensor, dims: Optional[Sequence[int]] = None
               ) -> torch.Tensor:
    """``t`` summed over the ranks that split the batch (only those along
    ``dims``, if given)."""
    shard = current()
    for d, group in (shard.dims if shard is not None else ()):
        if dims is None or d in dims:
            t = _mesh.comm_allreduce(t, group)
    return t


def mean(t: torch.Tensor) -> torch.Tensor:
    """This rank's share of the global batch's mean of ``t`` (``t`` being
    this rank's block): its sum over the global element count; ``t.mean()``
    outside ``sharded``."""
    if current() is None:
        return t.mean()
    return t.sum() / (t.numel() * parts())


def global_batch_loss(fn):
    """Marks ``fn`` as a loss that keeps ``mean``'s convention: inside
    ``sharded`` it returns this rank's share of the global batch's loss.
    ``Trainable.set_data_parallel`` takes only losses so marked."""
    fn.global_batch = True
    return fn


def rand(shape: Sequence[int], generator: Optional[torch.Generator],
         device: torch.device,
         extra: Sequence[Tuple[int, Any]] = ()) -> torch.Tensor:
    """This rank's block of ``torch.rand`` of the global tensor: the
    ``shape`` block's dimensions scaled up by the batch's split (and by
    ``extra``'s (dimension, group) pairs, e.g. heads over a tensor-parallel
    group), drawn whole, sliced."""
    shard = current()
    pieces = [(d, g) for d, g in (shard.dims if shard is not None else ())
              if d < len(shape)] + list(extra)
    full = list(shape)
    for d, g in pieces:
        full[d] *= _mesh.world_size(g)
    u = torch.rand(full, generator=generator, device=device)
    for d, g in pieces:
        u = u.chunk(_mesh.world_size(g), d)[dist.get_rank(g)]
    return u


def rows(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's equal slice of the global batch ``x`` (dimension 0);
    ``x`` itself where ``group`` splits nothing."""
    n = _split(group)
    if x.shape[0] % n:
        raise ValueError(f"a batch of {x.shape[0]} rows does not split over "
                         f"{n} ranks")
    return x.chunk(n, 0)[dist.get_rank(group)] if n > 1 else x


def allreduce_grads(grads: List[torch.Tensor], groups: Sequence[Any]
                    ) -> List[torch.Tensor]:
    """The gradients summed over each of ``groups`` (no autograd), through
    one flat bucket per group and dtype; groups that split nothing are
    skipped."""
    groups = [g for g in groups if _split(g) > 1]
    if not groups:
        return grads
    out = list(grads)
    for dtype in {g.dtype for g in grads}:
        idx = [i for i, g in enumerate(grads) if g.dtype == dtype]
        flat = torch.cat([grads[i].reshape(-1) for i in idx])
        for group in groups:
            dist.all_reduce(flat, group=group)
        for i, piece in zip(idx, flat.split([grads[i].numel()
                                             for i in idx])):
            out[i] = piece.view_as(grads[i])
    return out
