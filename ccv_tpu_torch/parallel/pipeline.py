"""Pipeline parallelism: GPipe over a mesh axis (counterpart of
ccv_tpu/parallel/pipeline.py; the reference has none).

Rank s of the ``stage`` axis holds stage s's parameters and runs ticks 0
... M + S - 2: stage 0 feeds microbatch t, every stage runs its input and
passes the result to s + 1 (``mesh.ppermute`` round the ring; the last
stage's wraps to stage 0, which ignores it), and the last stage retires
microbatch t - (S - 1). Every rank computes at every tick, on zeros while
the pipe fills and drains (GPipe's bubble), as ``ccv_tpu``'s scan does; the
masks are tensors, so every rank's graph has the same collectives in the
same order and the backward's permutations pair up. The output is the
last stage's, replicated to every rank (``ccv_tpu``'s final psum): every
rank's loss is then the same, so its backward is the identity
(``mesh.reduce_from``).
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from ccv_tpu_torch.nn import optimizers
from ccv_tpu_torch.parallel import mesh as _mesh


def stage_params_sharding(params, mesh: DeviceMesh, axis: str = "stage"):
    """The placements of stacked per-stage parameters (leading dimension =
    stage): ``Shard(0)`` on ``axis``, replicated over the other axes."""
    place = tuple(Shard(0) if name == axis else Replicate()
                  for name in mesh.mesh_dim_names)
    return optimizers.tree_map(lambda _p: place, params)


def gpipe(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
          stage_params, x_mb: torch.Tensor, mesh: DeviceMesh,
          axis: str = "stage") -> torch.Tensor:
    """A homogeneous S-stage pipeline over the microbatch stack.

    stage_fn(params_s, x) -> y of x's shape; stage_params: this rank's
    block of the stacked parameters (leading dimension 1, as
    ``mesh.local_shard`` under ``stage_params_sharding`` gives it); x_mb
    (M, B, ...) on every rank. Returns (M, B, ...), the S stages' output,
    on every rank."""
    group = mesh.get_group(axis)
    S = mesh.size(mesh.mesh_dim_names.index(axis))
    sidx = mesh.get_local_rank(axis)
    M = x_mb.shape[0]
    p = optimizers.tree_map(lambda a: a[0], stage_params)
    dev = x_mb.device
    first = torch.tensor(sidx == 0, device=dev)
    last = torch.tensor(sidx == S - 1, device=dev)
    ring = [(i, (i + 1) % S) for i in range(S)]
    carry = torch.zeros_like(x_mb[0])
    outs = [torch.zeros_like(x_mb[0]) for _ in range(M)]
    for t in range(M + S - 1):
        x_in = torch.where(first, x_mb[min(t, M - 1)], carry)
        y = stage_fn(p, x_in).to(x_mb.dtype)
        if t >= S - 1:
            outs[t - (S - 1)] = torch.where(last, y, outs[t - (S - 1)])
        if t != M + S - 2:
            carry = _mesh.ppermute(y, group, ring)
    return _mesh.reduce_from(torch.stack(outs), group)
