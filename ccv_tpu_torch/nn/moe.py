"""Mixture-of-Experts feed-forward, forward pass (counterpart of
ccv_tpu/nn/moe.py's ``MoEConfig``, ``init`` and ``forward``; the
reference has no MoE).

Routing is top-k over a softmax router; dispatch and combine go through
per-expert buffers of a fixed capacity (GShard / Switch): each (token,
choice) takes the next slot of its expert in token order, an exclusive
prefix sum in int64; tokens past the capacity are dropped (combine weight
0; the caller's residual carries them). The experts' feed-forward is two
batched matmuls with tanh-approximated GELU between (``jax.nn.gelu``'s
default, not ``ops.gelu``'s). Returns the Switch load-balance loss beside
the output.

Ties in the router: ``lax.top_k`` takes the lower expert index first;
``torch.topk`` promises no order on CUDA, so the choice is a stable
descending sort, which does.

Expert parallelism (``shardings``, ``forward(..., expert=(mesh, axis))``):
each rank of the axis holds E / n experts (``shard_params``) and every
token; the routing is computed whole on every rank, each rank runs its
own experts' buffers, and the combine is an allreduce of the partial
outputs (Megatron's pair: the tokens and the gates enter the experts
through ``copy_to``, the output leaves through ``reduce_from``), so the
output and the aux loss equal the dense forward's on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ccv_tpu_torch import device as _device
from ccv_tpu_torch.parallel import mesh as _mesh


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    dim: int
    ff: int
    experts: int
    top_k: int = 2
    capacity_factor: float = 1.25


def init(generator: torch.Generator, cfg: MoEConfig,
         device: _device.DeviceLike = None) -> Dict[str, torch.Tensor]:
    """The router N(0, 0.02^2), both expert weights uniform in
    +-sqrt(6 / (dim + ff)), zero biases; drawn on the CPU from
    ``generator``, put on ``device`` (default: the card)."""
    device = _device.resolve(device)
    scale = (6.0 / (cfg.dim + cfg.ff)) ** 0.5

    def uniform(shape):
        return torch.rand(shape, generator=generator) * (2 * scale) - scale

    params = {
        "router": torch.randn((cfg.dim, cfg.experts), generator=generator)
        * 0.02,
        "w1": uniform((cfg.experts, cfg.dim, cfg.ff)),
        "b1": torch.zeros((cfg.experts, cfg.ff)),
        "w2": uniform((cfg.experts, cfg.ff, cfg.dim)),
        "b2": torch.zeros((cfg.experts, cfg.dim)),
    }
    return {k: v.to(device) for k, v in params.items()}


def shardings(params, mesh, axis: str = "model"):
    """``ccv_tpu``'s expert-parallel placements (one per mesh axis for each
    leaf): the expert dimension of w1, b1, w2, b2 split over ``axis``
    (replicated where E does not divide), the router whole."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.mesh_dim_names
    n = mesh.size(names.index(axis))
    whole = tuple(Replicate() for _ in names)
    split = tuple(Shard(0) if name == axis else Replicate()
                  for name in names)
    return {k: whole if k == "router" or v.shape[0] % n else split
            for k, v in params.items()}


def shard_params(params, mesh, axis: str = "model"):
    """This rank's block of ``params`` under ``shardings``."""
    place = shardings(params, mesh, axis)
    return {k: _mesh.local_shard(v, mesh, place[k]).clone()
            for k, v in params.items()}


def forward(params: Dict[str, torch.Tensor], cfg: MoEConfig, x: torch.Tensor,
            capacity: Optional[int] = None, expert=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (..., T, D) -> (out (..., T, D) in x's type, aux loss, a float32
    scalar). The expert matmuls run in the parameters' type (float32
    parameters: x is promoted, as in ``ccv_tpu``). expert: (mesh, axis):
    ``params`` hold this rank's experts (``shard_params``), x every
    token."""
    orig_shape = x.shape
    D = orig_shape[-1]
    t = x.reshape(-1, D)
    N = t.shape[0]
    E, K = cfg.experts, cfg.top_k
    if capacity is None:
        capacity = max(1, int(cfg.capacity_factor * N * K / E))
    C = capacity
    wdt = torch.promote_types(t.dtype, params["w1"].dtype)
    tw = t.to(wdt)

    logits = torch.matmul(tw, params["router"].to(wdt))          # (N, E)
    probs = torch.softmax(logits.float(), dim=-1)
    gate_vals, gate_idx = torch.sort(probs, dim=-1, descending=True,
                                     stable=True)
    gate_vals, gate_idx = gate_vals[:, :K], gate_idx[:, :K]      # (N, K)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)

    # each (token, choice)'s slot in its expert's buffer: how many earlier
    # (token, choice) pairs chose the same expert
    flatoh = F.one_hot(gate_idx.reshape(-1), E)                  # (N*K, E)
    before = torch.cumsum(flatoh, dim=0) - flatoh
    pos = (before * flatoh).sum(-1).reshape(N, K)
    keep = pos < C

    flat_slot = (gate_idx * C + torch.where(keep, pos, C - 1)).reshape(-1)
    weights = (gate_vals * keep).to(wdt)
    E_here, first, group = E, 0, None
    if expert is not None and params["w1"].shape[0] != E:
        mesh, axis = expert
        group, E_here = mesh.get_group(axis), params["w1"].shape[0]
        first = mesh.get_local_rank(axis) * E_here  # this rank's first expert
        tw, weights = _mesh.copy_to(tw, group), _mesh.copy_to(weights, group)
    contrib = (tw[:, None, :] * keep.to(wdt)[..., None]).reshape(N * K, D)
    buffers = torch.zeros((E * C, D), dtype=wdt, device=x.device)
    buffers.index_add_(0, flat_slot, contrib)
    buffers = buffers.reshape(E, C, D)[first:first + E_here]

    h = F.gelu(torch.bmm(buffers, params["w1"].to(wdt))
               + params["b1"].to(wdt)[:, None, :], approximate="tanh")
    y = torch.bmm(h, params["w2"].to(wdt)) + params["b2"].to(wdt)[:, None, :]
    if group is not None:  # the other experts' slots stay zero here
        y = F.pad(y, (0, 0, 0, 0, first, E - first - E_here))

    gathered = y.reshape(E * C, D)[flat_slot].reshape(N, K, D)
    out = (gathered * weights[..., None]).sum(dim=1)
    if group is not None:
        out = _mesh.reduce_from(out, group)

    me = probs.mean(dim=0)
    fe = F.one_hot(gate_idx[:, 0], E).float().sum(dim=0) / N
    aux = E * (fe * me).sum()
    return out.reshape(orig_shape).to(x.dtype), aux
