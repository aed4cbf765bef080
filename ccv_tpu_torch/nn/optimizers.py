"""Optimizers of the port (counterpart of ccv_tpu/nn/optimizers.py): Adam
and AdamW through ``_adam_family``.

The interface mirrors ``ccv_tpu``'s: ``opt.init(params) -> state`` and
``opt.update(grads, state, params) -> (params, state)``, over nested
dicts and lists of tensors. Unlike JAX's pure functions, ``update`` changes
the parameters and the moments IN PLACE (``torch._foreach_*`` ops, one
launch per op for the whole list) and returns the same objects, so a step
allocates no second copy of the parameters or the state. The arithmetic is
``ccv_tpu``'s, in its order: coupled L2 ``decay`` (or decoupled for AdamW),
``scale``, optional AMSGrad, bias corrections ``1 - beta**step`` in
float32, ``upd = (m / b1t) / (sqrt(v / b2t) + eps)``. ``torch.optim.Adam``
rounds and keeps its state otherwise, so it is not used.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List

import numpy as np
import torch


def leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict/list/tuple, dict keys in sorted order
    (the order of ``jax.tree_util.tree_leaves``)."""
    if isinstance(tree, dict):
        return [t for key in sorted(tree) for t in leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [t for sub in tree for t in leaves(sub)]
    return [tree]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[..., tuple]
    hyper: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class AdamState:
    step: int
    m: List[torch.Tensor]     # one per leaf of params, in leaves() order
    v: List[torch.Tensor]
    vmax: List[torch.Tensor]  # amsgrad slot (zeros when unused)


def _adam_family(rate, scale, decay, beta1, beta2, epsilon, amsgrad,
                 decoupled: bool, kind: str) -> Optimizer:
    base_rate = rate

    def init(params) -> AdamState:
        ps = leaves(params)
        return AdamState(0, [torch.zeros_like(p) for p in ps],
                         [torch.zeros_like(p) for p in ps],
                         [torch.zeros_like(p) for p in ps])

    @torch.no_grad()
    def update(grads, state: AdamState, params, rate=None):
        rate = base_rate if rate is None else rate
        ps, gs = leaves(params), leaves(grads)
        state.step += 1
        step = np.float32(state.step)
        b1t = float(np.float32(1.0) - np.float32(beta1) ** step)
        b2t = float(np.float32(1.0) - np.float32(beta2) ** step)
        # ge = scale * g (+ decay * p); the grads are not written
        ge = gs if scale == 1.0 else torch._foreach_mul(gs, scale)
        if not decoupled and decay:
            ge = torch._foreach_add(ge, ps, alpha=decay)
        # m = beta1 * m + (1 - beta1) * ge; v = beta2 * v + (1 - beta2)*ge*ge
        torch._foreach_mul_(state.m, beta1)
        torch._foreach_add_(state.m, ge, alpha=1 - beta1)
        torch._foreach_mul_(state.v, beta2)
        torch._foreach_addcmul_(state.v, ge, ge, value=1 - beta2)
        vhat = torch._foreach_div(state.v, b2t)
        if amsgrad:
            torch._foreach_maximum_(state.vmax, vhat)
            vhat = state.vmax
        denom = torch._foreach_sqrt(vhat)
        torch._foreach_add_(denom, epsilon)
        # upd = (m / b1t) / denom (+ decay * p); p = p - rate * upd
        upd = torch._foreach_div(state.m, b1t)
        torch._foreach_div_(upd, denom)
        if decoupled:
            torch._foreach_add_(upd, ps, alpha=decay)
        torch._foreach_add_(ps, upd, alpha=-rate)
        return params, state

    return Optimizer(init, update, dict(kind=kind, rate=rate, scale=scale,
                                        decay=decay, beta1=beta1, beta2=beta2,
                                        epsilon=epsilon, amsgrad=amsgrad))


def adam(rate: float = 0.001, scale: float = 1.0, decay: float = 0.0,
         beta1: float = 0.9, beta2: float = 0.999, epsilon: float = 1e-8,
         amsgrad: bool = False) -> Optimizer:
    return _adam_family(rate, scale, decay, beta1, beta2, epsilon, amsgrad,
                        decoupled=False, kind="adam")


def adamw(rate: float = 0.001, scale: float = 1.0, decay: float = 0.01,
          beta1: float = 0.9, beta2: float = 0.999, epsilon: float = 1e-8,
          amsgrad: bool = False) -> Optimizer:
    return _adam_family(rate, scale, decay, beta1, beta2, epsilon, amsgrad,
                        decoupled=True, kind="adamw")
