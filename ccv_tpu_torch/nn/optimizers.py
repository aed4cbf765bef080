"""Optimizers of the port (counterpart of ccv_tpu/nn/optimizers.py): Adam
and AdamW through ``_adam_family``, and the per-tensor update commands
(``sgd_step``, ``adam_step``, ``adamw_step``, ``lamb_step``,
``rmsprop_step``: pure functions, the cpu_ref kernels' formulas in
``ccv_tpu``'s order) that ``nn/cmd.py`` registers.

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


# ---------------------------------------------------------------------------
# per-tensor update commands (cmd/sgd, cmd/adam, cmd/lamb, cmd/rmsprop)
# ---------------------------------------------------------------------------

def sgd_step(grad, x, mom, rate=0.001, scale=1.0, decay=0.0, momentum=0.9,
             dampening=0.0, nesterov=False):
    """CCV_NNC_SGD_FORWARD (cmd/sgd/ccv_nnc_sgd_cpu_ref.c:79-114): (grad,
    x, momentum) -> (new x, new momentum)."""
    if nesterov:
        if dampening != 0:
            raise ValueError("nesterov needs dampening 0")
        g = scale * grad
        m = momentum * mom + g + decay * x
        return x - rate * (g + momentum * m), m
    m = momentum * mom + (1.0 - dampening) * (scale * grad + decay * x)
    return x - rate * m, m


def adam_step(grad, x, m, v, step, rate=0.001, scale=1.0, beta1=0.9,
              beta2=0.999, decay=0.0, epsilon=1e-8):
    """CCV_NNC_ADAM_FORWARD (cmd/adam/ccv_nnc_adam_cpu_ref.c:112-122):
    (grad, x, m, v) and the 1-based step -> (new x, new m, new v)."""
    g = scale * grad + decay * x
    m2 = beta1 * m + (1.0 - beta1) * g
    v2 = beta2 * v + (1.0 - beta2) * g * g
    inv_b1 = 1.0 / (1.0 - beta1 ** step)
    inv_b2 = 1.0 / (1.0 - beta2 ** step)
    return (x - (m2 * rate * inv_b1) / (torch.sqrt(v2 * inv_b2) + epsilon),
            m2, v2)


def adamw_step(grad, x, m, v, step, rate=0.001, scale=1.0, beta1=0.9,
               beta2=0.999, decay=0.01, epsilon=1e-8):
    """CCV_NNC_ADAMW_FORWARD (cmd/adam/ccv_nnc_adamw_cpu_ref.c:157-160):
    the decay is decoupled from the moments."""
    g = scale * grad
    m2 = beta1 * m + (1.0 - beta1) * g
    v2 = beta2 * v + (1.0 - beta2) * g * g
    inv_b1 = 1.0 / (1.0 - beta1 ** step)
    inv_b2 = 1.0 / (1.0 - beta2 ** step)
    return (x - rate * decay * x
            - (m2 * rate * inv_b1) / (torch.sqrt(v2 * inv_b2) + epsilon),
            m2, v2)


def lamb_step(grad, x, m, v, step, rate=0.001, scale=1.0, beta1=0.9,
              beta2=0.999, decay=0.0, epsilon=1e-6):
    """CCV_NNC_LAMB_FORWARD (cmd/lamb/ccv_nnc_lamb_cpu_ref.c:96-130): the
    Adam-style update scaled by the trust ratio |x| / |update|."""
    g = scale * grad
    m2 = beta1 * m + (1.0 - beta1) * g
    v2 = beta2 * v + (1.0 - beta2) * g * g
    inv_b1 = 1.0 / (1.0 - beta1 ** step)
    inv_b2 = 1.0 / (1.0 - beta2 ** step)
    update = (m2 * inv_b1) / (torch.sqrt(v2 * inv_b2) + epsilon) + decay * x
    w_norm = torch.sqrt((x.float() ** 2).sum())
    u_norm = torch.sqrt((update.float() ** 2).sum())
    trust = torch.where((w_norm > 0) & (u_norm > 0), w_norm / u_norm,
                        torch.ones_like(w_norm))
    return x - rate * trust * update, m2, v2


def rmsprop_step(grad, x, mom, v, rate=0.001, scale=1.0, decay=0.0,
                 alpha=0.99, momentum=0.9, epsilon=1e-8):
    """CCV_NNC_RMSPROP_FORWARD (cmd/rmsprop/ccv_nnc_rmsprop_cpu_ref.c:90-94):
    (grad, x, momentum, velocity) -> (new x, new momentum, new velocity)."""
    g = scale * grad + decay * x
    v2 = alpha * v + (1.0 - alpha) * g * g
    m2 = momentum * mom + g / (torch.sqrt(v2) + epsilon)
    return x - rate * m2, m2, v2
