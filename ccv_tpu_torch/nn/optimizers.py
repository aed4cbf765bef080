"""Optimizers of the port (counterpart of ccv_tpu/nn/optimizers.py): the
tree optimizers ``sgd`` (momentum, dampening, Nesterov), ``adam``,
``adamw``, ``lamb`` and ``rmsprop``, ``clip_grad_norm`` and
``grads_isnan``, and the per-tensor update commands (``sgd_step``,
``adam_step``, ``adamw_step``, ``lamb_step``, ``rmsprop_step``: pure
functions, the cpu_ref kernels' formulas in ``ccv_tpu``'s order) that
``nn/cmd.py`` registers.

The interface mirrors ``ccv_tpu``'s: ``opt.init(params) -> state`` and
``opt.update(grads, state, params) -> (params, state)``, over nested
dicts and lists of tensors. Unlike JAX's pure functions, ``update`` changes
the parameters and the state IN PLACE (``torch._foreach_*`` ops, one
launch per op for the whole list) and returns the same objects, so a step
allocates no second copy of the parameters or the state. The arithmetic is
``ccv_tpu``'s, in its order: coupled L2 ``decay`` (or decoupled for AdamW),
``scale``, optional AMSGrad, bias corrections ``1 - beta**step`` in
float32, ``upd = (m / b1t) / (sqrt(v / b2t) + eps)``. ``torch.optim``
rounds and keeps its state otherwise, so it is not used.

A state keeps one tensor per parameter leaf, in ``leaves()`` order.
``state_leaves`` lists a state's tensors in ``jax.tree_util``'s order of
the matching ``ccv_tpu`` state (``AdamState``: step, m, v, vmax; sgd: the
momenta; rmsprop: the accumulators, then the momenta), which is the order
of a checkpoint's ``[opt:i]`` rows; ``opt_state_from_jax`` carries a
``ccv_tpu`` state across.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence

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


def tree_zip(fn: Callable, a, b):
    """``fn(x, y)`` on every leaf x of ``a`` and the leaf y at the same place
    in ``b`` (``b``'s leaves may themselves be tuples), ``a``'s structure
    kept."""
    if isinstance(a, dict):
        return {k: tree_zip(fn, a[k], b[k]) for k in a}
    if isinstance(a, (list, tuple)):
        return type(a)(tree_zip(fn, x, y) for x, y in zip(a, b))
    return fn(a, b)


def tree_map(fn: Callable, tree):
    """``fn`` on every tensor of a nested dict/list/tuple, the structure
    kept."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[..., tuple]
    hyper: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class AdamState:
    """adam, adamw and lamb (lamb leaves ``vmax`` at zeros)."""
    step: int
    m: List[torch.Tensor]     # one per leaf of params, in leaves() order
    v: List[torch.Tensor]
    vmax: List[torch.Tensor]  # amsgrad slot (zeros when unused)


@dataclasses.dataclass
class SgdState:
    m: List[torch.Tensor]     # the momenta, in leaves() order


@dataclasses.dataclass
class RmspropState:
    v: List[torch.Tensor]     # the squared-gradient accumulators
    mom: List[torch.Tensor]   # the momenta


def _zeros(params) -> List[torch.Tensor]:
    return [torch.zeros_like(p) for p in leaves(params)]


def _bias_corrections(step: int, beta1: float, beta2: float):
    """``1 - beta ** step`` for both betas, in float32 as ``ccv_tpu``."""
    t = np.float32(step)
    return (float(np.float32(1.0) - np.float32(beta1) ** t),
            float(np.float32(1.0) - np.float32(beta2) ** t))


def sgd(rate: float = 0.001, scale: float = 1.0, decay: float = 0.0,
        momentum: float = 0.9, dampening: float = 0.0,
        nesterov: bool = False) -> Optimizer:
    """m = momentum m + (1 - dampening) (scale g + decay p); p -= rate m,
    or with ``nesterov`` p -= rate (scale g + decay p + momentum m)."""
    def init(params) -> SgdState:
        return SgdState(_zeros(params))

    @torch.no_grad()
    def update(grads, state: SgdState, params):
        ps, gs = leaves(params), leaves(grads)
        gm = gs if scale == 1.0 else torch._foreach_mul(gs, scale)
        if decay:
            gm = torch._foreach_add(gm, ps, alpha=decay)
        torch._foreach_mul_(state.m, momentum)
        torch._foreach_add_(state.m, gm, alpha=1.0 - dampening)
        step = state.m
        if nesterov:
            step = torch._foreach_add(gm, state.m, alpha=momentum)
        torch._foreach_add_(ps, step, alpha=-rate)
        return params, state

    return Optimizer(init, update, dict(kind="sgd", rate=rate, scale=scale,
                                        decay=decay, momentum=momentum,
                                        dampening=dampening,
                                        nesterov=nesterov))


def _adam_family(rate, scale, decay, beta1, beta2, epsilon, amsgrad,
                 decoupled: bool, kind: str) -> Optimizer:
    base_rate = rate

    def init(params) -> AdamState:
        return AdamState(0, _zeros(params), _zeros(params), _zeros(params))

    @torch.no_grad()
    def update(grads, state: AdamState, params, rate=None):
        rate = base_rate if rate is None else rate
        ps, gs = leaves(params), leaves(grads)
        state.step += 1
        b1t, b2t = _bias_corrections(state.step, beta1, beta2)
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


def lamb(rate: float = 0.001, scale: float = 1.0, decay: float = 0.0,
         beta1: float = 0.9, beta2: float = 0.999,
         epsilon: float = 1e-6) -> Optimizer:
    """Adam's moments; each tensor's update u = (m / b1t) / (sqrt(v / b2t)
    + eps) + decay p is scaled by the trust ratio |p| / |u| (1 where either
    norm is 0)."""
    def init(params) -> AdamState:
        return AdamState(0, _zeros(params), _zeros(params), _zeros(params))

    @torch.no_grad()
    def update(grads, state: AdamState, params):
        ps, gs = leaves(params), leaves(grads)
        state.step += 1
        b1t, b2t = _bias_corrections(state.step, beta1, beta2)
        torch._foreach_mul_(state.m, beta1)
        torch._foreach_add_(state.m, gs, alpha=(1 - beta1) * scale)
        sg = gs if scale == 1.0 else torch._foreach_mul(gs, scale)
        torch._foreach_mul_(state.v, beta2)
        torch._foreach_addcmul_(state.v, sg, sg, value=1 - beta2)
        denom = torch._foreach_sqrt(torch._foreach_div(state.v, b2t))
        torch._foreach_add_(denom, epsilon)
        upd = torch._foreach_div(state.m, b1t)
        torch._foreach_div_(upd, denom)
        if decay:
            torch._foreach_add_(upd, ps, alpha=decay)
        for p, u in zip(ps, upd):
            w_norm = torch.sqrt((p.float() ** 2).sum())
            u_norm = torch.sqrt((u ** 2).sum())
            trust = torch.where((w_norm > 0) & (u_norm > 0), w_norm / u_norm,
                                torch.ones_like(w_norm))
            p.sub_((rate * trust * u).to(p.dtype))
        return params, state

    return Optimizer(init, update, dict(kind="lamb", rate=rate, scale=scale,
                                        decay=decay, beta1=beta1, beta2=beta2,
                                        epsilon=epsilon))


def rmsprop(rate: float = 0.001, scale: float = 1.0, decay: float = 0.0,
            alpha: float = 0.99, momentum: float = 0.9,
            epsilon: float = 1e-8) -> Optimizer:
    """e = scale g + decay p; v = alpha v + (1 - alpha) e^2; mom = momentum
    mom + e / (sqrt(v) + eps); p -= rate mom."""
    def init(params) -> RmspropState:
        return RmspropState(_zeros(params), _zeros(params))

    @torch.no_grad()
    def update(grads, state: RmspropState, params):
        ps, gs = leaves(params), leaves(grads)
        e = gs if scale == 1.0 else torch._foreach_mul(gs, scale)
        if decay:
            e = torch._foreach_add(e, ps, alpha=decay)
        torch._foreach_mul_(state.v, alpha)
        torch._foreach_addcmul_(state.v, e, e, value=1 - alpha)
        denom = torch._foreach_sqrt(state.v)
        torch._foreach_add_(denom, epsilon)
        torch._foreach_mul_(state.mom, momentum)
        torch._foreach_addcdiv_(state.mom, e, denom)
        torch._foreach_add_(ps, state.mom, alpha=-rate)
        return params, state

    return Optimizer(init, update, dict(kind="rmsprop", rate=rate,
                                        scale=scale, decay=decay, alpha=alpha,
                                        momentum=momentum, epsilon=epsilon))


def clip_grad_norm(grads, max_norm: float):
    """ccv_cnnp_model_parameters_clip_grad_norm twin (ccv_nnc.h:4149):
    (grads times min(1, max_norm / max(total, 1e-12)), total), where total
    is the float32 2-norm over every leaf. Stays on the grads' device (no
    host read)."""
    gs = leaves(grads)
    total = torch.sqrt(sum((g.float() ** 2).sum() for g in gs))
    factor = torch.clamp(max_norm / torch.clamp(total, min=1e-12), max=1.0)
    return tree_map(lambda g: g * factor.to(g.dtype), grads), total


def grads_isnan(grads) -> torch.Tensor:
    """ccv_cnnp_model_parameter_gradients_isnan twin (ccv_nnc.h:4169): a
    0-dim bool tensor, true where any gradient holds a NaN."""
    return torch.stack([torch.isnan(g).any() for g in leaves(grads)]).any()


# ---------------------------------------------------------------------------
# states as leaves: checkpoints and ccv_tpu's states
# ---------------------------------------------------------------------------

def _slots(state) -> list:
    """The per-parameter lists of a state, in ``ccv_tpu``'s leaf order."""
    if isinstance(state, AdamState):
        return [state.m, state.v, state.vmax]
    if isinstance(state, SgdState):
        return [state.m]
    if isinstance(state, RmspropState):
        return [state.v, state.mom]
    raise TypeError(f"not an optimizer state: {type(state).__name__}")


def state_leaves(state, perm: Optional[Sequence[int]] = None
                 ) -> List[torch.Tensor]:
    """A state's tensors in ``jax.tree_util.tree_leaves`` order of the
    matching ``ccv_tpu`` state; ``AdamState.step`` as a 0-dim int32
    tensor on the CPU. ``perm`` reorders every per-parameter list: place
    j holds the slot's leaf ``perm[j]``."""
    head = ([torch.tensor(state.step, dtype=torch.int32)]
            if isinstance(state, AdamState) else [])
    return head + [slot[i] for slot in _slots(state)
                   for i in (range(len(slot)) if perm is None else perm)]


def load_state_leaves(state, tensors: Sequence,
                      perm: Optional[Sequence[int]] = None) -> None:
    """Fill ``state`` (from ``opt.init``) in place from ``tensors`` in
    ``state_leaves`` order, each cast and reshaped to its slot. ``perm``
    reorders every per-parameter list: slot i takes leaf ``perm[i]`` of
    the source's list (for a source whose parameters lie in another
    order)."""
    tensors = list(tensors)
    if isinstance(state, AdamState):
        state.step = int(torch.as_tensor(tensors.pop(0)).reshape(()))
    slots = _slots(state)
    n = len(slots[0])
    if len(tensors) != n * len(slots):
        raise ValueError(f"{len(tensors)} leaves for a state of "
                         f"{len(slots)} x {n}")
    order = range(n) if perm is None else perm
    for k, slot in enumerate(slots):
        src = tensors[k * n:(k + 1) * n]
        for i, j in enumerate(order):
            old = slot[i]
            slot[i] = torch.as_tensor(src[j]).to(
                old.device, old.dtype).reshape(old.shape).clone()


def opt_state_from_jax(jax_state, like,
                       perm: Optional[Sequence[int]] = None):
    """``like`` (the port's state of the same optimizer, from ``init`` of
    the parameters on their device) filled from a ``ccv_tpu`` optimizer
    state (numpy or JAX arrays). ``perm`` as ``load_state_leaves``
    (``functional.leaf_order`` gives it for graph models)."""
    from ccv_tpu_torch.nn.model import _tensor

    load_state_leaves(like, [_tensor(leaf, torch.device("cpu"))
                             for leaf in leaves(jax_state)], perm)
    return like


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
