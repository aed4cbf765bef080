"""Dynamic (eager) graph with a backward tape (counterpart of
ccv_tpu/nn/dynamic.py; reference: lib/nnc/ccv_nnc_dynamic_graph.c and
ccv_nnc_dynamic_graph_backward.c).

Ops run eagerly on the variables' values (under ``torch.no_grad``: the
tape, not autograd, records them) while the tape keeps (fn, input
variables, output variables). ``backward`` replays the slice of the tape
downstream of the wrt variables as a function of them, under autograd, and
takes the vector-Jacobian product with ``torch.autograd.grad``, as
``ccv_tpu`` replays it under ``jax.vjp``.

    g = DynamicGraph(device="cpu")
    x = g.variable(np.ones((2, 2), np.float32))
    w = g.variable(init)
    y = g.exec(lambda a, b: a @ b, x, w)
    loss = g.exec(lambda v: (v * v).sum(), y)
    (dw,) = g.backward(loss, (w,))
    g.minimize(loss, optimizers.sgd(0.1), (w,))   # backward + update

A variable made from an array lives on the graph's ``device`` (default:
the card; raises without one); one made from a tensor keeps its device.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ccv_tpu_torch import device as _device


class Var:
    """ccv_nnc_tensor_variable_t twin: a tracked eager value."""

    __slots__ = ("value", "uid", "constant")
    _counter = [0]

    def __init__(self, value: torch.Tensor, constant: bool = False):
        self.value = value
        self.constant = constant
        Var._counter[0] += 1
        self.uid = Var._counter[0]

    @property
    def shape(self):
        return tuple(self.value.shape)

    def numpy(self) -> np.ndarray:
        return self.value.detach().cpu().numpy()

    def __repr__(self):
        kind = "const" if self.constant else "var"
        return f"<{kind} {self.uid} {self.shape}>"


def _multi(out) -> bool:
    return isinstance(out, (tuple, list))


class DynamicGraph:
    """ccv_nnc_dynamic_graph_new twin."""

    def __init__(self, device: _device.DeviceLike = None):
        self._device = device
        # tape entries: (fn, input Vars, output Vars)
        self._tape: List[Tuple[Callable, Tuple[Var, ...], Tuple[Var, ...]]] \
            = []
        self._no_grad = False

    # -- variables -------------------------------------------------------
    def _value(self, value) -> torch.Tensor:
        """A copy of ``value`` (``minimize`` updates it in place)."""
        if isinstance(value, torch.Tensor):
            return value.detach().clone()
        return _device.to_device(np.array(value),
                                 _device.resolve(self._device))

    def variable(self, value) -> Var:
        """ccv_nnc_tensor_variable_new + set: a tracked leaf (a copy)."""
        return Var(self._value(value))

    def constant(self, value) -> Var:
        """ccv_nnc_tensor_constant_new: never differentiated through."""
        return Var(self._value(value), constant=True)

    # -- eager execution ---------------------------------------------------
    def exec(self, fn: Callable, *inputs: Var):
        """ccv_nnc_dynamic_graph_exec twin: run ``fn`` on the variables'
        values now and record it on the tape (unless in ``no_grad``)."""
        with torch.no_grad():
            out = fn(*(v.value for v in inputs))
        outs = tuple(Var(o) for o in (out if _multi(out) else (out,)))
        if not self._no_grad:
            self._tape.append((fn, tuple(inputs), outs))
        return outs if _multi(out) else outs[0]

    @contextlib.contextmanager
    def no_grad(self):
        """Execution that the tape does not record (the reference's no-grad
        exec mode)."""
        prev = self._no_grad
        self._no_grad = True
        try:
            yield
        finally:
            self._no_grad = prev

    # -- backward ----------------------------------------------------------
    def backward(self, output: Var, wrt: Sequence[Var],
                 dy: Optional[Any] = None) -> Tuple[torch.Tensor, ...]:
        """ccv_nnc_dynamic_graph_backward twin: d output / d wrt (times
        ``dy``, default ones), by replaying the ops of the tape downstream
        of the wrt variables under autograd; other leaves and constants
        enter as they are. A wrt variable the output does not reach gets
        zeros."""
        env = {v.uid: v.value.detach().requires_grad_() for v in wrt}
        leaves = [env[v.uid] for v in wrt]
        with torch.enable_grad():
            for fn, ins, outs in self._tape:
                # recompute only ops downstream of a wrt variable
                if not any(i.uid in env for i in ins):
                    continue
                out = fn(*(env.get(i.uid, i.value) for i in ins))
                for o, val in zip(outs, out if _multi(out) else (out,)):
                    env[o.uid] = val
            if output.uid not in env:
                raise ValueError("the output does not depend on the wrt "
                                 "variables")
            y = env[output.uid]
            seed = torch.ones_like(y) if dy is None else torch.as_tensor(
                dy, dtype=y.dtype, device=y.device)
            grads = torch.autograd.grad(y, leaves, seed, allow_unused=True)
        return tuple(torch.zeros_like(v) if g is None else g
                     for v, g in zip(leaves, grads))

    def minimize(self, loss: Var, optimizer, wrt: Sequence[Var],
                 opt_state=None):
        """ccv_nnc_dynamic_graph_minimize twin: ``backward``, then the
        optimizer's update of the variables' values (in place; an
        optimizer of ``nn/optimizers.py``). Returns the optimizer state
        to pass to the next call."""
        grads = self.backward(loss, wrt)
        params = [v.value for v in wrt]
        if opt_state is None:
            opt_state = optimizer.init(params)
        params, opt_state = optimizer.update(list(grads), opt_state, params)
        for v, p in zip(wrt, params):
            v.value = p
        return opt_state

    def reset_tape(self):
        """Drop the recorded ops (the tape's garbage collection)."""
        self._tape.clear()

    def dot(self) -> str:
        """ccv_nnc_dynamic_graph_dot twin."""
        lines = ["digraph tape {"]
        for i, (fn, ins, outs) in enumerate(self._tape):
            name = getattr(fn, "__name__", "op")
            lines.append(f'  op{i} [label="{name}"];')
            for v in ins:
                lines.append(f"  v{v.uid} -> op{i};")
            for v in outs:
                lines.append(f"  op{i} -> v{v.uid};")
        lines.append("}")
        return "\n".join(lines)
