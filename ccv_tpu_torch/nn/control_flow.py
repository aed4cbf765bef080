"""User-level control flow (counterpart of ccv_tpu/nn/control_flow.py;
reference: lib/nnc/ccv_nnc_symbolic_graph_while.c,
ccv_nnc_symbolic_graph_case_of.c, ccv_nnc_dynamic_graph_while.c).

PyTorch runs eagerly, so the loop and the branch are Python on the host
over tensors on their own device: ``cond`` and the branch index are read
back once a step (``ccv_tpu`` traces them into ``lax.while_loop`` /
``lax.scan`` / ``lax.switch``). Both are differentiable through autograd,
the bounded and the unbounded loop alike.

- ``while_loop(cond, body, init, max_iter=None)``: ``body`` maps the carry
  (a tensor, or a tuple, list or dict of them) to the next while
  ``cond(carry)`` holds; with ``max_iter``, at most that many steps (the
  result of ``ccv_tpu``'s masked scan of that length).
- ``case_of(index, branches, *operands)``: ``branches[index](*operands)``,
  the index clamped into range as ``lax.switch`` clamps it.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence


def while_loop(cond: Callable[[Any], Any], body: Callable[[Any], Any],
               init: Any, max_iter: Optional[int] = None) -> Any:
    """ccv_nnc_symbolic_graph_while twin."""
    carry, steps = init, 0
    while (max_iter is None or steps < max_iter) and bool(cond(carry)):
        carry = body(carry)
        steps += 1
    return carry


def case_of(index, branches: Sequence[Callable], *operands) -> Any:
    """ccv_nnc_symbolic_graph_case_of twin."""
    i = min(max(int(index), 0), len(branches) - 1)
    return branches[i](*operands)
