"""The functional CNNP model API of the port (counterpart of
ccv_tpu/nn/functional.py; reference: lib/nnc/ccv_cnnp_model_core.c).

Layers called on symbolic nodes record a DAG, which supports fan-out and
fan-in (residual and branching topologies that ``Sequential`` cannot say):

    x = Input()
    h = Convolution(64, (3, 3))(x)
    h = ReLU()(h)
    h = Convolution(64, (3, 3))(h)
    y = Add()(h, x)          # residual
    model = Model([x], [y])
    model.build((1, 32, 32, 64), device="cuda")
    out = model.evaluate(x_tensor)

``Model`` has ``Sequential``'s lifecycle: ``build`` (shape inference and
initialisation on a device), ``__call__``, ``evaluate`` (under
``torch.no_grad``, on the input's device), parameter access, ``dot``, and
``write`` / ``read`` onto ``ccv_tpu``'s checkpoint rows
``__<model>__/<topological index>/<layer name>/<param>``, so a checkpoint
written by either package reads into the other. ``params_from_jax`` copies
a built ``ccv_tpu`` graph model's parameters by topological position. The
training half (``compile``, ``fit``, ``backward``, ``apply_gradients``,
``cancel``, gradient checkpointing, memory compression and reduction,
``checkpoint`` / ``resume``) is ``model.Trainable``'s, as ``ccv_tpu``
binds ``Sequential``'s methods onto ``Model``; ``ccv_tpu``'s ``Model``
takes no memory compression or reduction and writes no trainer
checkpoint, the port's does both.

Nodes are numbered by a process-wide counter, as in ``ccv_tpu``; a built
model keys its parameters by ``str(node.uid)``, so the same topology built
twice has other keys, and positions (``Model.order``, the same depth-first
walk as ``ccv_tpu``'s ``topsort``) are what carry across.
"""

from __future__ import annotations

import copy
import math
import sqlite3
from typing import Any, Dict, List, Optional, Sequence

import torch

from ccv_tpu_torch import device as _device
from ccv_tpu_torch.nn import ops
from ccv_tpu_torch.nn.layers import Layer
from ccv_tpu_torch.nn.model import Trainable, _tensor


class Node:
    """A symbolic tensor: a layer applied to other nodes (or an input)."""

    _counter = [0]

    def __init__(self, layer: Optional[Layer], inputs: Sequence["Node"]):
        self.layer = layer
        self.inputs = list(inputs)
        Node._counter[0] += 1
        self.uid = Node._counter[0]

    def __repr__(self):
        lname = self.layer.name if self.layer else "input"
        return f"<Node {self.uid} {lname}>"


class Input(Node):
    """ccv_cnnp_input twin: a free input symbol."""

    def __init__(self, shape: Optional[Sequence[int]] = None):
        super().__init__(None, [])
        self.shape = tuple(shape) if shape is not None else None


def topsort(outputs: Sequence[Node]) -> List[Node]:
    """Depth-first, inputs before their node, outputs visited in order
    (``ccv_tpu``'s order, which checkpoint rows and weight transfer key
    on)."""
    order: List[Node] = []
    seen = set()

    def visit(n: Node):
        if n.uid in seen:
            return
        seen.add(n.uid)
        for p in n.inputs:
            visit(p)
        order.append(n)

    for o in outputs:
        visit(o)
    return order


# ---------------------------------------------------------------------------
# multi-input and structural layers (ccv_cnnp_model_addons.c)
# ---------------------------------------------------------------------------

class Add(Layer):
    """ccv_cnnp_sum / add twin: elementwise sum of all inputs."""

    n_inputs = "many"

    def __init__(self, name: str = "add"):
        self.name = name

    def init(self, generator, in_shapes):
        return {}, {}, in_shapes[0]

    def apply(self, params, state, xs, training=False, generator=None):
        y = xs[0]
        for x in xs[1:]:
            y = y + x
        return y, state


class Mul(Layer):
    """ccv_cnnp_mul twin: elementwise product times p."""

    n_inputs = "many"

    def __init__(self, p: float = 1.0, name: str = "mul"):
        self.p = p
        self.name = name

    def init(self, generator, in_shapes):
        return {}, {}, in_shapes[0]

    def apply(self, params, state, xs, training=False, generator=None):
        y = xs[0]
        for x in xs[1:]:
            y = y * x
        return y * self.p, state


class Concat(Layer):
    """ccv_cnnp_concat twin: concatenate along ``axis``."""

    n_inputs = "many"

    def __init__(self, axis: int = -1, name: str = "concat"):
        self.axis = axis
        self.name = name

    def init(self, generator, in_shapes):
        axis = self.axis % len(in_shapes[0])
        out = list(in_shapes[0])
        out[axis] = sum(s[axis] for s in in_shapes)
        return {}, {}, tuple(out)

    def apply(self, params, state, xs, training=False, generator=None):
        return torch.cat(list(xs), dim=self.axis), state


class Chunk(Layer):
    """ccv_cnnp_chunk twin: ``n`` equal parts along ``axis``, a multi-output
    node (``Pick`` / ``Extract`` select one)."""

    def __init__(self, n: int, axis: int = -1, name: str = "chunk"):
        self.n = n
        self.axis = axis
        self.name = name
        self.n_outputs = n

    def init(self, generator, in_shape):
        axis = self.axis % len(in_shape)
        if in_shape[axis] % self.n:
            raise ValueError(f"{in_shape[axis]} does not split into {self.n}")
        out = list(in_shape)
        out[axis] = in_shape[axis] // self.n
        return {}, {}, tuple(tuple(out) for _ in range(self.n))

    def apply(self, params, state, x, training=False, generator=None):
        return tuple(torch.chunk(x, self.n, dim=self.axis)), state


class Pick(Layer):
    """One output of a multi-output node."""

    def __init__(self, index: int, name: str = "pick"):
        self.index = index
        self.name = name

    def init(self, generator, in_shape):
        return {}, {}, in_shape[self.index]

    def apply(self, params, state, x, training=False, generator=None):
        return x[self.index], state


class Reduce(Layer):
    """ccv_cnnp_reduce_{sum,mean,max,min,norm2} twins."""

    def __init__(self, op: str, axis, keepdims: bool = False,
                 name: str = "reduce"):
        if op not in ("sum", "mean", "max", "min", "norm2"):
            raise ValueError(f"reduce {op!r}")
        self.op = op
        self.axis = tuple(axis) if isinstance(axis, (list, tuple)) else (axis,)
        self.keepdims = keepdims
        self.name = f"{name}_{op}"

    def init(self, generator, in_shape):
        axes = {a % len(in_shape) for a in self.axis}
        out = []
        for i, s in enumerate(in_shape):
            if i not in axes:
                out.append(s)
            elif self.keepdims:
                out.append(1)
        return {}, {}, tuple(out)

    def apply(self, params, state, x, training=False, generator=None):
        fn = {"sum": ops.reduce_sum, "mean": ops.reduce_mean,
              "max": ops.reduce_max, "min": ops.reduce_min,
              "norm2": ops.reduce_norm2}[self.op]
        return fn(x, self.axis, self.keepdims), state


class GRU(Layer):
    """ccv_cnnp_gru-style gated recurrent unit over (B, T, D): reset, update
    and candidate gates; returns the hidden sequence (B, T, H). Weights
    uniform in +-1/sqrt(H), biases 0. The step runs in float32 (x's type
    against float32 weights, as ``ccv_tpu`` promotes)."""

    def __init__(self, hidden: int, name: str = "gru"):
        self.hidden = hidden
        self.name = name

    def init(self, generator, in_shape):
        B, T, D = in_shape
        H = self.hidden
        lim = 1.0 / math.sqrt(H)

        def uniform(shape):
            return torch.rand(shape, generator=generator) * (2 * lim) - lim

        params = {"wx": uniform((D, 3 * H)), "wh": uniform((H, 3 * H)),
                  "b": torch.zeros(3 * H)}
        return params, {}, (B, T, H)

    def apply(self, params, state, x, training=False, generator=None):
        H = self.hidden
        wh = params["wh"].float()
        xproj = torch.matmul(x.float(), params["wx"].float()) + params["b"]
        h = torch.zeros((x.shape[0], H), dtype=torch.float32, device=x.device)
        ys = []
        for t in range(x.shape[1]):
            xp = xproj[:, t]
            hp = torch.matmul(h, wh)
            r = torch.sigmoid(xp[..., :H] + hp[..., :H])
            z = torch.sigmoid(xp[..., H:2 * H] + hp[..., H:2 * H])
            n = torch.tanh(xp[..., 2 * H:] + r * hp[..., 2 * H:])
            h = (1 - z) * n + z * h
            ys.append(h)
        return torch.stack(ys, dim=1), state


class IndexSelect(Layer):
    """ccv_cnnp_index_select twin: rows of x at the integer indices y."""

    n_inputs = "many"

    def __init__(self, name: str = "index_select"):
        self.name = name

    def init(self, generator, in_shapes):
        x_shape, idx_shape = in_shapes
        return {}, {}, tuple(idx_shape) + tuple(x_shape[1:])

    def apply(self, params, state, xs, training=False, generator=None):
        x, idx = xs
        return ops.index_select(x, idx, 0), state


# ---------------------------------------------------------------------------
# the graph model
# ---------------------------------------------------------------------------

def _arg(node: Node, values: list):
    """A list for a many-input layer, else its one input."""
    return values if getattr(node.layer, "n_inputs", 1) == "many" \
        else values[0]


class Model(Trainable):
    """ccv_cnnp_model_new twin: a DAG of layers from inputs to outputs."""

    def __init__(self, inputs: Sequence[Input], outputs: Sequence[Node],
                 name: str = "model"):
        self.inputs = list(inputs)
        self.outputs = list(outputs)
        self.name = name
        self.order = [n for n in topsort(self.outputs) if n.layer is not None]
        self.params: Any = None
        self.state: Any = None
        self.shapes: Dict[int, Any] = {}
        self.output_shape = None
        self._init_training()

    # -- build -------------------------------------------------------------
    def build(self, input_shapes, generator: Optional[torch.Generator] = None,
              device: _device.DeviceLike = None):
        """Shape-infer the DAG and initialise the parameters on ``device``
        (default: the card; raises without one). Draws come from
        ``generator`` (default: seed 0) on the CPU, node by node in
        topological order. ``shapes`` keeps every node's output shape."""
        device = _device.resolve(device)
        if input_shapes and not isinstance(input_shapes[0], (tuple, list)):
            input_shapes = [input_shapes]
        if len(input_shapes) != len(self.inputs):
            raise ValueError(f"{len(input_shapes)} input shapes for "
                             f"{len(self.inputs)} inputs")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        shapes: Dict[int, Any] = {}
        for node, s in zip(self.inputs, input_shapes):
            shapes[node.uid] = tuple(s)
        params, states = {}, {}
        for node in self.order:
            arg = _arg(node, [shapes[p.uid] for p in node.inputs])
            p, s, out = node.layer.init(generator, arg)
            params[str(node.uid)] = {k: v.to(device) for k, v in p.items()}
            states[str(node.uid)] = {k: v.to(device) for k, v in s.items()}
            shapes[node.uid] = out
        self.params, self.state, self.shapes = params, states, shapes
        self.output_shape = [shapes[o.uid] for o in self.outputs]
        return self.output_shape if len(self.output_shape) > 1 \
            else self.output_shape[0]

    def _forward(self, params, states, xs, training: bool,
                 generator: Optional[torch.Generator]):
        if not isinstance(xs, (tuple, list)):
            xs = [xs]
        vals: Dict[int, Any] = {n.uid: x for n, x in zip(self.inputs, xs)}
        new_states = {}
        for node in self.order:
            uid = str(node.uid)
            arg = _arg(node, [vals[p.uid] for p in node.inputs])
            y, ns = self._apply_layer(node.layer, params[uid], states[uid],
                                      arg, training, generator)
            new_states[uid] = ns
            vals[node.uid] = y
        outs = [vals[o.uid] for o in self.outputs]
        return (outs if len(outs) > 1 else outs[0]), new_states

    def _positions(self, tree) -> List[int]:
        """Checkpoint rows go by topological position (``positions``): the
        ``leaves()`` order sorts the keys ``str(uid)``, which differ from
        build to build."""
        return positions(self.order, tree)

    def _build_for(self, xs):
        if self.params is None:
            first = xs[0] if isinstance(xs, (tuple, list)) else xs
            shapes = [tuple(x.shape) for x in xs] \
                if isinstance(xs, (tuple, list)) else [tuple(xs.shape)]
            self.build(shapes, device=first.device)

    def __call__(self, xs, training: bool = False,
                 generator: Optional[torch.Generator] = None):
        self._build_for(xs)
        y, _ = self._forward(self.params, self.state, xs, training, generator)
        return y

    def evaluate(self, inputs):
        """The forward pass at inference (model.c:1848), on the inputs'
        device, without autograd."""
        self._build_for(inputs)
        with torch.no_grad():
            out, _ = self._forward(self.params, self.state, inputs, False,
                                   None)
        return out

    # -- parameter access (ccv_nnc.h:4039-4170) ---------------------------
    def parameters(self):
        return self.params

    def set_parameters(self, params):
        self.params = params

    def parameter_count(self) -> int:
        return sum(math.prod(v.shape) for p in self.params.values()
                   for v in p.values())

    def parameters_isnan(self) -> bool:
        return any(bool(torch.isnan(v).any()) for p in self.params.values()
                   for v in p.values())

    def dot(self) -> str:
        """ccv_cnnp_model_dot twin."""
        lines = ["digraph model {"]
        for i, node in enumerate(self.inputs):
            lines.append(f'  n{node.uid} [label="input{i}" shape=box];')
        for node in self.order:
            lines.append(f'  n{node.uid} [label="{node.layer.name}"];')
            for p in node.inputs:
                lines.append(f"  n{p.uid} -> n{node.uid};")
        lines.append("}")
        return "\n".join(lines)

    # -- checkpoint io (ccv_cnnp_model_write / read) -------------------------
    def _rows(self, name: Optional[str]):
        """(row prefix, params, state) of each node in topological order."""
        name = name or self.name
        for i, node in enumerate(self.order):
            uid = str(node.uid)
            yield (f"__{name}__/{i}/{node.layer.name}", self.params[uid],
                   self.state[uid])

    def write(self, path: str, name: Optional[str] = None):
        """One SQLite tensor row per (node, parameter) and (node, state)."""
        from ccv_tpu_torch.nn import tensor_io

        conn = tensor_io.open_db(path)
        try:
            with conn:
                for prefix, params, state in self._rows(name):
                    for k, v in params.items():
                        tensor_io.tensor_write(conn, f"{prefix}/{k}", v)
                    for k, v in state.items():
                        tensor_io.tensor_write(conn, f"{prefix}/state/{k}", v)
        finally:
            conn.close()

    def read(self, path: str, name: Optional[str] = None):
        """Every parameter of the built model from its row (reshaped, on its
        device); a missing parameter row raises KeyError, a missing state
        row keeps the state."""
        from ccv_tpu_torch.nn import tensor_io

        conn = sqlite3.connect(path)
        try:
            for prefix, params, state in self._rows(name):
                for k, old in list(params.items()):
                    t = tensor_io.tensor_read(conn, f"{prefix}/{k}")
                    params[k] = t.reshape(old.shape).to(old.device)
                for k, old in list(state.items()):
                    try:
                        t = tensor_io.tensor_read(conn, f"{prefix}/state/{k}")
                    except KeyError:
                        continue
                    state[k] = t.to(old.device)
        finally:
            conn.close()


def params_from_jax(jax_model, model: Model,
                    device: _device.DeviceLike = None) -> None:
    """Copy a built ``ccv_tpu`` graph model's parameters and states into the
    built port ``model`` of the same topology, node by node in topological
    order (uids differ between the two). Raises if a layer name or a
    parameter's shape disagrees. On ``device`` (default: the card)."""
    device = _device.resolve(device)
    if len(jax_model.order) != len(model.order):
        raise ValueError(f"{len(jax_model.order)} nodes against "
                         f"{len(model.order)}")
    for i, (jn, tn) in enumerate(zip(jax_model.order, model.order)):
        if jn.layer.name != tn.layer.name:
            raise ValueError(f"node {i}: {jn.layer.name} against "
                             f"{tn.layer.name}")
        for src, dst in ((jax_model.params, model.params),
                         (jax_model.state, model.state)):
            old, new = src[str(jn.uid)], dst[str(tn.uid)]
            if set(old) != set(new):
                raise ValueError(f"node {i} ({tn.layer.name}): keys "
                                 f"{sorted(old)} against {sorted(new)}")
            for k, v in old.items():
                t = _tensor(v, device)
                if tuple(t.shape) != tuple(new[k].shape):
                    raise ValueError(f"node {i} ({tn.layer.name}) {k}: "
                                     f"{tuple(t.shape)} against "
                                     f"{tuple(new[k].shape)}")
                new[k] = t


def positions(order: Sequence[Node], tree) -> List[int]:
    """For a graph model's tree of per-node dicts keyed ``str(uid)`` (its
    parameters or states), the ``leaves()`` index of each leaf taken node
    by node in topological ``order``, keys sorted. Works on ``ccv_tpu``'s
    models too (the same attributes)."""
    index = {key: i for i, key in enumerate(
        (uid, k) for uid in sorted(tree) for k in sorted(tree[uid]))}
    return [index[(str(node.uid), k)] for node in order
            for k in sorted(tree[str(node.uid)])]


def leaf_order(jax_model, model: Model) -> List[int]:
    """For each parameter leaf of the port's ``model`` in ``leaves()``
    order, the index of the same parameter among ``jax_model``'s leaves
    (both sort the keys ``str(uid)``, and the uids differ between the
    packages); ``optimizers.opt_state_from_jax`` takes it as ``perm``."""
    theirs = positions(jax_model.order, jax_model.params)
    out = [0] * len(theirs)
    for mine, j in zip(positions(model.order, model.params), theirs):
        out[mine] = j
    return out


# ---------------------------------------------------------------------------
# the remaining simple constructors of ccv_cnnp_model_addons.c
# ---------------------------------------------------------------------------

class _ElemwiseBinary(Layer):
    n_inputs = "many"

    def init(self, generator, in_shapes):
        return {}, {}, in_shapes[0]


class Div(_ElemwiseBinary):
    """ccv_cnnp_div (optionally the reciprocal of the first input)."""

    def __init__(self, reciprocal: bool = False, name: str = "div"):
        self.reciprocal = reciprocal
        self.name = name

    def apply(self, params, state, xs, training=False, generator=None):
        if self.reciprocal:
            return 1.0 / xs[0], state
        return xs[0] / xs[1], state


class Max(_ElemwiseBinary):
    """ccv_cnnp_max: elementwise maximum of two inputs."""

    def __init__(self, name: str = "max"):
        self.name = name

    def apply(self, params, state, xs, training=False, generator=None):
        return torch.maximum(xs[0], xs[1]), state


class Min(_ElemwiseBinary):
    """ccv_cnnp_min."""

    def __init__(self, name: str = "min"):
        self.name = name

    def apply(self, params, state, xs, training=False, generator=None):
        return torch.minimum(xs[0], xs[1]), state


class Matmul(Layer):
    """ccv_cnnp_matmul: batched product of two inputs, optionally
    transposed, summed in float32 and cast to the first input's type."""

    n_inputs = "many"

    def __init__(self, transpose_a=False, transpose_b=False,
                 name: str = "matmul"):
        self.ta = transpose_a
        self.tb = transpose_b
        self.name = name

    def init(self, generator, in_shapes):
        a, b = (tuple(s) for s in in_shapes)
        a = a[:-2] + (a[-1], a[-2]) if self.ta else a
        b = b[:-2] + (b[-1], b[-2]) if self.tb else b
        return {}, {}, tuple(a[:-1]) + (b[-1],)

    def apply(self, params, state, xs, training=False, generator=None):
        a, b = xs
        return ops.gemm(a, b, transpose_a=self.ta,
                        transpose_b=self.tb), state


class CMul(_ElemwiseBinary):
    """ccv_cnnp_cmul: complex products of interleaved (re, im) pairs."""

    def __init__(self, name: str = "cmul"):
        self.name = name

    def apply(self, params, state, xs, training=False, generator=None):
        return ops.cmul(xs[0], xs[1]), state


class MaskedFill(Layer):
    """ccv_cnnp_masked_fill: x where mask != eq, else fill."""

    n_inputs = "many"

    def __init__(self, eq: float = 0.0, fill: float = -1e9,
                 name: str = "masked_fill"):
        self.eq = eq
        self.fill = fill
        self.name = name

    def init(self, generator, in_shapes):
        return {}, {}, in_shapes[0]

    def apply(self, params, state, xs, training=False, generator=None):
        x, mask = xs
        return ops.masked_fill(x, mask, self.eq, self.fill), state


class Scalar(Layer):
    """ccv_cnnp_scalar: a constant float32 scalar node."""

    def __init__(self, value: float, name: str = "scalar"):
        self.value = value
        self.name = name

    def init(self, generator, in_shape):
        return {}, {}, ()

    def apply(self, params, state, x, training=False, generator=None):
        return torch.tensor(self.value, dtype=torch.float32,
                            device=x.device), state


class ScalarMul(Layer):
    """ccv_cnnp_scalar_mul: x * a."""

    def __init__(self, a: float, name: str = "scalar_mul"):
        self.a = a
        self.name = name

    def apply(self, params, state, x, training=False, generator=None):
        return x * self.a, state


class Clamp(Layer):
    """ccv_cnnp_clamp."""

    def __init__(self, lo=None, hi=None, name: str = "clamp"):
        self.lo = lo
        self.hi = hi
        self.name = name

    def apply(self, params, state, x, training=False, generator=None):
        return ops.clamp(x, self.lo, self.hi), state


class Sqrt(Layer):
    """ccv_cnnp_sqrt."""

    def __init__(self, name: str = "sqrt"):
        self.name = name

    def apply(self, params, state, x, training=False, generator=None):
        return torch.sqrt(x), state


class ArgMax(Layer):
    """ccv_cnnp_argmax."""

    def __init__(self, axis: int = -1, name: str = "argmax"):
        self.axis = axis
        self.name = name

    def init(self, generator, in_shape):
        out = list(in_shape)
        del out[self.axis]
        return {}, {}, tuple(out)

    def apply(self, params, state, x, training=False, generator=None):
        return ops.argmax(x, self.axis), state


class ArgMin(ArgMax):
    """ccv_cnnp_argmin."""

    def __init__(self, axis: int = -1, name: str = "argmin"):
        super().__init__(axis, name)

    def apply(self, params, state, x, training=False, generator=None):
        return ops.argmin(x, self.axis), state


class DatatypeConversion(Layer):
    """ccv_cnnp_datatype_conversion to a torch dtype."""

    def __init__(self, dtype: torch.dtype, name: str = "cast"):
        self.dtype = dtype
        self.name = name

    def apply(self, params, state, x, training=False, generator=None):
        return x.to(self.dtype), state


class Contiguous(Layer):
    """ccv_cnnp_contiguous / ccv_cnnp_move: a contiguous copy where the
    input is a strided view, else the input."""

    def __init__(self, name: str = "contiguous"):
        self.name = name

    def apply(self, params, state, x, training=False, generator=None):
        return x.contiguous(), state


Move = Contiguous  # ccv_cnnp_move


class Parameter(Layer):
    """ccv_cnnp_parameter: a free trainable tensor node (its input only
    orders it in the graph); uniform in +-init_bound, or zeros."""

    def __init__(self, shape, init_bound: float = 0.0, name: str = "param"):
        self.shape = tuple(shape)
        self.init_bound = init_bound
        self.name = name

    def init(self, generator, in_shape):
        if self.init_bound:
            p = (torch.rand(self.shape, generator=generator)
                 * (2 * self.init_bound) - self.init_bound)
        else:
            p = torch.zeros(self.shape)
        return {"w": p}, {}, self.shape

    def apply(self, params, state, x, training=False, generator=None):
        return params["w"], state


class Variable(Layer):
    """ccv_cnnp_variable: a free non-trainable tensor node (zeros)."""

    def __init__(self, shape, name: str = "variable"):
        self.shape = tuple(shape)
        self.name = name

    def init(self, generator, in_shape):
        return {}, {"v": torch.zeros(self.shape)}, self.shape

    def apply(self, params, state, x, training=False, generator=None):
        return state["v"], state


class Extract(Pick):
    """ccv_cnnp_extract: one output of a multi-output node."""


class Debug(Layer):
    """ccv_cnnp_debug: identity that calls ``fn`` with the value."""

    def __init__(self, fn=None, name: str = "debug"):
        self.fn = fn or (lambda v: print(f"[debug:{name}]", tuple(v.shape)))
        self.name = name

    def apply(self, params, state, x, training=False, generator=None):
        self.fn(x)
        return x, state


class Squeeze(Layer):
    """ccv_cnnp_squeeze-style: drop size-1 axes (all, or the given ones)."""

    def __init__(self, axis=None, name: str = "squeeze"):
        self.axis = axis
        self.name = name

    def _axes(self, ndim: int):
        axes = self.axis if isinstance(self.axis, (tuple, list)) \
            else (self.axis,)
        return {a % ndim for a in axes}

    def init(self, generator, in_shape):
        if self.axis is None:
            return {}, {}, tuple(d for d in in_shape if d != 1)
        axes = self._axes(len(in_shape))
        return {}, {}, tuple(d for i, d in enumerate(in_shape)
                             if i not in axes)

    def apply(self, params, state, x, training=False, generator=None):
        if self.axis is None:
            return torch.squeeze(x), state
        return torch.squeeze(x, tuple(sorted(self._axes(x.ndim)))), state


class CmdExec(Layer):
    """ccv_cnnp_cmd_exec twin: any function of tensors (e.g. from
    ``ccv_tpu_torch.nn.ops``) as a graph layer; its output shape is found
    on the ``meta`` device. Like ``ccv_tpu``'s, it takes a node's first
    input."""

    def __init__(self, fn, name: str = "cmd_exec"):
        self.fn = fn
        self.name = name

    def init(self, generator, in_shape):
        shapes = in_shape if isinstance(in_shape, list) else [in_shape]
        outs = self.fn(*[torch.empty(tuple(s), device="meta")
                         for s in shapes])
        out = tuple(outs.shape) if isinstance(outs, torch.Tensor) \
            else [tuple(o.shape) for o in outs]
        return {}, {}, out

    def apply(self, params, state, x, training=False, generator=None):
        if isinstance(x, (tuple, list)):
            return self.fn(*x), state
        return self.fn(x), state


class Dynamic(Layer):
    """ccv_cnnp_dynamic_new twin: ``builder(shape)`` makes the inner layer
    once the input shape is known, at ``init``."""

    def __init__(self, builder, name: str = "dynamic"):
        self.builder = builder
        self.name = name
        self._inner: Optional[Layer] = None

    def init(self, generator, in_shape):
        self._inner = self.builder(tuple(in_shape))
        return self._inner.init(generator, in_shape)

    def apply(self, params, state, x, training=False, generator=None):
        if self._inner is None:
            raise RuntimeError("Dynamic layer applied before init()")
        return self._inner.apply(params, state, x, training, generator)


def model_copy(model, is_trainable: bool = True):
    """ccv_cnnp_model_copy twin (ccv_cnnp_model.c:599): the architecture,
    unbuilt (copy_weights=0): the copy shares no parameters and initialises
    on its own ``build``."""
    from ccv_tpu_torch.nn.model import Sequential

    if isinstance(model, Model):
        inputs, outputs = copy.deepcopy((model.inputs, model.outputs))
        new = Model(inputs, outputs, name=model.name)
    elif isinstance(model, Sequential):
        new = Sequential(copy.deepcopy(model.layers), name=model.name)
    else:
        raise TypeError(f"cannot copy {type(model).__name__}")
    new.is_trainable = is_trainable
    return new
