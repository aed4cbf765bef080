"""CNNP-like model API of the port (counterpart of ccv_tpu/nn/model.py;
reference: lib/nnc/ccv_cnnp_model.c).

``Sequential`` is a layer stack with CNNP's lifecycle: ``build`` infers
shapes and initialises parameters, ``evaluate`` runs the forward on the
input's device, eagerly, under ``torch.no_grad`` (one kernel launch or a
few per layer: cuDNN's convolutions, cuBLAS's matmuls). Parameters are a
list of per-layer dicts in ``ccv_tpu``'s layouts, so ``params_from_jax``
is a copy.

Training (``Trainable``, shared with the graph ``Model``): ``compile``
takes an optimizer of ``nn/optimizers.py`` and a loss of ``LOSSES``;
``fit`` runs one step (the forward in training mode, the loss, its
gradients by autograd, the optimizer's in-place update); ``backward``
accumulates gradients that ``apply_gradients`` applies; ``cancel`` skips
the next of them. Each step draws from a ``torch.Generator`` on the
model's device seeded from the step key (two 32-bit words, as
``ccv_tpu``'s PRNG key; ``_next_generator``). Gradient checkpointing,
memory compression (LSSC) and memory reduction (bfloat16) wrap each
layer's apply in the training forward as ``ccv_tpu``'s ``_forward`` does
(``nn/compression.py``), and replay the forward's draws. ``checkpoint`` /
``resume`` add the optimizer's and the layers' states to the model's rows
(``__<name>__[opt:i]``, ``[lstate:i]`` in leaf order, ``[stepkey]``), so a
checkpoint written by either package resumes in the other. There is no
``torch.compile``: every step runs eagerly.

Data parallelism (``set_data_parallel(n)``): one process per rank
(``torchrun``), each given the whole batch; a rank runs its 1/n of the
rows inside ``parallel.data.sharded``, so batch norm's statistics and the
dropout masks are the global batch's, its loss is its share of the global
loss (every loss must keep that convention: ``LOSSES`` do, a function of
one's own is taken once marked ``parallel.data.global_batch_loss``), and
the gradients are allreduced before the optimizer, which then runs
alike on every rank: the step is the one-rank step on the whole batch, as
GSPMD makes ``ccv_tpu``'s. Unlike ``ccv_tpu`` (which replicates on fewer
devices with a warning), ``n`` must equal the group's world size.
"""

from __future__ import annotations

import math
import sqlite3
import threading
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch

from ccv_tpu_torch import device as _device
from ccv_tpu_torch.nn import compression, ops, optimizers
from ccv_tpu_torch.nn.layers import Layer
from ccv_tpu_torch.parallel import data as _data
from ccv_tpu_torch.parallel import mesh as _mesh
from ccv_tpu_torch.utils import flags


def _tensor(x, device: torch.device) -> torch.Tensor:
    """A numpy (or JAX) array as a tensor of the same type on ``device``;
    bfloat16 (ml_dtypes) arrays keep their bits."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a).view(np.int16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_jax(params, device: _device.DeviceLike = None
                    ) -> List[dict]:
    """The port's parameters (or layer states) from ``ccv_tpu``'s
    ``Sequential.params`` (or ``.state``): a list of per-layer dicts of
    numpy or JAX arrays. The layouts are the same, so this is a copy, on
    ``device`` (default: the card; raises without one)."""
    device = _device.resolve(device)
    return [{k: _tensor(v, device) for k, v in layer.items()}
            for layer in params]


# the losses of ccv_cnnp_model_compile (the CMD_*_FORWARD losses), each the
# mean over the batch (under data parallelism, this rank's share of the
# global batch's mean)
LOSSES = {name: _data.global_batch_loss(fn) for name, fn in {
    "softmax_crossentropy": lambda out, fit: _data.mean(
        ops.softmax_crossentropy(out, fit)[0]),
    "categorical_crossentropy": lambda out, fit:
        _data.mean(ops.categorical_crossentropy(out, fit)),
    "sigmoid_binary_crossentropy": lambda out, fit: _data.mean(
        ops.sigmoid_binary_crossentropy(out, fit)[0]),
    "mse": lambda out, fit: _data.mean(ops.mse_loss(out, fit)),
    "mae": lambda out, fit: _data.mean(ops.mae_loss(out, fit)),
    "smooth_l1": lambda out, fit: _data.mean(ops.smooth_l1_loss(out, fit)),
}.items()}

_MASK64 = (1 << 64) - 1


def _splitmix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def _unflatten(tree, it):
    """``tree``'s structure with its leaves taken in ``leaves()`` order
    from the iterator ``it``."""
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, it) for v in tree)
    return next(it)


def loss_and_grads(params, loss_of: Callable):
    """(loss, gradients in ``leaves()`` order, aux) of ``loss_of(tp) ->
    (loss, aux)``, ``tp`` being ``params`` detached with their floating
    leaves requiring grad: one training forward and backward, nothing
    applied. A leaf the loss does not reach gets zeros; the loss and every
    tensor of ``aux`` (new layer states) come back detached."""
    tp = optimizers.tree_map(
        lambda p: p.detach().requires_grad_(p.is_floating_point()), params)
    leaves = optimizers.leaves(tp)
    with torch.enable_grad():
        loss, aux = loss_of(tp)
        wrt = [p for p in leaves if p.requires_grad]
        got = iter(torch.autograd.grad(loss, wrt, allow_unused=True))
    grads = []
    for p in leaves:
        g = next(got) if p.requires_grad else None
        grads.append(torch.zeros_like(p) if g is None else g)
    return (loss.detach(), grads,
            optimizers.tree_map(lambda t: t.detach(), aux))


class Trainable:
    """The training half of CNNP's lifecycle, for a model class that has
    ``params``, ``state``, ``name``, ``build``, ``_forward(params,
    states, inputs, training, generator)``, ``write`` and ``read``
    (``Sequential`` and ``functional.Model``)."""

    def _init_training(self):
        self.opt: Optional[optimizers.Optimizer] = None
        self.opt_state: Any = None
        self.loss: Optional[Callable] = None
        self.checkpointing = False
        self.memory_compression = False
        self.memory_reduction = False
        self._pending_grads: Optional[List[torch.Tensor]] = None
        self._cancel_event = threading.Event()
        self._step_key = np.zeros(2, np.uint32)  # ccv_tpu's PRNGKey(0)
        self.parallel = 1
        self._data_group = None  # set_data_parallel's group, None: 1 rank

    # -- compile ------------------------------------------------------------
    def compile(self, optimizer: optimizers.Optimizer, loss,
                input_shape=None,
                generator: Optional[torch.Generator] = None,
                device: _device.DeviceLike = None):
        """ccv_cnnp_model_compile twin (model.c:572): the optimizer (its
        state from ``init``) and the loss (a name of ``LOSSES`` or a
        function of (outputs, fits); under data parallelism one marked
        ``parallel.data.global_batch_loss``). With ``input_shape`` an
        unbuilt model is built first (``generator``, ``device`` as
        ``build``)."""
        if input_shape is not None and self.params is None:
            self.build(input_shape, generator, device)
        if self.params is None:
            raise RuntimeError("build(input_shape) first")
        self.opt = optimizer
        self.opt_state = optimizer.init(self.params)
        self.loss = LOSSES[loss] if isinstance(loss, str) else loss
        self._pending_grads = None
        self._check_loss()

    def _check_loss(self):
        """Under data parallelism a rank's loss must be its share of the
        global batch's loss; a loss not marked so would scale or average
        the gradients wrongly, so it is refused."""
        if self.parallel > 1 and self.loss is not None and not getattr(
                self.loss, "global_batch", False):
            raise ValueError(
                f"set_data_parallel({self.parallel}) needs a loss that "
                f"returns this rank's share of the global batch's loss: a "
                f"name of LOSSES, or a function marked "
                f"parallel.data.global_batch_loss (got {self.loss!r})")

    def set_data_parallel(self, parallel: int):
        """ccv_cnnp_model_set_data_parallel twin (model.c:635): every rank
        of the process group runs 1/``parallel`` of each batch's rows and
        the gradients are allreduced. ``parallel`` must be the world size;
        1 without a process group is the one-rank step. Raises otherwise
        (``ccv_tpu`` replicates quietly instead)."""
        world = _mesh.world_size()
        if parallel != world:
            raise ValueError(
                f"set_data_parallel({parallel}): the process group holds "
                f"{world} rank(s); start {parallel} (torchrun "
                f"--nproc-per-node {parallel}) and call "
                f"parallel.distributed.init first")
        self.parallel = parallel
        self._data_group = (torch.distributed.group.WORLD
                            if torch.distributed.is_initialized() else None)
        self._check_loss()

    def set_gradient_checkpointing(self, enable: bool = True):
        """ccv_cnnp_model_set_gradient_checkpointing twin (model.c:670):
        every layer's activations are recomputed in the backward."""
        self.checkpointing = enable

    def set_memory_compression(self, enable: bool = True):
        """ccv_cnnp_model_set_memory_compression twin (model.c:654): 4-D
        inputs a layer saves for the backward are LSSC-compressed (lossy),
        unless ``flags.DISABLE_MEMORY_COMPRESSION`` is set."""
        self.memory_compression = enable

    def set_memory_reduction(self, enable: bool = True):
        """ccv_cnnp_model_set_memory_reduction twin (ccv_nnc.h:3931): float
        inputs a layer saves for the backward are kept as bfloat16 (the
        forward's outputs stay exact)."""
        self.memory_reduction = enable

    def _apply_layer(self, layer: Layer, params, state, x, training: bool,
                     generator: Optional[torch.Generator]):
        """One layer's apply, wrapped in training as ``ccv_tpu``'s
        ``_forward`` wraps it: checkpointing, then compression of a 4-D
        input or reduction of a float one."""
        apply = layer.apply
        if not training:
            return apply(params, state, x, training, generator)
        if self.checkpointing:
            apply = compression.checkpointed_apply(apply)
        if (self.memory_compression and isinstance(x, torch.Tensor)
                and x.ndim == 4
                and not flags.is_set(flags.DISABLE_MEMORY_COMPRESSION)):
            return compression.compressed_apply(apply, x.shape, x.dtype,
                                                True)(params, state, x,
                                                      generator)
        if (self.memory_reduction and isinstance(x, torch.Tensor)
                and x.dtype in (torch.float32, torch.float64)):
            return compression.reduced_apply(apply, x.dtype, True)(
                params, state, x, generator)
        return apply(params, state, x, training, generator)

    # -- the step ------------------------------------------------------------
    def _param_device(self) -> torch.device:
        ps = optimizers.leaves(self.params)
        return ps[0].device if ps else _device.default_device()

    def _next_generator(self) -> torch.Generator:
        """The step's generator, on the model's device, seeded from the step
        key's two words; the key then advances (splitmix64), as
        ``ccv_tpu`` splits its key every step."""
        seed = (int(self._step_key[0]) << 32) | int(self._step_key[1])
        nxt = _splitmix64(seed)
        self._step_key = np.array([nxt >> 32, nxt & 0xFFFFFFFF], np.uint32)
        return torch.Generator(device=self._param_device()).manual_seed(seed)

    def _inputs(self, x):
        if isinstance(x, (list, tuple)):
            return [self._inputs(v) for v in x]
        if isinstance(x, torch.Tensor):
            return x
        return _device.to_device(np.asarray(x), self._param_device())

    def _step(self, inputs, fits):
        """(loss, grads in ``leaves()`` order, new layer states) of one
        training forward and backward."""
        if self.opt is None:
            raise RuntimeError("compile() first")
        inputs, fits = self._inputs(inputs), self._inputs(fits)
        generator = self._next_generator()
        group = self._data_group  # None: one rank, nothing split

        def rows(x):  # this rank's rows of the global batch
            if isinstance(x, list):
                return [rows(v) for v in x]
            return _data.rows(x, group)
        inputs, fits = rows(inputs), rows(fits)

        def loss_of(tp):  # this rank's share of the global batch's loss
            out, new_states = self._forward(tp, self.state, inputs, True,
                                            generator)
            return self.loss(out, fits), new_states
        with _data.sharded((0, group)):
            loss, grads, states = loss_and_grads(self.params, loss_of)
            loss = _data.global_sum(loss)
        return loss, _data.allreduce_grads(grads, [group]), states

    # -- cancellation (ccv_cnnp_model_cancel, ccv_nnc.h:3823) --------------
    def cancel(self):
        """Cancel the next ``fit``, ``backward`` or ``apply_gradients``: it
        skips its work, returns None and clears the flag. Safe to call from
        another thread while a step runs (the abort point is between
        steps, as the reference aborts between graph nodes)."""
        self._cancel_event.set()

    def _take_cancel(self) -> bool:
        if self._cancel_event.is_set():
            self._cancel_event.clear()
            return True
        return False

    # -- public API (ccv_cnnp_model_fit / backward / apply_gradients) --------
    def fit(self, inputs, fits) -> Optional[float]:
        """One training step (model.c:1533): the loss before the update, or
        None if the step was cancelled."""
        if self._take_cancel():
            return None
        loss, grads, self.state = self._step(inputs, fits)
        self.params, self.opt_state = self.opt.update(grads, self.opt_state,
                                                      self.params)
        return float(loss)

    def backward(self, inputs, fits) -> Optional[float]:
        """Compute and stash the gradients (model.c:1913), adding them to
        those of earlier calls since the last ``apply_gradients``; the
        layer states move on. Returns the loss, or None if cancelled."""
        if self._take_cancel():
            return None
        loss, grads, self.state = self._step(inputs, fits)
        if self._pending_grads is None:
            self._pending_grads = grads
        else:
            self._pending_grads = [a + b for a, b in
                                   zip(self._pending_grads, grads)]
        return float(loss)

    def apply_gradients(self):
        """Apply the stashed gradients (model.c:2088); if cancelled, drop
        them and do nothing."""
        if self._take_cancel():
            self._pending_grads = None
            return
        if self._pending_grads is None:
            raise RuntimeError("backward() first")
        self.params, self.opt_state = self.opt.update(
            self._pending_grads, self.opt_state, self.params)
        self._pending_grads = None

    def parameters_zip_map(self, fn: Callable, other):
        """ccv_cnnp_model_parameters_zip_map twin: params = fn(params,
        other) leaf by leaf (``other`` of the same structure)."""
        self.params = optimizers.tree_zip(fn, self.params, other)

    # -- trainer checkpoints -------------------------------------------------
    def _positions(self, tree) -> List[int]:
        """The ``leaves()`` index of each leaf of ``tree`` (the parameters
        or the layer states) in the order of a checkpoint's rows: the
        leaves' own order, which is ``ccv_tpu``'s."""
        return list(range(len(optimizers.leaves(tree))))

    def checkpoint(self, path: str, name: Optional[str] = None):
        """The model's rows (``write``), then the optimizer's state
        ``__<name>__[opt:i]`` and the layers' states ``[lstate:i]`` in
        ``ccv_tpu``'s leaf order (a graph model's by topological position,
        ``_positions``), and the step key ``[stepkey]`` (its two words as
        int32), so ``fit`` after ``resume`` continues the same trajectory,
        in either package."""
        from ccv_tpu_torch.nn import tensor_io

        name = name or self.name
        self.write(path, name)
        states = optimizers.leaves(self.state)
        conn = tensor_io.open_db(path)
        try:
            with conn:
                rows = [("opt", optimizers.state_leaves(
                    self.opt_state, self._positions(self.params))),
                        ("lstate", [states[i] for i in
                                    self._positions(self.state)])]
                for tag, ts in rows:
                    for i, t in enumerate(ts):
                        tensor_io.tensor_write(conn, f"__{name}__[{tag}:{i}]",
                                               t)
                tensor_io.tensor_write(conn, f"__{name}__[stepkey]",
                                       self._step_key.view(np.int32))
        finally:
            conn.close()

    def resume(self, path: str, name: Optional[str] = None):
        """Restore a ``checkpoint`` file written by either package into the
        compiled model: parameters, layer states, optimizer state and the
        step key. ``ccv_tpu``'s ``[stepkey]`` row is a threefry PRNG key;
        the port takes its two words as its own step key (so its dropout
        masks, drawn by torch's generators, differ from JAX's after
        ``resume`` as before it), and ``ccv_tpu`` reads the port's key as a
        threefry key."""
        from ccv_tpu_torch.nn import tensor_io

        name = name or self.name
        if self.opt_state is None:
            raise RuntimeError("compile() first")
        self.read(path, name)
        conn = sqlite3.connect(path)
        try:
            def rows(tag, n):
                return [tensor_io.tensor_read(conn, f"__{name}__[{tag}:{i}]")
                        for i in range(n)]

            n_opt = len(optimizers.state_leaves(self.opt_state))
            inv = np.argsort(self._positions(self.params))
            optimizers.load_state_leaves(self.opt_state, rows("opt", n_opt),
                                         inv)
            old = optimizers.leaves(self.state)
            got = rows("lstate", len(old))
            inv = np.argsort(self._positions(self.state))
            new = [got[j].to(o.device, o.dtype).reshape(o.shape)
                   for j, o in zip(inv, old)]
            self.state = _unflatten(self.state, iter(new))
            key = tensor_io.tensor_read(conn, f"__{name}__[stepkey]")
            self._step_key = key.numpy().reshape(2).view(np.uint32).copy()
        finally:
            conn.close()


class Sequential(Trainable):
    """ccv_cnnp_sequential_new twin: a layer stack with CNNP's lifecycle."""

    def __init__(self, layers: Sequence[Layer], name: str = "model"):
        self.layers = list(layers)
        self.name = name
        self.params: Any = None
        self.state: Any = None
        self.input_shape = None
        self.output_shape = None
        self._init_training()

    # -- build ------------------------------------------------------------
    def build(self, input_shape: Sequence[int],
              generator: Optional[torch.Generator] = None,
              device: _device.DeviceLike = None):
        """Shape-infer and initialise the parameters on ``device`` (default:
        the card; raises without one). The draws come from ``generator``
        (default: seed 0) on the CPU, so a seed gives the same weights on
        every device."""
        device = _device.resolve(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        params, states = [], []
        shape = tuple(input_shape)
        for layer in self.layers:
            p, s, shape = layer.init(generator, shape)
            params.append({k: v.to(device) for k, v in p.items()})
            states.append({k: v.to(device) for k, v in s.items()})
        self.params = params
        self.state = states
        self.input_shape = tuple(input_shape)
        self.output_shape = shape
        return shape

    def _forward(self, params, states, x: torch.Tensor, training: bool,
                 generator: Optional[torch.Generator]):
        new_states = []
        for layer, p, s in zip(self.layers, params, states):
            x, ns = self._apply_layer(layer, p, s, x, training, generator)
            new_states.append(ns)
        return x, new_states

    def __call__(self, x: torch.Tensor, training: bool = False,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.params is None:
            self.build(x.shape, device=x.device)
        y, _ = self._forward(self.params, self.state, x, training, generator)
        return y

    def evaluate(self, inputs: torch.Tensor) -> torch.Tensor:
        """The forward pass at inference (model.c:1848), on the inputs'
        device, without autograd (also after ``compile``: eager, no
        ``torch.compile``)."""
        if self.params is None:
            self.build(inputs.shape, device=inputs.device)
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
        return sum(math.prod(v.shape) for p in self.params for v in p.values())

    def parameters_isnan(self) -> bool:
        return any(bool(torch.isnan(v).any())
                   for p in self.params for v in p.values())

    # -- checkpoint io ----------------------------------------------------
    def write(self, path: str, name: Optional[str] = None):
        from ccv_tpu_torch.nn import tensor_io

        tensor_io.write_model(self, path, name or self.name)

    def read(self, path: str, name: Optional[str] = None):
        from ccv_tpu_torch.nn import tensor_io

        tensor_io.read_model(self, path, name or self.name)

    def dot(self) -> str:
        """ccv_cnnp_model_dot twin: a GraphViz description of the stack."""
        lines = ["digraph model {"]
        prev = "input"
        for i, layer in enumerate(self.layers):
            node = f"l{i}_{layer.name}"
            lines.append(f'  {node} [label="{layer.name}"];')
            lines.append(f"  {prev} -> {node};")
            prev = node
        lines.append("}")
        return "\n".join(lines)
