"""CNNP-like model API of the port, inference half (counterpart of
ccv_tpu/nn/model.py; reference: lib/nnc/ccv_cnnp_model.c).

``Sequential`` is a layer stack with CNNP's lifecycle: ``build`` infers
shapes and initialises parameters, ``evaluate`` runs the forward on the
input's device, eagerly, under ``torch.no_grad`` (one kernel launch or a
few per layer: cuDNN's convolutions, cuBLAS's matmuls). Parameters are a
list of per-layer dicts in ``ccv_tpu``'s layouts, so ``params_from_jax``
is a copy.

Not ported yet (training): ``compile``, ``fit``, ``backward``,
``apply_gradients``, ``checkpoint``, ``resume``, ``set_data_parallel``
and the checkpointing and memory-compression branches of the forward.
"""

from __future__ import annotations

import math
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from ccv_tpu_torch import device as _device
from ccv_tpu_torch.nn.layers import Layer


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


class Sequential:
    """ccv_cnnp_sequential_new twin: a layer stack with CNNP's lifecycle."""

    def __init__(self, layers: Sequence[Layer], name: str = "model"):
        self.layers = list(layers)
        self.name = name
        self.params: Any = None
        self.state: Any = None
        self.input_shape = None
        self.output_shape = None

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
            x, ns = layer.apply(p, s, x, training, generator)
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
        device, without autograd."""
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
