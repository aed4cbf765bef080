"""CNNP layers of the port (counterpart of ccv_tpu/nn/layers.py; reference:
lib/nnc/ccv_cnnp_model_addons.c).

A layer is a small object with ``init(generator, in_shape) -> (params,
state, out_shape)`` and ``apply(params, state, x, training=False,
generator=None) -> (y, new_state)``; ``ccv_tpu_torch.nn.model.Sequential``
composes them. Parameters and state are dicts of tensors in ``ccv_tpu``'s
layouts (convolution weights OHWI, dense weights (d_in, d_out)), so
``ccv_tpu``'s parameters copy across unchanged. ``init`` draws on the CPU
from ``generator`` (a seeded ``torch.Generator``); the model moves the
result to its device. Shapes are inferred as ``ccv_tpu`` does with
``jax.eval_shape``: the op runs on the ``meta`` device.

Initialization: Glorot-uniform for convolution and dense weights, zero
biases (the reference's default).

Not ported yet: ConvolutionTranspose, LayerNorm, GroupNorm, RMSNorm,
Embedding, Permute, Transpose, Pad, Upsample, LSTM and
ScaledDotProductAttention.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch

from ccv_tpu_torch.nn import ops


class Layer:
    name: str = "layer"

    def init(self, generator: torch.Generator, in_shape):
        return {}, {}, tuple(in_shape)

    def apply(self, params, state, x, training=False, generator=None):
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}"


def _glorot(generator: torch.Generator, shape, fan_in: int,
            fan_out: int) -> torch.Tensor:
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return u * (2 * limit) - limit


def _meta_shape(fn: Callable, in_shape) -> tuple:
    """The output shape of ``fn`` on a float32 input of ``in_shape``."""
    return tuple(fn(torch.empty(tuple(in_shape), device="meta")).shape)


class Dense(Layer):
    """ccv_cnnp_dense (model_addons.c:1421): x @ w + b, w (d_in, d_out).
    The product is cast to x's type, then a bias cast to x's type is added,
    as ``ccv_tpu``'s Dense does."""

    def __init__(self, count: int, no_bias: bool = False,
                 name: str = "dense"):
        self.count = count
        self.no_bias = no_bias
        self.name = name

    def init(self, generator, in_shape):
        d = in_shape[-1]
        params = {"w": _glorot(generator, (d, self.count), d, self.count)}
        if not self.no_bias:
            params["b"] = torch.zeros(self.count)
        return params, {}, (*in_shape[:-1], self.count)

    def apply(self, params, state, x, training=False, generator=None):
        y = torch.matmul(x, params["w"].to(x.dtype))
        if "b" in params:
            y = y + params["b"].to(x.dtype)
        return y, state


class Convolution(Layer):
    """ccv_cnnp_convolution (model_addons.c:1180). NHWC; filters OHWI."""

    def __init__(self, filters: int, kernel=(3, 3), stride=(1, 1),
                 padding="SAME", dilation=(1, 1), groups: int = 1,
                 no_bias: bool = False, name: str = "conv"):
        self.filters = filters
        self.kernel = tuple(kernel)
        self.stride = tuple(stride)
        self.padding = padding
        self.dilation = tuple(dilation)
        self.groups = groups
        self.no_bias = no_bias
        self.name = name

    def init(self, generator, in_shape):
        cin = in_shape[-1]
        kh, kw = self.kernel
        fan_in = kh * kw * cin // self.groups
        fan_out = kh * kw * self.filters // self.groups
        w = _glorot(generator, (self.filters, kh, kw, cin // self.groups),
                    fan_in, fan_out)
        params = {"w": w}
        if not self.no_bias:
            params["b"] = torch.zeros(self.filters)
        out = _meta_shape(lambda x: ops.conv2d(
            x, w.to("meta"), stride=self.stride, padding=self.padding,
            dilation=self.dilation, groups=self.groups),
            (1, *in_shape[-3:]))
        return params, {}, (*in_shape[:-3], *out[1:])

    def apply(self, params, state, x, training=False, generator=None):
        y = ops.conv2d(x, params["w"].to(x.dtype), params.get("b"),
                       stride=self.stride, padding=self.padding,
                       dilation=self.dilation, groups=self.groups)
        return y, state


class BatchNorm(Layer):
    """ccv_cnnp_batch_norm at inference; state carries the running mean and
    var. Training (batch statistics) waits with the training half of
    ``Sequential``."""

    def __init__(self, momentum: float = 0.9, epsilon: float = 1e-5,
                 name: str = "bn"):
        self.momentum = momentum
        self.epsilon = epsilon
        self.name = name

    def init(self, generator, in_shape):
        c = in_shape[-1]
        params = {"scale": torch.ones(c), "bias": torch.zeros(c)}
        state = {"mean": torch.zeros(c), "var": torch.ones(c)}
        return params, state, tuple(in_shape)

    def apply(self, params, state, x, training=False, generator=None):
        if training:
            raise NotImplementedError(
                "BatchNorm in training mode is not ported yet")
        y = ops.batch_norm(x, params["scale"], params["bias"], state["mean"],
                           state["var"], self.epsilon)
        return y, state


class _Stateless(Layer):
    def __init__(self, fn: Callable, shape_fn: Optional[Callable] = None,
                 name: str = "fn"):
        self.fn = fn
        self.shape_fn = shape_fn
        self.name = name

    def init(self, generator, in_shape):
        if self.shape_fn is not None:
            return {}, {}, tuple(self.shape_fn(tuple(in_shape)))
        return {}, {}, _meta_shape(self.fn, in_shape)

    def apply(self, params, state, x, training=False, generator=None):
        return self.fn(x), state


def ReLU():
    return _Stateless(ops.relu, lambda s: s, "relu")


def LeakyReLU(slope=0.01):
    return _Stateless(lambda x: ops.leaky_relu(x, slope), lambda s: s,
                      "leaky_relu")


def Sigmoid():
    return _Stateless(ops.sigmoid, lambda s: s, "sigmoid")


def Tanh():
    return _Stateless(ops.tanh, lambda s: s, "tanh")


def Swish():
    return _Stateless(ops.swish, lambda s: s, "swish")


def GELU(tanh_approx=False):
    return _Stateless(lambda x: ops.gelu(x, tanh_approx), lambda s: s, "gelu")


def Softmax():
    return _Stateless(ops.softmax, lambda s: s, "softmax")


def MaxPool(size=(2, 2), stride=None, padding="VALID"):
    return _Stateless(lambda x: ops.max_pool(x, size, stride, padding),
                      name="max_pool")


def AvgPool(size=(2, 2), stride=None, padding="VALID"):
    return _Stateless(lambda x: ops.avg_pool(x, size, stride, padding),
                      name="avg_pool")


def Flatten():
    """(B, ...) -> (B, prod(...)) in row-major order: NHWC flattens H, W, C
    with C fastest, as ``ccv_tpu``'s ``x.reshape(B, -1)``."""
    return _Stateless(lambda x: x.reshape(x.shape[0], -1),
                      lambda s: (s[0], math.prod(s[1:])), "flatten")


def Reshape(shape: Sequence[int]):
    return _Stateless(lambda x: x.reshape(x.shape[0], *shape),
                      lambda s: (s[0], *shape), "reshape")


def Identity():
    return _Stateless(lambda x: x, lambda s: s, "identity")


class Dropout(Layer):
    def __init__(self, rate: float, name: str = "dropout"):
        self.rate = rate
        self.name = name

    def apply(self, params, state, x, training=False, generator=None):
        if not training or self.rate == 0.0:
            return x, state
        return ops.dropout(x, self.rate, generator), state
