"""CNNP layers of the port (counterpart of ccv_tpu/nn/layers.py; reference:
lib/nnc/ccv_cnnp_model_addons.c).

A layer is a small object with ``init(generator, in_shape) -> (params,
state, out_shape)`` and ``apply(params, state, x, training=False,
generator=None) -> (y, new_state)``; ``ccv_tpu_torch.nn.model.Sequential``
composes them, and calling a layer on graph nodes (``layer(node)``) records
a node of a ``ccv_tpu_torch.nn.functional.Model``. Parameters and state
are dicts of tensors in ``ccv_tpu``'s layouts (convolution weights OHWI,
dense weights (d_in, d_out)), so ``ccv_tpu``'s parameters copy across
unchanged. ``init`` draws on the CPU from ``generator`` (a seeded
``torch.Generator``); the model moves the result to its device. Shapes
are inferred as ``ccv_tpu`` does with ``jax.eval_shape``: the op runs on
the ``meta`` device.

Initialization: Glorot-uniform for convolution and dense weights, zero
biases (the reference's default).

``ScaledDotProductAttention`` on the card at T >= 1024 runs the flash
kernels K2 (``ops/kernels/flash_attention.py``), else the plain op, as
``ccv_tpu`` routes it to its Pallas kernel (``attention_route``). The
layers' gradients run through autograd (K2's through K2b and K2c);
``BatchNorm`` in training normalises by the batch's statistics and returns
the running ones as its state.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch

from ccv_tpu_torch.nn import ops
from ccv_tpu_torch.ops.kernels import flash_attention as k2


class Layer:
    name: str = "layer"

    def init(self, generator: torch.Generator, in_shape):
        return {}, {}, tuple(in_shape)

    def apply(self, params, state, x, training=False, generator=None):
        raise NotImplementedError

    def __call__(self, *nodes):
        """Record this layer applied to graph nodes (ccv_cnnp_model_apply
        twin); ``apply`` runs it on tensors."""
        from ccv_tpu_torch.nn.functional import Node

        if not all(isinstance(n, Node) for n in nodes):
            raise TypeError("a layer call takes graph nodes; use apply() "
                            "for tensors")
        return Node(self, nodes)

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
    """ccv_cnnp_batch_norm; state carries the running mean and var. In
    training, y uses the batch's statistics over every axis but the last
    and the state becomes the updated running statistics (no gradient
    flows into them)."""

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
            y, mean, var = ops.batch_norm(
                x, params["scale"], params["bias"], state["mean"],
                state["var"], self.epsilon, is_training=True,
                momentum=self.momentum, axis=tuple(range(x.ndim - 1)))
            return y, {"mean": mean.detach(), "var": var.detach()}
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


class ConvolutionTranspose(Layer):
    """ccv_cnnp_convolution_transpose (model_addons.c:1309). The weight is
    drawn as (filters, kh, kw, cin), ``ccv_tpu``'s layout, and
    ``ops.conv2d_transpose`` reads its first axis as the input's channels,
    as ``ccv_tpu``'s does; so, as there, ``filters`` must equal the input's
    channels."""

    def __init__(self, filters: int, kernel=(3, 3), stride=(2, 2),
                 padding="SAME", no_bias: bool = False, name: str = "convT"):
        self.filters = filters
        self.kernel = tuple(kernel)
        self.stride = tuple(stride)
        self.padding = padding
        self.no_bias = no_bias
        self.name = name

    def init(self, generator, in_shape):
        cin = in_shape[-1]
        if cin != self.filters:
            raise ValueError(
                f"ConvolutionTranspose({self.filters}) on {cin} channels: "
                f"the (filters, kh, kw, cin) weight is read as (cin, kh, kw, "
                f"out), so filters must equal the input's channels")
        kh, kw = self.kernel
        w = _glorot(generator, (self.filters, kh, kw, cin), kh * kw * cin,
                    kh * kw * self.filters)
        params = {"w": w}
        if not self.no_bias:
            params["b"] = torch.zeros(self.filters)
        out = _meta_shape(lambda x: ops.conv2d_transpose(
            x, w.to("meta"), stride=self.stride, padding=self.padding),
            (1, *in_shape[-3:]))
        return params, {}, (*in_shape[:-3], *out[1:])

    def apply(self, params, state, x, training=False, generator=None):
        b = params["b"].to(x.dtype) if "b" in params else None
        y = ops.conv2d_transpose(x, params["w"].to(x.dtype), b,
                                 stride=self.stride, padding=self.padding)
        return y, state


class LayerNorm(Layer):
    def __init__(self, epsilon: float = 1e-5, axis=(-1,),
                 elementwise_affine: bool = True, name: str = "ln"):
        self.epsilon = epsilon
        self.axis = tuple(axis)
        self.affine = elementwise_affine
        self.name = name

    def init(self, generator, in_shape):
        if not self.affine:
            return {}, {}, tuple(in_shape)
        shape = tuple(in_shape[a] for a in self.axis)
        return ({"scale": torch.ones(shape), "bias": torch.zeros(shape)}, {},
                tuple(in_shape))

    def apply(self, params, state, x, training=False, generator=None):
        return ops.layer_norm(x, params.get("scale"), params.get("bias"),
                              self.epsilon, self.axis, self.affine), state


class GroupNorm(Layer):
    def __init__(self, groups: int = 32, epsilon: float = 1e-5,
                 name: str = "gn"):
        self.groups = groups
        self.epsilon = epsilon
        self.name = name

    def init(self, generator, in_shape):
        c = in_shape[-1]
        return ({"scale": torch.ones(c), "bias": torch.zeros(c)}, {},
                tuple(in_shape))

    def apply(self, params, state, x, training=False, generator=None):
        return ops.group_norm(x, params["scale"], params["bias"],
                              self.groups, self.epsilon), state


class RMSNorm(Layer):
    def __init__(self, epsilon: float = 1e-6, name: str = "rmsnorm"):
        self.epsilon = epsilon
        self.name = name

    def init(self, generator, in_shape):
        return {"scale": torch.ones(in_shape[-1])}, {}, tuple(in_shape)

    def apply(self, params, state, x, training=False, generator=None):
        return ops.rmsnorm(x, params["scale"], self.epsilon), state


class Embedding(Layer):
    """ccv_cnnp_embedding: rows of a learned (vocab, dim) table, drawn
    N(0, 0.02^2)."""

    def __init__(self, vocab: int, dim: int, name: str = "embedding"):
        self.vocab = vocab
        self.dim = dim
        self.name = name

    def init(self, generator, in_shape):
        table = torch.randn((self.vocab, self.dim), generator=generator) * 0.02
        return {"table": table}, {}, (*in_shape, self.dim)

    def apply(self, params, state, x, training=False, generator=None):
        return ops.index_select(params["table"], x, 0), state


def Permute(perm: Sequence[int]):
    return _Stateless(lambda x: x.permute(tuple(perm)),
                      lambda s: tuple(s[p] for p in perm), "permute")


def Transpose(axis_a: int, axis_b: int):
    """ccv_cnnp_transpose twin (ccv_nnc.h:4513): swap two axes."""

    def shape(s):
        t = list(s)
        t[axis_a], t[axis_b] = t[axis_b], t[axis_a]
        return tuple(t)

    return _Stateless(lambda x: torch.swapaxes(x, axis_a, axis_b), shape,
                      "transpose")


def Pad(begin, end, mode="zero"):
    return _Stateless(lambda x: ops.pad(x, begin, end, mode), name="pad")


def Upsample(hfactor=2.0, wfactor=2.0, mode="bilinear"):
    return _Stateless(lambda x: ops.upsample(x, hfactor, wfactor, mode),
                      name="upsample")


class LSTM(Layer):
    """ccv_cnnp_lstm (model_addons.c:3460), one layer, batch first: (B, T,
    I) -> (B, T, H), or (B, T, 2H) bidirectional (the reverse pass's
    outputs after the forward's)."""

    def __init__(self, hidden: int, bidirectional: bool = False,
                 name: str = "lstm"):
        self.hidden = hidden
        self.bidirectional = bidirectional
        self.name = name

    def init(self, generator, in_shape):
        i, h = in_shape[-1], self.hidden
        params = {"w_ih": _glorot(generator, (i, 4 * h), i, 4 * h),
                  "w_hh": _glorot(generator, (h, 4 * h), h, 4 * h),
                  "b_ih": torch.zeros(4 * h), "b_hh": torch.zeros(4 * h)}
        if self.bidirectional:
            params.update({
                "w_ih_r": _glorot(generator, (i, 4 * h), i, 4 * h),
                "w_hh_r": _glorot(generator, (h, 4 * h), h, 4 * h),
                "b_ih_r": torch.zeros(4 * h), "b_hh_r": torch.zeros(4 * h)})
        out = (*in_shape[:-1], h * (2 if self.bidirectional else 1))
        return params, {}, out

    def apply(self, params, state, x, training=False, generator=None):
        xt = torch.swapaxes(x, 0, 1)  # (T, B, I)
        ys, _, _ = ops.lstm(xt, params["w_ih"], params["w_hh"],
                            params["b_ih"], params["b_hh"])
        out = torch.swapaxes(ys, 0, 1)
        if self.bidirectional:
            ys_r, _, _ = ops.lstm(xt, params["w_ih_r"], params["w_hh_r"],
                                  params["b_ih_r"], params["b_hh_r"],
                                  reverse=True)
            out = torch.cat([out, torch.swapaxes(ys_r, 0, 1)], dim=-1)
        return out, state


FLASH_MIN_T = 1024  # the sequence length from which attention takes K2


def attention_route(device_type: str, t: int) -> str:
    """"flash" (K2) or "plain" for attention over ``t`` positions on a
    device of ``device_type``: K2 on the card from ``FLASH_MIN_T`` on, the
    plain op on the CPU or below it. No flag changes the route: on a CUDA
    tensor at that length the layer launches K2 or raises."""
    if device_type == "cuda" and t >= FLASH_MIN_T:
        return "flash"
    return "plain"


class ScaledDotProductAttention(Layer):
    """ccv_cnnp_scaled_dot_product_attention (model_addons.c:3979) with the
    optional fused QKV projection; input (B, T, D), ``dim`` per head.

    On a CUDA tensor with T >= ``FLASH_MIN_T`` attention runs the flash
    kernels (``flash_attention``: K2a forward, K2b / K2c backward), else
    the plain ``ops.scaled_dot_product_attention`` (``attention_route``). The
    kernels take every head dim, as ``ccv_tpu``'s padding to a multiple of
    128 lanes does (``flash_attention`` zero-pads D to 32, 64, 128 or 256,
    above that to a multiple of 64), in float32, bfloat16 and float16."""

    def __init__(self, heads: int, dim: int, is_causal: bool = False,
                 fused_qkv: bool = True, out_proj: bool = True,
                 name: str = "attention"):
        self.heads = heads
        self.dim = dim
        self.is_causal = is_causal
        self.fused_qkv = fused_qkv
        self.out_proj = out_proj
        self.name = name

    def init(self, generator, in_shape):
        d = in_shape[-1]
        inner = self.heads * self.dim
        params = {}
        if self.fused_qkv:
            params["wqkv"] = _glorot(generator, (d, 3 * inner), d, 3 * inner)
        else:
            for k in ("wq", "wk", "wv"):
                params[k] = _glorot(generator, (d, inner), d, inner)
        out_d = d
        if self.out_proj:
            params["wo"] = _glorot(generator, (inner, d), inner, d)
        else:
            out_d = inner
        return params, {}, (*in_shape[:-1], out_d)

    def _use_flash(self, x: torch.Tensor) -> bool:
        return attention_route(x.device.type, x.shape[1]) == "flash"

    def apply(self, params, state, x, training=False, generator=None):
        B, T, _ = x.shape
        inner = self.heads * self.dim
        if self.fused_qkv:
            qkv = torch.matmul(x, params["wqkv"].to(x.dtype))
            q, k, v = torch.chunk(qkv, 3, dim=-1)
        else:
            q, k, v = (torch.matmul(x, params[n].to(x.dtype))
                       for n in ("wq", "wk", "wv"))
        q, k, v = (t.reshape(B, T, self.heads, self.dim) for t in (q, k, v))
        if self._use_flash(x):
            out = k2.flash_attention(q, k, v, None, self.is_causal)
        else:
            out = ops.scaled_dot_product_attention(q, k, v,
                                                   is_causal=self.is_causal)
        out = out.reshape(B, T, inner)
        if self.out_proj:
            out = torch.matmul(out, params["wo"].to(x.dtype))
        return out, state
