"""Neural-network ops of the port (counterpart of ccv_tpu/nn/ops.py).

The part the image-classification path and the LM use: tensor formats,
``gemm``, ``conv2d``, activations, ``dropout``, the pools, ``batch_norm``
at inference, and scaled-dot-product attention (the reference the flash
kernels, ccv_tpu_torch/ops/kernels/flash_attention.py, are held to).

Layout is NHWC by default, as in ``ccv_tpu``; convolution weights are OHWI.
cuDNN gets NCHW views (``x.permute(0, 3, 1, 2)`` of an NHWC tensor is a
channels-last NCHW tensor, no copy; OHWI -> OIHW likewise). Padding follows
XLA: ``"SAME"`` pads ``max((out - 1) * s + k_eff - in, 0)`` in all, the
lower half first, so stride 2 or an even kernel pads more at the bottom and
right, which torch's symmetric ``padding=`` cannot say: such pads are
explicit (zeros for a convolution, -inf for a max, excluded from the count
of an average).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

# tensor formats (reference: CCV_TENSOR_FORMAT_*, lib/nnc/ccv_nnc.h:45-49)
FORMAT_NHWC = "NHWC"
FORMAT_NCHW = "NCHW"
FORMAT_CHWN = "CHWN"
FORMATS = (FORMAT_NHWC, FORMAT_NCHW, FORMAT_CHWN)

# format -> position of (N, H, W, C)
_FORMAT_AXES = {
    FORMAT_NHWC: (0, 1, 2, 3),
    FORMAT_NCHW: (0, 2, 3, 1),
    FORMAT_CHWN: (3, 1, 2, 0),
}

Padding = Union[str, int, Sequence[Tuple[int, int]]]


def format_perm(src: str, dst: str) -> Tuple[int, ...]:
    """The ``permute`` order converting format ``src`` -> ``dst``."""
    s, d = _FORMAT_AXES[src], _FORMAT_AXES[dst]
    perm = [0] * 4
    for k in range(4):  # semantic dim k (N, H, W, C): dst position <- src
        perm[d[k]] = s[k]
    return tuple(perm)


def _to_nchw(x: torch.Tensor, format: str) -> torch.Tensor:
    return x.permute(format_perm(format, FORMAT_NCHW))


def _from_nchw(y: torch.Tensor, format: str) -> torch.Tensor:
    return y.permute(format_perm(FORMAT_NCHW, format))


def _pads(padding: Padding, size: Sequence[int], kernel: Sequence[int],
          stride: Sequence[int],
          dilation: Sequence[int] = (1, 1)) -> Tuple[Tuple[int, int], ...]:
    """((top, bottom), (left, right)) as XLA pads for ``padding``: "SAME",
    "VALID", an int for every side, or (lo, hi) pairs for H and W."""
    if isinstance(padding, str):
        if padding == "VALID":
            return ((0, 0), (0, 0))
        if padding != "SAME":
            raise ValueError(f"padding {padding!r}")
        out = []
        for n, k, s, d in zip(size, kernel, stride, dilation):
            k_eff = (k - 1) * d + 1
            total = max((-(-n // s) - 1) * s + k_eff - n, 0)
            out.append((total // 2, total - total // 2))
        return tuple(out)
    if isinstance(padding, int):
        return ((padding, padding), (padding, padding))
    return tuple((int(lo), int(hi)) for lo, hi in padding)


def _pad(x: torch.Tensor, pads, value: float = 0.0) -> torch.Tensor:
    """Pad the last two axes of an NCHW tensor by ((top, bottom), (left,
    right))."""
    (t, b), (l, r) = pads
    return F.pad(x, (l, r, t, b), value=value)


# ---------------------------------------------------------------------------
# blas
# ---------------------------------------------------------------------------

def gemm(a: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
         transpose_a: bool = False, transpose_b: bool = False) -> torch.Tensor:
    """CCV_NNC_GEMM_FORWARD: a @ w (optionally transposed) + bias, in a's
    type. The product is summed in float32 and the bias added to the sum
    before the cast, as ``ccv_tpu`` (``preferred_element_type=float32``)."""
    x = a.mT if transpose_a else a
    y = w.mT if transpose_b else w
    out = torch.matmul(x.float(), y.float())
    if bias is not None:
        out = out + bias
    return out.to(a.dtype)


# ---------------------------------------------------------------------------
# convolution
# ---------------------------------------------------------------------------

def conv2d(x: torch.Tensor, w: torch.Tensor,
           bias: Optional[torch.Tensor] = None, stride=(1, 1),
           padding: Padding = "SAME", dilation=(1, 1), groups: int = 1,
           format: str = FORMAT_NHWC) -> torch.Tensor:
    """CCV_NNC_CONVOLUTION_FORWARD of a 4-D ``x`` in ``format`` with OHWI
    weights ``w`` (O, kh, kw, I / groups); ``bias`` per output channel.

    The sum is in float32 and the bias is taken in x's type (``F.conv2d``
    wants it so). ``ccv_tpu`` adds its float32 bias to the float32 sum and
    rounds once. The CPU's convolution adds the bias before its one rounding
    too; on CUDA, cuDNN rounds the sum to x's type and torch then adds the
    bias in x's type, so a bf16 convolution with a bias rounds twice there
    (a float32 one loses nothing). Symmetric pads go to the convolution,
    others are zeros padded first."""
    stride, dilation = tuple(stride), tuple(dilation)
    xc = _to_nchw(x, format)
    kernel = (w.shape[1], w.shape[2])
    pads = _pads(padding, xc.shape[2:], kernel, stride, dilation)
    sym = tuple(lo for lo, hi in pads)
    if any(lo != hi for lo, hi in pads):
        xc, sym = _pad(xc, pads), (0, 0)
    b = None if bias is None else bias.to(x.dtype)
    y = F.conv2d(xc, w.permute(0, 3, 1, 2), b, stride, sym, dilation, groups)
    return _from_nchw(y, format)


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01) -> torch.Tensor:
    return torch.where(x >= 0, x, negative_slope * x)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x)


def tanh(x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x)


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def gelu(x: torch.Tensor, tanh_approx: bool = False) -> torch.Tensor:
    return F.gelu(x, approximate="tanh" if tanh_approx else "none")


def softmax(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    return torch.softmax(x, dim=axis)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator] = None,
            entirety: bool = False) -> torch.Tensor:
    """CCV_NNC_DROPOUT_FORWARD: inverted dropout (kept values scaled by
    1 / (1 - rate)); ``entirety`` drops the whole tensor with probability
    ``rate``. ``generator`` lives on x's device."""
    shape = () if entirety else x.shape
    keep = torch.rand(shape, generator=generator, device=x.device) < 1 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                           device=x.device))


# ---------------------------------------------------------------------------
# pooling
# ---------------------------------------------------------------------------

def _pool_pads(x: torch.Tensor, size, stride, padding, format: str):
    """(x as NCHW, XLA's pads for its H and W). ``padding`` is "SAME",
    "VALID" or ``reduce_window``'s (lo, hi) pair for each of x's 4 axes."""
    xc = _to_nchw(x, format)
    if isinstance(padding, str):
        return xc, _pads(padding, xc.shape[2:], size, stride)
    pairs = [tuple(padding[a]) for a in _FORMAT_AXES[format]]  # N, H, W, C
    if any(pairs[k] != (0, 0) for k in (0, 3)):
        raise NotImplementedError("pooling pads only H and W")
    return xc, (pairs[1], pairs[2])


def max_pool(x: torch.Tensor, size=(2, 2), stride=None,
             padding="VALID", format: str = FORMAT_NHWC) -> torch.Tensor:
    """``reduce_window`` max: pads are -inf, so they never win."""
    size = tuple(size)
    stride = tuple(stride or size)
    xc, pads = _pool_pads(x, size, stride, padding, format)
    if any(p for pair in pads for p in pair):
        xc = _pad(xc, pads, -math.inf)
    return _from_nchw(F.max_pool2d(xc, size, stride), format)


def avg_pool(x: torch.Tensor, size=(2, 2), stride=None, padding="VALID",
             count_include_pad: bool = False,
             format: str = FORMAT_NHWC) -> torch.Tensor:
    """``reduce_window`` sums in float32 over the padded input, divided by
    the window's size (``"VALID"`` or ``count_include_pad``) or by the
    count of its cells inside the input, then cast to x's type."""
    size = tuple(size)
    stride = tuple(stride or size)
    xc, pads = _pool_pads(x.float(), size, stride, padding, format)
    summed = F.avg_pool2d(_pad(xc, pads), size, stride, divisor_override=1)
    if count_include_pad or padding == "VALID":
        out = summed / (size[0] * size[1])
    else:
        ones = torch.ones((1, 1) + tuple(xc.shape[2:]), device=x.device)
        counts = F.avg_pool2d(_pad(ones, pads), size, stride,
                              divisor_override=1)
        out = summed / counts
    return _from_nchw(out, format).to(x.dtype)


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------

def batch_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               mean: torch.Tensor, var: torch.Tensor, epsilon: float = 1e-5,
               format: Optional[str] = None) -> torch.Tensor:
    """CCV_NNC_BATCH_NORM_FORWARD at inference, in float32, cast back to
    x's type. Scale, bias, mean and var are per channel: along the
    format's channel axis with ``format``, else along the last axis."""
    if format is not None:
        shape = [1] * 4
        shape[_FORMAT_AXES[format][3]] = -1
        scale, bias = scale.reshape(shape), bias.reshape(shape)
        mean, var = mean.reshape(shape), var.reshape(shape)
    y = (x.float() - mean) * torch.rsqrt(var + epsilon) * scale + bias
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def scaled_dot_product_attention(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor,
                                 scale: Optional[float] = None,
                                 is_causal: bool = False, mask=None,
                                 bias=None) -> torch.Tensor:
    """CCV_NNC_SCALED_DOT_PRODUCT_ATTENTION_FORWARD on (B, T, H, D).

    Scores are input-type products summed in float32 (JAX's
    ``preferred_element_type=float32``); the causal mask is aligned
    bottom-right, ``tril(ones(Tq, Tk), Tk - Tq)``, masked scores are -inf;
    the probabilities are cast to v's type before the second product and
    the output to q's type. ``mask`` broadcasts against the (B, H, Tq, Tk)
    scores, True = keep."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias
    if is_causal:
        tq, tk = logits.shape[-2], logits.shape[-1]
        causal = torch.ones(tq, tk, dtype=torch.bool,
                            device=q.device).tril(tk - tq)
        logits = logits.masked_fill(~causal, -math.inf)
    if mask is not None:
        logits = logits.masked_fill(~mask, -math.inf)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(q.dtype)
