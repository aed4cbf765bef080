"""Neural-network ops of the port (counterpart of ccv_tpu/nn/ops.py).

The forward commands: tensor formats, ``gemm``, the elementwise family,
``conv2d`` and ``conv2d_transpose``, activations, ``dropout``, the pools,
the norms (``batch_norm`` at inference), the losses (forward), the
reductions, layout and utility commands, ``upsample``, ``histogram``, the
random commands, ``nms``, ``roi_align``, scaled-dot-product attention (the
reference the flash kernels, ccv_tpu_torch/ops/kernels/flash_attention.py,
are held to) and ``lstm``. Integer results (argmax, histogram, nms's order)
are torch's int64 where ``ccv_tpu`` gives int32; the values are the same.

Layout is NHWC by default, as in ``ccv_tpu``; convolution weights are OHWI.
cuDNN gets NCHW views (``x.permute(0, 3, 1, 2)`` of an NHWC tensor is a
channels-last NCHW tensor, no copy; OHWI -> OIHW likewise). Padding follows
XLA: ``"SAME"`` pads ``max((out - 1) * s + k_eff - in, 0)`` in all, the
lower half first, so stride 2 or an even kernel pads more at the bottom and
right, which torch's symmetric ``padding=`` cannot say: such pads are
explicit (zeros for a convolution, -inf for a max, excluded from the count
of an average).

Where an op says it sums or normalises "in float32" (``gemm``, the pools,
the norms, ``upsample``), a float64 input keeps float64 (``_wide``): the
casts widen half types and never narrow a float64 tensor.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from ccv_tpu_torch import device as _device
from ccv_tpu_torch.parallel import data as _data

# tensor formats (reference: CCV_TENSOR_FORMAT_*, lib/nnc/ccv_nnc.h:45-49)
FORMAT_NHWC = "NHWC"
FORMAT_NCHW = "NCHW"
FORMAT_CHWN = "CHWN"
FORMATS = (FORMAT_NHWC, FORMAT_NCHW, FORMAT_CHWN)



def _wide(x: torch.Tensor, *others: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, or in float64 when it or one of ``others`` is
    float64."""
    wide = any(t.dtype == torch.float64 for t in (x, *others))
    return x.to(torch.float64 if wide else torch.float32)


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
    """Pad the trailing axes of an NCHW tensor by XLA's (lo, hi) pairs,
    the last axis last: ((top, bottom), (left, right)), or N's and C's
    pairs before those; x itself where every pad is 0."""
    flat = [p for pair in reversed(pads) for p in pair]
    return F.pad(x, flat, value=value) if any(flat) else x


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
    out = torch.matmul(_wide(x, y), _wide(y, x))
    if bias is not None:
        out = out + bias
    return out.to(a.dtype)


def add(a: torch.Tensor, b: torch.Tensor, p: float = 1.0,
        q: float = 1.0) -> torch.Tensor:
    """CCV_NNC_ADD_FORWARD: p*a + q*b (broadcasting)."""
    return p * a + q * b


def mul(a: torch.Tensor, b: torch.Tensor, p: float = 1.0) -> torch.Tensor:
    """CCV_NNC_MUL_FORWARD: p*a*b (broadcasting)."""
    return p * a * b


def scalar_mul(a: torch.Tensor, p: float) -> torch.Tensor:
    return p * a


def cmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """CCV_NNC_CMUL_FORWARD: complex products of the interleaved (re, im)
    pairs of the last axis."""
    ar, ai = a[..., 0::2], a[..., 1::2]
    br, bi = b[..., 0::2], b[..., 1::2]
    out = torch.stack([ar * br - ai * bi, ar * bi + ai * br], dim=-1)
    return out.reshape(a.shape)


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


def _transpose_pads(padding: Padding, kernel, stride, dilation):
    """lax.conv_transpose's pads of the lhs-dilated input, ((lo, hi) for H,
    W): for "SAME" k + s - 2 in all, the lower ``k - 1`` when ``s > k - 1``
    else ceil of half; for "VALID" ``k + s - 2 + max(k - s, 0)``, the lower
    ``k - 1`` (k the dilated kernel); explicit pairs as given."""
    if isinstance(padding, int):
        return ((padding, padding), (padding, padding))
    if not isinstance(padding, str):
        return tuple((int(lo), int(hi)) for lo, hi in padding)
    out = []
    for k, s, d in zip(kernel, stride, dilation):
        k = (k - 1) * d + 1
        if padding == "SAME":
            total = k + s - 2
            lo = k - 1 if s > k - 1 else -(-total // 2)
        elif padding == "VALID":
            total = k + s - 2 + max(k - s, 0)
            lo = k - 1
        else:
            raise ValueError(f"padding {padding!r}")
        out.append((lo, total - lo))
    return tuple(out)


def conv2d_transpose(x: torch.Tensor, w: torch.Tensor,
                     bias: Optional[torch.Tensor] = None, stride=(1, 1),
                     padding: Padding = "SAME", dilation=(1, 1),
                     groups: int = 1) -> torch.Tensor:
    """CCV_NNC_CONVOLUTION_TRANSPOSE_FORWARD of NHWC ``x``, as
    ``lax.conv_transpose(..., transpose_kernel=True)`` with ("NHWC", "OHWI",
    "NHWC"): ``w`` is read as (x's channels, kh, kw, out channels / groups),
    its first axis split into the groups.

    That is the forward convolution of the stride-dilated input with the
    flipped kernel and lax's pads (``_transpose_pads``), which equals
    ``conv_transpose2d`` at padding 0 (the full output: pads k - 1 on both
    sides) cut or zero-extended to those pads. The bias is added in x's
    type after the convolution."""
    stride, dilation = tuple(stride), tuple(dilation)
    kernel = (w.shape[1], w.shape[2])
    pads = _transpose_pads(padding, kernel, stride, dilation)
    full = F.conv_transpose2d(x.permute(0, 3, 1, 2), w.permute(0, 3, 1, 2),
                              None, stride, 0, 0, groups, dilation)
    crop = []
    for (lo, hi), k, d in zip(pads, kernel, dilation):
        k_eff = (k - 1) * d + 1
        crop.append((lo - (k_eff - 1), hi - (k_eff - 1)))
    (t, b), (l, r) = crop
    out = F.pad(full, (l, r, t, b)).permute(0, 2, 3, 1)
    if bias is not None:
        out = out + bias.to(x.dtype)
    return out.to(x.dtype)


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
    # under data parallelism, this rank's rows of the global batch's mask
    keep = _data.rand(shape, generator, x.device) < 1 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                           device=x.device))


# ---------------------------------------------------------------------------
# elementwise (lib/nnc/cmd/ew, cmd/compare)
# ---------------------------------------------------------------------------

def ewsum(*xs: torch.Tensor) -> torch.Tensor:
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out


def ewprod(*xs: torch.Tensor) -> torch.Tensor:
    out = xs[0]
    for x in xs[1:]:
        out = out * x
    return out


def ewdiv(a, b) -> torch.Tensor:
    """a / b, rounded once on every device. Either may be a Python number:
    CUDA multiplies by the reciprocal of a Python-number divisor, and
    ``number / tensor`` is a reciprocal times the number, each a second
    rounding that the CPU's (and ``ccv_tpu``'s) division does not make, so
    a number goes as a 0-dim tensor on the other's device."""
    if not isinstance(a, torch.Tensor):
        a = torch.full((), a, dtype=b.dtype, device=b.device)
    elif not isinstance(b, torch.Tensor):
        b = torch.full((), b, dtype=a.dtype, device=a.device)
    return a / b


def ewexp(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(x)


def ewlog(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x)


def ewsqrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(x)


def ewabs(x: torch.Tensor) -> torch.Tensor:
    return torch.abs(x)


def ewneg(x: torch.Tensor) -> torch.Tensor:
    return -x


def clamp(x: torch.Tensor, lo=None, hi=None) -> torch.Tensor:
    if lo is not None:
        x = torch.clamp(x, min=lo)
    if hi is not None:
        x = torch.clamp(x, max=hi)
    return x


def ewmin(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """CCV_NNC_MIN_FORWARD."""
    return torch.minimum(a, b)


def ewmax(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """CCV_NNC_MAX_FORWARD."""
    return torch.maximum(a, b)


# ---------------------------------------------------------------------------
# pooling
# ---------------------------------------------------------------------------

def _pool_pads(x: torch.Tensor, size, stride, padding, format: str):
    """(x as NCHW, XLA's pads for its N, C, H and W). ``padding`` is
    "SAME", "VALID" or ``reduce_window``'s (lo, hi) pair for each of x's 4
    axes; the window and stride are 1 on N and C, so a pad there adds
    pad-only cells to the output, as ``reduce_window`` does."""
    xc = _to_nchw(x, format)
    if isinstance(padding, str):
        return xc, ((0, 0), (0, 0),
                    *_pads(padding, xc.shape[2:], size, stride))
    pairs = [tuple(padding[a]) for a in _FORMAT_AXES[format]]  # N, H, W, C
    return xc, (pairs[0], pairs[3], pairs[1], pairs[2])


def max_pool(x: torch.Tensor, size=(2, 2), stride=None,
             padding="VALID", format: str = FORMAT_NHWC) -> torch.Tensor:
    """``reduce_window`` max: pads are -inf (an integer type's least
    value), so they never win, and a window of pads alone gives them."""
    size = tuple(size)
    stride = tuple(stride or size)
    xc, pads = _pool_pads(x, size, stride, padding, format)
    low = -math.inf if x.dtype.is_floating_point else torch.iinfo(x.dtype).min
    return _from_nchw(F.max_pool2d(_pad(xc, pads, low), size, stride),
                      format)


def avg_pool(x: torch.Tensor, size=(2, 2), stride=None, padding="VALID",
             count_include_pad: bool = False,
             format: str = FORMAT_NHWC) -> torch.Tensor:
    """``reduce_window`` sums in float32 over the padded input, divided by
    the window's size (``"VALID"`` or ``count_include_pad``) or by the
    count of its cells inside the input (0 / 0, NaN, on a window of pads
    alone), then cast to x's type."""
    size = tuple(size)
    stride = tuple(stride or size)
    xc, pads = _pool_pads(_wide(x), size, stride, padding, format)
    summed = F.avg_pool2d(_pad(xc, pads), size, stride,
                          divisor_override=1)
    if count_include_pad or padding == "VALID":
        out = summed / (size[0] * size[1])
    else:
        # N and C only where they are padded; elsewhere 1 and broadcast
        nc = [n if any(pad) else 1 for n, pad in zip(xc.shape[:2], pads)]
        ones = torch.ones(nc + list(xc.shape[2:]), device=x.device)
        counts = F.avg_pool2d(_pad(ones, pads), size, stride,
                              divisor_override=1)
        out = summed / counts
    return _from_nchw(out, format).to(x.dtype)


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------

def batch_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               mean: torch.Tensor, var: torch.Tensor, epsilon: float = 1e-5,
               is_training: bool = False, momentum: float = 0.9,
               axis: Sequence[int] = (0, 1, 2),
               format: Optional[str] = None):
    """CCV_NNC_BATCH_NORM_FORWARD, in float32, cast back to x's type. At
    inference y; scale, bias, mean and var are per channel: along the
    format's channel axis with ``format``, else along the last axis.

    With ``is_training``: (y, new_mean, new_var) from the batch statistics
    over ``axis`` (every axis but the format's channel axis with
    ``format``), the population variance in float32; the running
    statistics become ``momentum * old + (1 - momentum) * batch``. Under
    data parallelism (``parallel.data.sharded``) the statistics are the
    global batch's: the sums and squared deviations are allreduced."""
    if format is not None:
        c_axis = _FORMAT_AXES[format][3]
        axis = tuple(i for i in range(4) if i != c_axis)
        shape = [1] * 4
        shape[c_axis] = -1
        scale, bias = scale.reshape(shape), bias.reshape(shape)
        mean, var = mean.reshape(shape), var.reshape(shape)
    if not is_training:
        y = (_wide(x) - mean) * torch.rsqrt(var + epsilon) * scale + bias
        return y.to(x.dtype)
    xf = _wide(x)
    m, v = _batch_mean_var(xf, tuple(axis))
    if format is None:
        m, v = m.reshape(mean.shape), v.reshape(var.shape)
    y = (xf - m) * torch.rsqrt(v + epsilon) * scale + bias
    new_mean = momentum * mean + (1 - momentum) * m
    new_var = momentum * var + (1 - momentum) * v
    if format is not None:
        new_mean, new_var = new_mean.reshape(-1), new_var.reshape(-1)
    return y.to(x.dtype), new_mean, new_var


def _mean_var(xf: torch.Tensor, axis) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jnp.mean`` and ``jnp.var`` (population, ``mean(|x - mean|^2)``)
    over ``axis``, keeping the reduced axes."""
    m = xf.mean(dim=axis, keepdim=True)
    c = xf - m
    return m, (c * c).mean(dim=axis, keepdim=True)


def _batch_mean_var(xf: torch.Tensor, axis
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_mean_var`` over the global batch: on one rank the same; inside
    ``parallel.data.sharded`` the mean from the sum allreduced over the
    ranks that split a dimension of ``axis``, then the variance from the
    squared deviations allreduced alike (SyncBatchNorm's two passes, both
    differentiable). A split dimension outside ``axis`` indexes the
    statistics, so its ranks keep their own."""
    axis = tuple(a % xf.ndim for a in axis)
    if _data.parts(axis) == 1:
        return _mean_var(xf, axis)
    n = math.prod(xf.shape[a] for a in axis) * _data.parts(axis)
    m = _data.global_sum(xf.sum(dim=axis, keepdim=True), dims=axis) / n
    c = xf - m
    return m, _data.global_sum((c * c).sum(dim=axis, keepdim=True),
                               dims=axis) / n


def layer_norm(x: torch.Tensor, scale: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None, epsilon: float = 1e-5,
               axis: Sequence[int] = (-1,),
               elementwise_affine: bool = True) -> torch.Tensor:
    """CCV_NNC_LAYER_NORM_FORWARD, in float32, cast back to x's type."""
    xf = _wide(x)
    m, v = _mean_var(xf, tuple(axis))
    y = (xf - m) * torch.rsqrt(v + epsilon)
    if elementwise_affine and scale is not None:
        y = y * scale
        if bias is not None:
            y = y + bias
    return y.to(x.dtype)


def group_norm(x: torch.Tensor, scale: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None, groups: int = 32,
               epsilon: float = 1e-5, channel_axis: int = -1) -> torch.Tensor:
    """CCV_NNC_GROUP_NORM_FORWARD: statistics per sample and channel group
    over every other axis, in float32; scale and bias broadcast along the
    last axis, as ``ccv_tpu``'s."""
    xf = _wide(x)
    c = xf.shape[channel_axis]
    if c % groups:
        raise ValueError(f"{c} channels do not split into {groups} groups")
    moved = torch.movedim(xf, channel_axis, -1)
    g = moved.reshape(*moved.shape[:-1], groups, c // groups)
    red = tuple(range(1, g.ndim - 2)) + (g.ndim - 1,)
    m, v = _mean_var(g, red)
    g = (g - m) * torch.rsqrt(v + epsilon)
    y = torch.movedim(g.reshape(moved.shape), -1, channel_axis)
    if scale is not None:
        y = y * scale
    if bias is not None:
        y = y + bias
    return y.to(x.dtype)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, epsilon: float = 1e-6,
            axis: Sequence[int] = (-1,)) -> torch.Tensor:
    """CCV_NNC_RMSNORM_FORWARD, in float32, cast back to x's type."""
    xf = _wide(x)
    ms = (xf * xf).mean(dim=tuple(axis), keepdim=True)
    return (xf * torch.rsqrt(ms + epsilon) * scale).to(x.dtype)


# ---------------------------------------------------------------------------
# losses, forward (lib/nnc/cmd/loss, softmax_loss, sigmoid_loss)
# ---------------------------------------------------------------------------

def _integer(t: torch.Tensor) -> bool:
    return not (t.is_floating_point() or t.is_complex()
                or t.dtype == torch.bool)


def _onehot(labels: torch.Tensor, n: int, trim0: float, trim1: float,
            dtype: torch.dtype) -> torch.Tensor:
    return F.one_hot(labels.long(), n).to(dtype) * (trim1 - trim0) + trim0


def mse_loss(x: torch.Tensor, y: torch.Tensor,
             reduce_mean: bool = True) -> torch.Tensor:
    d = (x - y) ** 2
    return d.mean(dim=-1) if reduce_mean else d.sum(dim=-1)


def mae_loss(x: torch.Tensor, y: torch.Tensor,
             reduce_mean: bool = True) -> torch.Tensor:
    d = torch.abs(x - y)
    return d.mean(dim=-1) if reduce_mean else d.sum(dim=-1)


def smooth_l1_loss(x: torch.Tensor, y: torch.Tensor,
                   beta: float = 1.0) -> torch.Tensor:
    d = torch.abs(x - y)
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta).sum(-1)


def categorical_crossentropy(probs: torch.Tensor, labels: torch.Tensor,
                             trim0: float = 0.0,
                             trim1: float = 1.0) -> torch.Tensor:
    """CCV_NNC_CATEGORICAL_CROSSENTROPY_FORWARD on probabilities: integer
    labels index classes (smoothed by ``trim0`` / ``trim1``), float labels
    are soft targets."""
    logp = torch.log(torch.clamp(probs, min=1e-12))
    if _integer(labels):
        if trim0 == 0.0 and trim1 == 1.0:
            return -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
        onehot = _onehot(labels, probs.shape[-1], trim0, trim1, logp.dtype)
        return -(onehot * logp).sum(-1)
    return -(labels * logp).sum(-1)


def softmax_crossentropy(logits: torch.Tensor, labels: torch.Tensor,
                         trim0: float = 0.0, trim1: float = 1.0):
    """CCV_NNC_SOFTMAX_CROSSENTROPY_FORWARD: (loss, softmax), through
    logsumexp."""
    logp = logits - torch.logsumexp(logits, dim=-1, keepdim=True)
    if _integer(labels):
        if trim0 == 0.0 and trim1 == 1.0:
            loss = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
        else:
            onehot = _onehot(labels, logits.shape[-1], trim0, trim1,
                             logp.dtype)
            loss = -(onehot * logp).sum(-1)
    else:
        loss = -(labels * logp).sum(-1)
    return loss, torch.exp(logp)


def binary_crossentropy(probs: torch.Tensor, labels: torch.Tensor,
                        pos_weight: float = 1.0) -> torch.Tensor:
    logp = torch.log(torch.clamp(probs, min=1e-12))
    logn = torch.log(torch.clamp(1.0 - probs, min=1e-12))
    return (-(pos_weight * labels * logp + (1 - labels) * logn)).sum(-1)


def sigmoid_binary_crossentropy(logits: torch.Tensor, labels: torch.Tensor,
                                pos_weight: float = 1.0):
    """CCV_NNC_SIGMOID_BINARY_CROSSENTROPY_FORWARD: (loss, sigmoid)."""
    out = -(pos_weight * labels * F.logsigmoid(logits)
            + (1 - labels) * F.logsigmoid(-logits))
    return out.sum(-1), torch.sigmoid(logits)


# ---------------------------------------------------------------------------
# reduce (lib/nnc/cmd/reduce)
# ---------------------------------------------------------------------------

def reduce_sum(x: torch.Tensor, axis, keepdims: bool = True) -> torch.Tensor:
    return x.sum(dim=tuple(axis), keepdim=keepdims)


def reduce_mean(x: torch.Tensor, axis, keepdims: bool = True) -> torch.Tensor:
    return x.mean(dim=tuple(axis), keepdim=keepdims)


def reduce_max(x: torch.Tensor, axis, keepdims: bool = True) -> torch.Tensor:
    return torch.amax(x, dim=tuple(axis), keepdim=keepdims)


def reduce_min(x: torch.Tensor, axis, keepdims: bool = True) -> torch.Tensor:
    return torch.amin(x, dim=tuple(axis), keepdim=keepdims)


def reduce_norm2(x: torch.Tensor, axis, keepdims: bool = True) -> torch.Tensor:
    return torch.sqrt((x * x).sum(dim=tuple(axis), keepdim=keepdims))


def argmax(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """The first index of the largest value."""
    return torch.argmax(x, dim=axis)


def argmin(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    return torch.argmin(x, dim=axis)


def reduce_isnan(x: torch.Tensor, axis, keepdims: bool = True) -> torch.Tensor:
    """CCV_NNC_REDUCE_ISNAN_FORWARD: any NaN over ``axis``."""
    return torch.isnan(x).any(dim=tuple(axis), keepdim=keepdims)


# ---------------------------------------------------------------------------
# util / layout (lib/nnc/cmd/util, pad, index, upsample, histogram)
# ---------------------------------------------------------------------------

def format_transform(x: torch.Tensor, perm: Optional[Sequence[int]] = None,
                     src: Optional[str] = None,
                     dst: Optional[str] = None) -> torch.Tensor:
    """CCV_NNC_FORMAT_TRANSFORM: a 4-D tensor from format ``src`` to
    ``dst``, or by an explicit permutation."""
    if perm is None:
        perm = format_perm(src, dst)
    return x.permute(tuple(perm))


def transpose(x: torch.Tensor, axis_a: int = 0,
              axis_b: int = 1) -> torch.Tensor:
    """CCV_NNC_TRANSPOSE: swap two axes."""
    return torch.swapaxes(x, axis_a, axis_b)


def data_transfer(x: torch.Tensor, device=None) -> torch.Tensor:
    """CCV_NNC_DATA_TRANSFER: a copy on ``device`` (default: the card)."""
    return x.to(_device.resolve(device))


def datatype_conversion(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.to(dtype)


def set_(shape, value, dtype: torch.dtype = torch.float32,
         device=None) -> torch.Tensor:
    """CCV_NNC_SET_FORWARD: a tensor of ``shape`` filled with ``value`` on
    ``device`` (default: the card)."""
    return torch.full(tuple(shape), value, dtype=dtype,
                      device=_device.resolve(device))


def masked_fill(x: torch.Tensor, mask: torch.Tensor, eq: float = 0.0,
                fill: float = 0.0) -> torch.Tensor:
    """CCV_NNC_MASKED_FILL_FORWARD: x where mask != eq, else fill."""
    return torch.where(mask == eq, torch.tensor(fill, dtype=x.dtype,
                                                device=x.device), x)


def _edge_index(x: torch.Tensor, axis: int, lo: int, hi: int) -> torch.Tensor:
    n = x.shape[axis]
    idx = torch.arange(-lo, n + hi, device=x.device).clamp(0, n - 1)
    return torch.index_select(x, axis, idx)


def pad(x: torch.Tensor, begin: Sequence[int], end: Sequence[int],
        mode: str = "zero", value: float = 0.0) -> torch.Tensor:
    """CCV_NNC_PAD_FORWARD: ``value`` ("zero") or edge ("replicate")
    padding, ``begin[i]`` before and ``end[i]`` after axis i."""
    if mode == "zero":
        flat = []
        for lo, hi in reversed(list(zip(begin, end))):
            flat += [lo, hi]
        return F.pad(x, flat, value=value)
    for axis, (lo, hi) in enumerate(zip(begin, end)):
        if lo or hi:
            x = _edge_index(x, axis, lo, hi)
    return x


def index_select(x: torch.Tensor, indices: torch.Tensor,
                 axis: int = 0) -> torch.Tensor:
    """CCV_NNC_INDEX_SELECT_FORWARD (``jnp.take``): ``x``'s entries along
    ``axis`` at ``indices`` (any shape; negative ones count from the
    end)."""
    axis = axis % x.ndim
    n = x.shape[axis]
    idx = indices.long().reshape(-1)
    idx = torch.where(idx < 0, idx + n, idx)
    out = torch.index_select(x, axis, idx)
    return out.reshape(x.shape[:axis] + tuple(indices.shape)
                       + x.shape[axis + 1:])


def upsample(x: torch.Tensor, hfactor: float = 2.0, wfactor: float = 2.0,
             mode: str = "bilinear",
             align_corners: bool = False) -> torch.Tensor:
    """CCV_NNC_UPSAMPLE_FORWARD of NHWC ``x`` to ``int(h * hfactor)`` x
    ``int(w * wfactor)``, as ``jax.image.resize``: half-pixel centres, the
    source index clamped at the border; "nearest" rounds the centre down
    (torch's "nearest-exact", not "nearest"). In float32, cast back to x's
    type (``align_corners`` is taken and ignored, as in ``ccv_tpu``)."""
    n, h, w, c = x.shape
    size = (int(h * hfactor), int(w * wfactor))
    xc = _wide(x.permute(0, 3, 1, 2))
    if mode == "nearest":
        y = F.interpolate(xc, size=size, mode="nearest-exact")
    else:
        y = F.interpolate(xc, size=size, mode="bilinear",
                          align_corners=False, antialias=False)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def histogram(x: torch.Tensor, bins: int = 256, lo: float = 0.0,
              hi: float = 1.0) -> torch.Tensor:
    """CCV_NNC_HISTOGRAM_FORWARD (even bins): each value's bin truncated
    toward zero, then clipped to [0, bins - 1] (so values below ``lo``
    count in bin 0)."""
    idx = (ewdiv(x - lo, hi - lo) * bins).to(torch.int32).clamp(0, bins - 1)
    return torch.bincount(idx.reshape(-1), minlength=bins)


# ---------------------------------------------------------------------------
# random (lib/nnc/cmd/rand)
# ---------------------------------------------------------------------------

def random_uniform(generator: Optional[torch.Generator], shape,
                   lb: float = 0.0, ub: float = 1.0,
                   dtype: torch.dtype = torch.float32,
                   device=None) -> torch.Tensor:
    """Uniform draws in [lb, ub) from ``generator`` (on ``device``, default
    the generator's)."""
    device = generator.device if device is None and generator is not None \
        else device
    u = torch.rand(tuple(shape), generator=generator, dtype=dtype,
                   device=device)
    return u * (ub - lb) + lb


def random_normal(generator: Optional[torch.Generator], shape,
                  std: float = 1.0, mean: float = 0.0,
                  dtype: torch.dtype = torch.float32,
                  device=None) -> torch.Tensor:
    device = generator.device if device is None and generator is not None \
        else device
    return mean + std * torch.randn(tuple(shape), generator=generator,
                                    dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# detection utilities (lib/nnc/cmd/nms, roi)
# ---------------------------------------------------------------------------

def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float = 0.5,
        max_out: Optional[int] = None):
    """CCV_NNC_NMS_FORWARD: greedy IoU suppression with static shapes.

    ``boxes`` (N, 4) as (x, y, w, h). Returns (order, keep): the indices by
    descending score (ties in index order, a stable sort) and, in that
    order, the survivors of greedy suppression (box i suppresses a later j
    when i survives and IoU > threshold). ``max_out`` is taken and ignored,
    as in ``ccv_tpu``.

    ``ccv_tpu`` runs the greedy pass as N sequential steps. Here it is
    the fixed point of ``keep[j] = not any(keep[i] and S[i, j], i < j)``
    iterated from all True: after t rounds the first t entries are final,
    and the greedy answer is the map's only fixed point, so the first round
    that changes nothing ends it (N + 1 rounds at most, a handful for real
    boxes), one (N, N) pass and one read of the device a round."""
    n = boxes.shape[0]
    order = torch.argsort(-scores, stable=True)
    b = boxes[order]
    x1, y1 = b[:, 0], b[:, 1]
    x2, y2 = b[:, 0] + b[:, 2], b[:, 1] + b[:, 3]
    area = b[:, 2] * b[:, 3]
    ix1 = torch.maximum(x1[:, None], x1[None, :])
    iy1 = torch.maximum(y1[:, None], y1[None, :])
    ix2 = torch.minimum(x2[:, None], x2[None, :])
    iy2 = torch.minimum(y2[:, None], y2[None, :])
    inter = torch.clamp(ix2 - ix1, min=0) * torch.clamp(iy2 - iy1, min=0)
    iou = inter / torch.clamp(area[:, None] + area[None, :] - inter, min=1e-9)
    suppresses = torch.triu(iou > iou_threshold, diagonal=1)
    keep = torch.ones(n, dtype=torch.bool, device=boxes.device)
    for _ in range(n + 1):
        new = ~(suppresses & keep[:, None]).any(dim=0)
        if torch.equal(new, keep):
            break
        keep = new
    return order, keep


def roi_align(x: torch.Tensor, rois: torch.Tensor, out_h: int, out_w: int,
              sampling_ratio: int = 2) -> torch.Tensor:
    """CCV_NNC_ROI_ALIGN_FORWARD of (H, W, C) ``x`` (the (..., H, W, C)
    form reshapes as ``ccv_tpu``'s does), ``rois`` (N, 4) normalised
    (x, y, w, h): ``sampling_ratio``^2 bilinear samples a cell, averaged.
    Returns (N, out_h, out_w, C). All rois at once (``ccv_tpu`` vmaps one
    roi's program over them)."""
    h, w = x.shape[-3], x.shape[-2]
    lead = x.shape[:-3]
    n = rois.shape[0]
    ny, nx = out_h * sampling_ratio, out_w * sampling_ratio
    rx, ry = rois[:, 0:1] * w, rois[:, 1:2] * h
    rw, rh = rois[:, 2:3] * w, rois[:, 3:4] * h
    steps_y = torch.arange(ny, device=x.device, dtype=rois.dtype) + 0.5
    steps_x = torch.arange(nx, device=x.device, dtype=rois.dtype) + 0.5
    ys = ry + ewdiv(steps_y * rh, ny)                        # (N, ny)
    xs = rx + ewdiv(steps_x * rw, nx)                        # (N, nx)
    y0 = torch.floor(ys - 0.5).to(torch.int64).clamp(0, h - 1)
    x0 = torch.floor(xs - 0.5).to(torch.int64).clamp(0, w - 1)
    y1 = (y0 + 1).clamp(0, h - 1)
    x1 = (x0 + 1).clamp(0, w - 1)
    fy = torch.clamp(ys - 0.5 - y0, 0.0, 1.0)
    fx = torch.clamp(xs - 0.5 - x0, 0.0, 1.0)
    wshape = (n,) + (1,) * len(lead) + (ny, nx, 1)

    def at(yi, xi):  # (N, *lead, ny, nx, C)
        g = x[..., yi[:, :, None], xi[:, None, :], :]
        return torch.movedim(g, len(lead), 0)

    def weight(a, b):
        return (a[:, :, None] * b[:, None, :]).reshape(wshape)

    g = (at(y0, x0) * weight(1 - fy, 1 - fx) + at(y0, x1) * weight(1 - fy, fx)
         + at(y1, x0) * weight(fy, 1 - fx) + at(y1, x1) * weight(fy, fx))
    g = g.reshape(n, out_h, sampling_ratio, out_w, sampling_ratio, -1)
    return g.mean(dim=(2, 4))


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


# ---------------------------------------------------------------------------
# rnn (lib/nnc/cmd/rnn: LSTM)
# ---------------------------------------------------------------------------

def lstm(x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor,
         b_ih: Optional[torch.Tensor] = None,
         b_hh: Optional[torch.Tensor] = None,
         h0: Optional[torch.Tensor] = None, c0: Optional[torch.Tensor] = None,
         reverse: bool = False):
    """CCV_NNC_LSTM_FORWARD, one layer: x (T, B, I), w_ih (I, 4H), w_hh
    (H, 4H); returns (ys (T, B, H), hT, cT). Gates [i, f, g, o], as cuDNN.

    The input projections of all steps are one matmul; each step adds
    ``h @ w_hh`` and the biases in float32 (``ccv_tpu``'s promotion of
    x's type against float32 weights) and keeps h and c in x's type between
    steps, as ``ccv_tpu``'s scan carries them."""
    T, B, _ = x.shape
    H = w_hh.shape[0]
    h = torch.zeros((B, H), dtype=x.dtype, device=x.device) if h0 is None \
        else h0
    c = torch.zeros((B, H), dtype=x.dtype, device=x.device) if c0 is None \
        else c0
    xproj = torch.matmul(x.float(), w_ih.float())
    if b_ih is not None:
        xproj = xproj + b_ih.float()
    steps = range(T - 1, -1, -1) if reverse else range(T)
    ys = [None] * T
    for t in steps:
        gates = xproj[t] + torch.matmul(h.float(), w_hh.float())
        if b_hh is not None:
            gates = gates + b_hh.float()
        i, f, g, o = torch.chunk(gates, 4, dim=-1)
        c_new = torch.sigmoid(f) * c.float() + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        h, c = h_new.to(x.dtype), c_new.to(x.dtype)
        ys[t] = h
    return torch.stack(ys), h, c
