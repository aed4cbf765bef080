"""Port parity: the rest of ccv_tpu_torch/nn/ops.py and the layers of
ccv_tpu_torch/nn/layers.py against ccv_tpu/nn/{ops,layers}.py, on the
same numpy inputs and (for layers) ``ccv_tpu``'s parameters, on the CPU.

Tolerances:
- float32: |port - ccv_tpu| <= 1e-5 + 1e-5 * max|ccv_tpu| (the same
  float32 arithmetic, summed in another order);
- bfloat16: within 1e-2 of the largest magnitude of ``ccv_tpu``'s output
  (both round each result to bf16, 2^-8 relative, and a value near a
  rounding boundary may round either way), 3e-2 for the LSTM and attention
  layers, whose bf16 roundings compound over steps and products;
- integer outputs (argmax, histogram, nms, shapes) and pure data movement
  (layouts, pads, gathers, casts): equal;
- random commands: by distribution (range, mean, std), since torch's and
  JAX's generators differ.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccv_tpu.nn import layers as JL
from ccv_tpu.nn import ops as jops
from ccv_tpu_torch.nn import layers as TL
from ccv_tpu_torch.nn import ops as tops
from ccv_tpu_torch.nn.model import params_from_jax


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def _j(a, dtype=None):
    return jnp.asarray(a) if dtype is None else jnp.asarray(a, dtype)


def _close(got, want, dtype="float32", rel=None):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = float(np.abs(want).max()) if want.size else 0.0
    if rel is None:
        rel = 1e-2 if dtype == "bfloat16" else None
    tol = rel * scale if rel is not None else 1e-5 + 1e-5 * scale
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol, (err, tol)


def _equal(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


# ---------------------------------------------------------------------------
# elementwise
# ---------------------------------------------------------------------------

BINARY = {
    "add": (lambda o, a, b: o.add(a, b, 0.5, -2.0)),
    "mul": (lambda o, a, b: o.mul(a, b, 3.0)),
    "cmul": (lambda o, a, b: o.cmul(a, b)),
    "ewsum": (lambda o, a, b: o.ewsum(a, b, a)),
    "ewprod": (lambda o, a, b: o.ewprod(a, b, b)),
    "ewdiv": (lambda o, a, b: o.ewdiv(a, b)),
    "ewmin": (lambda o, a, b: o.ewmin(a, b)),
    "ewmax": (lambda o, a, b: o.ewmax(a, b)),
}
UNARY = {
    "scalar_mul": lambda o, a: o.scalar_mul(a, -1.5),
    "ewexp": lambda o, a: o.ewexp(a),
    "ewlog": lambda o, a: o.ewlog(o.ewabs(a) + 0.1),
    "ewsqrt": lambda o, a: o.ewsqrt(o.ewabs(a)),
    "ewabs": lambda o, a: o.ewabs(a),
    "ewneg": lambda o, a: o.ewneg(a),
    "clamp": lambda o, a: o.clamp(a, -0.5, 0.7),
    "clamp_lo": lambda o, a: o.clamp(a, lo=0.1),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(BINARY))
def test_binary_elementwise(name, dtype):
    a, b = _rand((3, 4, 6), 1), _rand((3, 4, 6), 2) + 3.0
    want = BINARY[name](jops, _j(a, dtype), _j(b, dtype))
    got = BINARY[name](tops, _t(a, getattr(torch, dtype)),
                       _t(b, getattr(torch, dtype)))
    assert str(got.dtype).endswith(dtype)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(UNARY))
def test_unary_elementwise(name, dtype):
    a = _rand((5, 7), 3)
    want = UNARY[name](jops, _j(a, dtype))
    got = UNARY[name](tops, _t(a, getattr(torch, dtype)))
    _close(got, want, dtype)


# ---------------------------------------------------------------------------
# conv2d_transpose: lax's output sizes and pads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize(
    "stride,padding,kernel,groups",
    [(s, p, k, g) for s, p, k, g in itertools.product(
        (1, 2, 3), ("SAME", "VALID"), ((3, 3), (2, 4)), (1, 2))]
    + [(2, 1, (3, 3), 1), (3, [(0, 2), (1, 3)], (3, 3), 2)])
def test_conv2d_transpose(stride, padding, kernel, groups):
    """Strides 1-3, "SAME" / "VALID", an int and explicit pairs, odd and
    even kernels, with groups: shapes equal, values float32."""
    x = _rand((2, 5, 6, 4), 4)
    w = _rand((4, *kernel, 3), 5)  # (x's channels, kh, kw, out / groups)
    b = _rand((3 * groups,), 6)
    want = jops.conv2d_transpose(_j(x), _j(w), _j(b), (stride, stride),
                                 padding, groups=groups)
    got = tops.conv2d_transpose(_t(x), _t(w), _t(b), (stride, stride),
                                padding, groups=groups)
    _close(got, want)


def test_conv2d_transpose_dilation_and_bf16():
    x, w = _rand((1, 7, 5, 3), 7), _rand((3, 3, 3, 5), 8)
    want = jops.conv2d_transpose(_j(x), _j(w), stride=(2, 1), dilation=(2, 2))
    _close(tops.conv2d_transpose(_t(x), _t(w), stride=(2, 1),
                                 dilation=(2, 2)), want)
    want = jops.conv2d_transpose(_j(x, jnp.bfloat16), _j(w, jnp.bfloat16),
                                 stride=(2, 2))
    _close(tops.conv2d_transpose(_t(x, torch.bfloat16), _t(w, torch.bfloat16),
                                 stride=(2, 2)), want, "bfloat16")


# ---------------------------------------------------------------------------
# norms and losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms(dtype):
    x = _rand((2, 3, 5, 8), 9, 3.0) + 1.0
    sc, bi = _rand((8,), 10), _rand((8,), 11)
    jx, tx = _j(x, dtype), _t(x, getattr(torch, dtype))
    _close(tops.layer_norm(tx, _t(sc), _t(bi)),
           jops.layer_norm(jx, _j(sc), _j(bi)), dtype)
    _close(tops.layer_norm(tx, axis=(1, 2, 3), elementwise_affine=False),
           jops.layer_norm(jx, axis=(1, 2, 3), elementwise_affine=False),
           dtype)
    _close(tops.group_norm(tx, _t(sc), _t(bi), groups=4),
           jops.group_norm(jx, _j(sc), _j(bi), groups=4), dtype)
    _close(tops.group_norm(tx, groups=2), jops.group_norm(jx, groups=2),
           dtype)
    _close(tops.rmsnorm(tx, _t(sc)), jops.rmsnorm(jx, _j(sc)), dtype)
    _close(tops.rmsnorm(tx, _t(sc[:5, None]), axis=(2,)),
           jops.rmsnorm(jx, _j(sc[:5, None]), axis=(2,)), dtype)


LOSS_INT = np.array([[0, 3], [4, 1]], np.int32)


def _losses(o, x, y, p, lab, soft):
    outs = [o.mse_loss(x, y), o.mse_loss(x, y, False), o.mae_loss(x, y),
            o.mae_loss(x, y, False), o.smooth_l1_loss(x, y),
            o.smooth_l1_loss(x, y, 0.3),
            o.categorical_crossentropy(p, lab),
            o.categorical_crossentropy(p, lab, 0.05, 0.9),
            o.categorical_crossentropy(p, soft),
            o.binary_crossentropy(p, soft, 2.0)]
    for labels in (lab, soft):
        outs += list(o.softmax_crossentropy(x, labels))
    outs += list(o.softmax_crossentropy(x, lab, 0.1, 0.8))
    outs += list(o.sigmoid_binary_crossentropy(x, soft, 1.5))
    return outs


def test_losses():
    """Every loss's forward, integer and soft labels, with and without
    label smoothing."""
    x, y = _rand((2, 2, 5), 12), _rand((2, 2, 5), 13)
    p = np.abs(_rand((2, 2, 5), 14)) + 0.05
    p = (p / p.sum(-1, keepdims=True)).astype(np.float32)
    soft = np.random.default_rng(15).uniform(0, 1, (2, 2, 5)).astype(
        np.float32)
    want = _losses(jops, _j(x), _j(y), _j(p), _j(LOSS_INT), _j(soft))
    got = _losses(tops, _t(x), _t(y), _t(p), _t(LOSS_INT), _t(soft))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w)


# ---------------------------------------------------------------------------
# reductions, layout, utility
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axis,keep", [((0,), True), ((1, 2), False),
                                       ((-1,), True), ((0, 2), True)])
def test_reductions(axis, keep):
    x = _rand((3, 4, 5), 16)
    for name in ("reduce_sum", "reduce_mean", "reduce_max", "reduce_min",
                 "reduce_norm2"):
        _close(getattr(tops, name)(_t(x), axis, keep),
               getattr(jops, name)(_j(x), axis, keep))
    xn = x.copy()
    xn[1, 2, 3] = np.nan
    _equal(tops.reduce_isnan(_t(xn), axis, keep),
           jops.reduce_isnan(_j(xn), axis, keep))


def test_argmax_argmin_ties():
    """The first index of the extreme value, ties included."""
    x = np.round(_rand((4, 6, 5), 17))
    for axis in (-1, 0, 1):
        _equal(tops.argmax(_t(x), axis), jops.argmax(_j(x), axis))
        _equal(tops.argmin(_t(x), axis), jops.argmin(_j(x), axis))


def test_layout_and_utility():
    x = _rand((2, 3, 4, 5), 18)
    for src, dst in itertools.product(tops.FORMATS, tops.FORMATS):
        _equal(tops.format_transform(_t(x), src=src, dst=dst),
               jops.format_transform(_j(x), src=src, dst=dst))
    _equal(tops.format_transform(_t(x), perm=(3, 1, 0, 2)),
           jops.format_transform(_j(x), perm=(3, 1, 0, 2)))
    _equal(tops.transpose(_t(x), 1, 3), jops.transpose(_j(x), 1, 3))
    _equal(tops.datatype_conversion(_t(x * 10), torch.int32),
           jops.datatype_conversion(_j(x * 10), jnp.int32))
    _equal(tops.data_transfer(_t(x), "cpu"), x)
    _equal(tops.set_((2, 3), 1.25, device="cpu"), jops.set_((2, 3), 1.25))
    mask = (np.arange(2 * 3 * 4 * 5).reshape(2, 3, 4, 5) % 3).astype(
        np.float32)
    _equal(tops.masked_fill(_t(x), _t(mask), 1.0, -7.0),
           jops.masked_fill(_j(x), _j(mask), 1.0, -7.0))
    for mode in ("zero", "replicate"):
        _equal(tops.pad(_t(x), (0, 2, 1, 0), (1, 0, 3, 2), mode, 0.5),
               jops.pad(_j(x), (0, 2, 1, 0), (1, 0, 3, 2), mode, 0.5))
    idx = np.array([[3, 0], [-1, 2]], np.int32)
    for axis in (0, 1, 3, -1):
        n = x.shape[axis]
        ids = np.where(idx >= n, n - 1, idx)
        _equal(tops.index_select(_t(x), _t(ids), axis),
               jops.index_select(_j(x), _j(ids), axis))


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("factors", [(2.0, 2.0), (1.5, 1.5), (3.0, 3.0),
                                     (2.0, 1.5)])
def test_upsample(mode, factors):
    """jax.image.resize's half-pixel centres (bilinear; nearest rounds the
    centre down, torch's "nearest-exact"), factors 2, 1.5 and 3."""
    x = _rand((2, 5, 7, 3), 19)
    want = jops.upsample(_j(x), *factors, mode=mode)
    _close(tops.upsample(_t(x), *factors, mode=mode), want)
    want = jops.upsample(_j(x, jnp.bfloat16), *factors, mode=mode)
    _close(tops.upsample(_t(x, torch.bfloat16), *factors, mode=mode), want,
           "bfloat16")


def test_histogram_truncates_toward_zero():
    x = np.concatenate([_rand((500,), 20, 0.6) + 0.5,
                        np.array([-0.3, -0.9, 1.0, 1.7, 0.0], np.float32)])
    for bins, lo, hi in ((16, 0.0, 1.0), (7, -0.5, 1.5)):
        _equal(tops.histogram(_t(x), bins, lo, hi),
               jops.histogram(_j(x), bins, lo, hi))


def test_random_by_distribution():
    g = torch.Generator().manual_seed(3)
    u = tops.random_uniform(g, (200000,), -2.0, 3.0)
    assert u.dtype == torch.float32 and u.shape == (200000,)
    assert float(u.min()) >= -2.0 and float(u.max()) < 3.0
    assert abs(float(u.mean()) - 0.5) < 0.02
    assert abs(float(u.std()) - 5 / 12 ** 0.5) < 0.02
    n = tops.random_normal(g, (200000,), std=2.0, mean=-1.0)
    assert abs(float(n.mean()) + 1.0) < 0.02
    assert abs(float(n.std()) - 2.0) < 0.02
    a = tops.random_normal(torch.Generator().manual_seed(5), (4,))
    b = tops.random_normal(torch.Generator().manual_seed(5), (4,))
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# detection utilities and the LSTM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,thr", [(60, 0.5), (300, 0.3), (40, 0.7)])
def test_nms(n, thr):
    """Order (stable descending, ties included) and keep mask equal."""
    rng = np.random.default_rng(n)
    xy = rng.uniform(0, 50, (n, 2))
    wh = rng.uniform(5, 25, (n, 2))
    boxes = np.concatenate([xy, wh], 1).astype(np.float32)
    scores = np.round(rng.uniform(0, 1, n), 1).astype(np.float32)  # ties
    jo, jk = jops.nms(_j(boxes), _j(scores), thr)
    to, tk = tops.nms(_t(boxes), _t(scores), thr)
    _equal(to, jo)
    _equal(tk, jk)


def test_roi_align():
    x = _rand((9, 11, 4), 21)
    rois = np.array([[0.1, 0.2, 0.5, 0.6], [0.0, 0.0, 1.0, 1.0],
                     [0.7, 0.3, 0.25, 0.6]], np.float32)
    for oh, ow, sr in ((2, 3, 2), (4, 4, 1), (3, 2, 3)):
        _close(tops.roi_align(_t(x), _t(rois), oh, ow, sr),
               jops.roi_align(_j(x), _j(rois), oh, ow, sr))
    xb = _rand((2, 9, 11, 4), 34)  # a leading axis: ccv_tpu's reshape
    _close(tops.roi_align(_t(xb), _t(rois), 2, 3, 2),
           jops.roi_align(_j(xb), _j(rois), 2, 3, 2))


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_op(reverse):
    T, B, I, H = 7, 3, 5, 4
    x = _rand((T, B, I), 22)
    w_ih, w_hh = _rand((I, 4 * H), 23, 0.4), _rand((H, 4 * H), 24, 0.4)
    b_ih, b_hh = _rand((4 * H,), 25), _rand((4 * H,), 26)
    h0, c0 = _rand((B, H), 27), _rand((B, H), 28)
    want = jops.lstm(*map(_j, (x, w_ih, w_hh, b_ih, b_hh, h0, c0)),
                     reverse=reverse)
    got = tops.lstm(*map(_t, (x, w_ih, w_hh, b_ih, b_hh, h0, c0)),
                    reverse=reverse)
    for g, w in zip(got, want):
        _close(g, w)


# ---------------------------------------------------------------------------
# layers, with ccv_tpu's parameters carried across
# ---------------------------------------------------------------------------

def _randomize(p, seed):
    """Biases and norm parameters drawn from a seed (ccv_tpu initialises
    them to constants)."""
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(0, 0.5, np.shape(v)).astype(np.float32)
                if k.startswith("b") or k in ("scale", "bias") else
                np.asarray(v)) for k, v in p.items()}


def _layer_pair(make, in_shape, seed):
    jl, tl = make(JL), make(TL)
    jp, js, jout = jl.init(jax.random.PRNGKey(seed), in_shape)
    tp, ts, tout = tl.init(torch.Generator().manual_seed(seed), in_shape)
    assert tuple(tout) == tuple(jout)
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: tuple(np.shape(v)) for k, v in jp.items()}
    jp = _randomize(jp, seed)
    tp = params_from_jax([jp], "cpu")[0]
    return jl, tl, jp, tp


LAYERS = {
    "convT": (lambda L: L.ConvolutionTranspose(4, (3, 3), (2, 2)),
              (2, 5, 6, 4), None),
    "convT_valid": (lambda L: L.ConvolutionTranspose(4, (2, 3), (3, 3),
                                                     "VALID", no_bias=True),
                    (1, 4, 3, 4), None),
    "ln": (lambda L: L.LayerNorm(), (2, 6, 8), None),
    "ln_axes": (lambda L: L.LayerNorm(axis=(1, 2)), (2, 6, 8), None),
    "ln_plain": (lambda L: L.LayerNorm(elementwise_affine=False),
                 (2, 6, 8), None),
    "gn": (lambda L: L.GroupNorm(groups=4), (2, 3, 3, 8), None),
    "rms": (lambda L: L.RMSNorm(), (2, 6, 8), None),
    "embedding": (lambda L: L.Embedding(11, 6), (2, 5), "int"),
    "permute": (lambda L: L.Permute((0, 2, 1, 3)), (2, 3, 4, 5), None),
    "transpose": (lambda L: L.Transpose(1, 3), (2, 3, 4, 5), None),
    "pad": (lambda L: L.Pad((0, 1, 2, 0), (0, 2, 0, 1), "zero"),
            (2, 3, 4, 5), None),
    "pad_edge": (lambda L: L.Pad((0, 1, 2, 0), (0, 2, 0, 1), "replicate"),
                 (2, 3, 4, 5), None),
    "upsample": (lambda L: L.Upsample(2.0, 2.0), (2, 3, 4, 5), None),
    "upsample_nearest": (lambda L: L.Upsample(3.0, 1.5, "nearest"),
                         (2, 3, 4, 5), None),
    "lstm": (lambda L: L.LSTM(6), (3, 7, 5), None),
    "lstm_bi": (lambda L: L.LSTM(6, bidirectional=True), (3, 7, 5), None),
    "sdpa": (lambda L: L.ScaledDotProductAttention(2, 4), (2, 9, 8), None),
    "sdpa_causal": (lambda L: L.ScaledDotProductAttention(
        2, 4, is_causal=True, fused_qkv=False), (2, 9, 8), None),
    "sdpa_noproj": (lambda L: L.ScaledDotProductAttention(
        3, 4, out_proj=False), (2, 6, 8), None),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_ccv_tpu(name, dtype):
    make, in_shape, kind = LAYERS[name]
    jl, tl, jp, tp = _layer_pair(make, in_shape, 30)
    if kind == "int":
        x = np.random.default_rng(31).integers(0, 11, in_shape).astype(
            np.int32)
        jx, tx = _j(x), _t(x)
    else:
        x = _rand(in_shape, 31)
        jx, tx = _j(x, dtype), _t(x, getattr(torch, dtype))
    want, _ = jl.apply({k: _j(v) for k, v in jp.items()}, {}, jx)
    got, _ = tl.apply(tp, {}, tx)
    rel = 3e-2 if dtype == "bfloat16" and name.startswith(
        ("lstm", "sdpa")) else None
    _close(got, want, dtype, rel)


def test_convolution_transpose_filters_must_match_channels():
    """ccv_tpu's (filters, kh, kw, cin) weight is read as (cin, kh, kw,
    out), so only filters == cin builds there; the port says so."""
    with pytest.raises(Exception):
        JL.ConvolutionTranspose(8).init(jax.random.PRNGKey(0), (1, 5, 5, 3))
    with pytest.raises(ValueError, match="filters must equal"):
        TL.ConvolutionTranspose(8).init(torch.Generator(), (1, 5, 5, 3))


def test_layer_inits_by_distribution():
    """Glorot bounds, the embedding's 0.02 scale, zero biases."""
    g = torch.Generator().manual_seed(0)
    p, _, _ = TL.LSTM(64).init(g, (2, 3, 32))
    lim = (6.0 / (32 + 256)) ** 0.5
    assert float(p["w_ih"].abs().max()) <= lim
    assert float(p["w_ih"].std()) > 0.5 * lim / 3 ** 0.5
    assert not p["b_ih"].any()
    p, _, _ = TL.Embedding(500, 64).init(g, (2,))
    assert abs(float(p["table"].std()) - 0.02) < 1e-3


def test_attention_layer_routes_plain_on_the_cpu(monkeypatch):
    """At T >= 1024 on a CPU tensor the layer takes the plain op (as
    ccv_tpu off the TPU), and never the flash kernels."""
    from ccv_tpu_torch.ops.kernels import flash_attention as k2

    calls = []
    monkeypatch.setattr(k2, "flash_attention",
                        lambda *a, **k: calls.append(1))
    layer = TL.ScaledDotProductAttention(2, 8)
    p, s, _ = layer.init(torch.Generator().manual_seed(0), (1, 1024, 16))
    x = _t(_rand((1, 1024, 16), 32))
    y, _ = layer.apply(p, s, x)
    assert y.shape == (1, 1024, 16) and not calls
    assert not layer._use_flash(x)


@pytest.mark.cuda
def test_cuda_attention_layer_launches_k2():
    """On the card at T 1024 the layer runs K2a (one forward launch a
    call) and agrees with the plain op within the bf16 gate (3e-2 of the
    largest); a head dim above 64 raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ccv_tpu_torch.ops.kernels import flash_attention as k2

    dev = torch.device("cuda")
    layer = TL.ScaledDotProductAttention(4, 64, is_causal=True)
    p, s, _ = layer.init(torch.Generator().manual_seed(0), (2, 1024, 256))
    p = {k: v.to(dev) for k, v in p.items()}
    x = _t(_rand((2, 1024, 256), 33)).to(dev, torch.bfloat16)
    k2.reset_launches()
    with torch.no_grad():
        y, _ = layer.apply(p, s, x)
    torch.cuda.synchronize()
    assert k2.LAUNCHES["fwd"] == 1
    q, k, v = torch.chunk(x @ p["wqkv"].to(x.dtype), 3, dim=-1)
    ref = tops.scaled_dot_product_attention(
        *(t.reshape(2, 1024, 4, 64) for t in (q, k, v)), is_causal=True)
    ref = ref.reshape(2, 1024, 256) @ p["wo"].to(x.dtype)
    err = float((y.float() - ref.float()).abs().max())
    assert err <= 3e-2 * float(ref.float().abs().max())
    wide = TL.ScaledDotProductAttention(2, 128)
    pw, sw, _ = wide.init(torch.Generator().manual_seed(1), (1, 1024, 64))
    with pytest.raises(ValueError, match="head dims up to 64"):
        wide.apply({k: v.to(dev) for k, v in pw.items()}, sw,
                   x[:1, :, :64].contiguous())
