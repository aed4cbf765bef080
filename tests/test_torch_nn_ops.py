"""Port parity: the image-classification ops of ccv_tpu_torch/nn/ops.py
against ccv_tpu/nn/ops.py on the same numpy inputs, on the CPU.

Tolerances:
- float32: |port - ccv_tpu| <= 1e-5 + 1e-5 * max|ccv_tpu| (the same
  float32 sums in another order: XLA's convolution against the CPU's);
- bfloat16: within 1e-2 of the largest magnitude of ccv_tpu's output. Both
  sum bf16 products in float32 and round once to bf16 (2^-8 relative), but
  a sum that lands near a rounding boundary may round either way;
- max-pool: equal (a max picks one of its inputs); average pools float32
  as above; batch norm float32 as above.
"""

import itertools
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccv_tpu.nn import ops as jops
from ccv_tpu_torch.nn import ops as tops

FORMATS = ("NHWC", "NCHW", "CHWN")
PADDINGS = {"same": "SAME", "valid": "VALID", "int": 1,
            "pairs": [(0, 2), (1, 0)]}


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got: torch.Tensor, want, dtype="float32"):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    tol = 1e-2 * scale if dtype == "bfloat16" else 1e-5 + 1e-5 * scale
    err = float(np.abs(got - want).max())
    assert err <= tol, (err, tol)


def _in_format(x_nhwc: np.ndarray, fmt: str) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(x_nhwc,
                                             jops.format_perm("NHWC", fmt)))


@pytest.mark.parametrize("src,dst", list(itertools.product(FORMATS,
                                                           FORMATS)))
def test_format_perm(src, dst):
    assert tops.format_perm(src, dst) == jops.format_perm(src, dst)


@pytest.mark.parametrize(
    "fmt,stride,padding,dilation,groups",
    list(itertools.product(FORMATS, (1, 2), PADDINGS, (1, 2), (1, 2))))
def test_conv2d_float32(fmt, stride, padding, dilation, groups):
    """Every format x stride x padding x dilation x groups, with a bias,
    on a 9 x 11 input and a 3 x 2 kernel (an even width: "SAME" pads
    unevenly even at stride 1)."""
    seed = zlib.crc32(repr((fmt, stride, padding, dilation, groups))
                      .encode()) % 1000
    x = _in_format(_rand((2, 9, 11, 4), seed), fmt)
    w = _rand((6, 3, 2, 4 // groups), seed + 1)
    b = _rand((6,), seed + 2)
    pad = PADDINGS[padding]
    want = jops.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                       (stride, stride), pad, (dilation, dilation), groups,
                       format=fmt)
    got = tops.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                      torch.from_numpy(b), (stride, stride), pad,
                      (dilation, dilation), groups, format=fmt)
    _close(got, want)


@pytest.mark.parametrize("fmt,stride,padding", list(itertools.product(
    FORMATS, (1, 2), ("same", "valid"))))
def test_conv2d_bfloat16(fmt, stride, padding):
    """bf16 inputs, weights and bias: products summed in float32, the bias
    added before the one rounding to bf16."""
    x = _in_format(_rand((2, 8, 10, 8), 3), fmt)
    w, b = _rand((16, 3, 3, 8), 4), _rand((16,), 5)
    want = jops.conv2d(jnp.asarray(x, jnp.bfloat16),
                       jnp.asarray(w, jnp.bfloat16),
                       jnp.asarray(b, jnp.bfloat16), (stride, stride),
                       PADDINGS[padding], format=fmt)
    got = tops.conv2d(torch.from_numpy(x).bfloat16(),
                      torch.from_numpy(w).bfloat16(),
                      torch.from_numpy(b).bfloat16(), (stride, stride),
                      PADDINGS[padding], format=fmt)
    assert got.dtype == torch.bfloat16
    _close(got, want, "bfloat16")


def test_conv2d_same_pads_more_at_the_bottom_right():
    """XLA's "SAME" at stride 2 on an even size pads (0, 1) on each axis,
    not torch's symmetric (1, 1): a kernel that reads only its top-left tap
    sees the input's even rows and columns."""
    x = torch.arange(16.0).reshape(1, 4, 4, 1)
    w = torch.zeros(1, 2, 2, 1)
    w[0, 0, 0, 0] = 1.0
    got = tops.conv2d(x, w, stride=(2, 2), padding="SAME")
    assert got[0, ..., 0].tolist() == [[0.0, 2.0], [8.0, 10.0]]


@pytest.mark.parametrize("fmt,kernel,dtype", list(itertools.product(
    FORMATS, ((2, 2), (3, 3)), ("float32", "bfloat16"))))
def test_max_pool_same_stride_2(fmt, kernel, dtype):
    """"SAME" at stride 2 on 9 x 11 (odd) pads -inf where XLA does."""
    x = _in_format(_rand((2, 9, 11, 3), 6), fmt)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    for padding in ("SAME", "VALID"):
        want = np.asarray(jops.max_pool(jx, kernel, (2, 2), padding,
                                        format=fmt).astype(jnp.float32))
        got = tops.max_pool(tx, kernel, (2, 2), padding, format=fmt)
        assert got.dtype == tx.dtype
        np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("fmt,kernel,include", list(itertools.product(
    FORMATS, ((2, 2), (3, 3)), (False, True))))
def test_avg_pool_same_stride_2(fmt, kernel, include):
    """Average pools divide by the cells inside the input unless
    ``count_include_pad`` (or "VALID")."""
    x = _in_format(_rand((2, 9, 11, 3), 7), fmt)
    for padding in ("SAME", "VALID"):
        want = jops.avg_pool(jnp.asarray(x), kernel, (2, 2), padding,
                             include, format=fmt)
        got = tops.avg_pool(torch.from_numpy(x), kernel, (2, 2), padding,
                            include, format=fmt)
        _close(got, want)


def test_avg_pool_bfloat16():
    x = _rand((2, 9, 11, 3), 8)
    want = jops.avg_pool(jnp.asarray(x, jnp.bfloat16), (3, 3), (2, 2),
                         "SAME")
    got = tops.avg_pool(torch.from_numpy(x).bfloat16(), (3, 3), (2, 2),
                        "SAME")
    assert got.dtype == torch.bfloat16
    _close(got, want, "bfloat16")


def test_pool_explicit_pairs():
    """reduce_window's (lo, hi) pair for each axis, as the legacy convnet's
    overhanging pools pass them."""
    x = _rand((1, 7, 7, 2), 9)
    pad = ((0, 0), (1, 2), (0, 1), (0, 0))
    np.testing.assert_array_equal(
        tops.max_pool(torch.from_numpy(x), (3, 3), (2, 2), pad).numpy(),
        np.asarray(jops.max_pool(jnp.asarray(x), (3, 3), (2, 2), pad)))
    _close(tops.avg_pool(torch.from_numpy(x), (3, 3), (2, 2), pad),
           jops.avg_pool(jnp.asarray(x), (3, 3), (2, 2), pad))


NC_PADS = {"c": ((0, 0), (1, 1), (1, 1), (0, 1)),
           "n": ((1, 0), (0, 1), (1, 0), (0, 0)),
           "nc": ((1, 1), (1, 1), (0, 1), (2, 0))}


@pytest.mark.parametrize("fmt,pads", list(itertools.product(
    ("NHWC", "NCHW"), NC_PADS)))
def test_max_pool_pads_n_and_c(fmt, pads):
    """Pads on N and C (NHWC pairs, put in the format's order) add cells
    of pads alone: -inf, as reduce_window gives them."""
    pad_nhwc = NC_PADS[pads]
    pad = [pad_nhwc[a] for a in jops.format_perm("NHWC", fmt)]
    x = _in_format(_rand((2, 4, 4, 3), 19), fmt)
    want = np.asarray(jops.max_pool(jnp.asarray(x), (2, 2), (2, 2), pad,
                                    format=fmt))
    got = tops.max_pool(torch.from_numpy(x), (2, 2), (2, 2), pad,
                        format=fmt).numpy()
    assert got.shape == want.shape
    assert np.isneginf(want).any()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fmt,pads,include", list(itertools.product(
    ("NHWC", "NCHW"), NC_PADS, (False, True))))
def test_avg_pool_pads_n_and_c(fmt, pads, include):
    """Average pools over pads on N and C: a window of pads alone is 0
    with ``count_include_pad``, else 0 / 0, NaN, as in ccv_tpu."""
    pad_nhwc = NC_PADS[pads]
    pad = [pad_nhwc[a] for a in jops.format_perm("NHWC", fmt)]
    x = _in_format(_rand((2, 4, 4, 3), 20), fmt)
    want = np.asarray(jops.avg_pool(jnp.asarray(x), (2, 2), (2, 2), pad,
                                    include, format=fmt))
    got = tops.avg_pool(torch.from_numpy(x), (2, 2), (2, 2), pad, include,
                        format=fmt)
    nan = np.isnan(want)
    assert nan.any() != include
    np.testing.assert_array_equal(np.isnan(got.numpy()), nan)
    _close(torch.where(torch.from_numpy(nan), 0.0, got),
           np.where(nan, 0.0, want))


@pytest.mark.parametrize("fmt", ["NHWC", "NCHW"])
def test_max_pool_integer_c_pad(fmt):
    """An int32 max pool pads with the type's least value (ccv_tpu's
    reduce_window takes no narrower integer)."""
    x = _in_format(np.random.default_rng(21).integers(
        -100, 100, (2, 4, 4, 3)).astype(np.int32), fmt)
    pad = [NC_PADS["c"][a] for a in jops.format_perm("NHWC", fmt)]
    want = np.asarray(jops.max_pool(jnp.asarray(x), (2, 2), (2, 2), pad,
                                    format=fmt))
    got = tops.max_pool(torch.from_numpy(x), (2, 2), (2, 2), pad,
                        format=fmt).numpy()
    assert got.dtype == want.dtype
    assert (want == np.iinfo(np.int32).min).any()
    np.testing.assert_array_equal(got, want)
    same = np.asarray(jops.max_pool(jnp.asarray(x), (3, 3), (2, 2), "SAME",
                                    format=fmt))
    np.testing.assert_array_equal(
        tops.max_pool(torch.from_numpy(x), (3, 3), (2, 2), "SAME",
                      format=fmt).numpy(), same)


@pytest.mark.parametrize("fmt,dtype", list(itertools.product(
    (*FORMATS, None), ("float32", "bfloat16"))))
def test_batch_norm_inference(fmt, dtype):
    x = _in_format(_rand((2, 5, 6, 4), 10), fmt or "NHWC")
    scale, bias, mean = (_rand((4,), s) for s in (11, 12, 13))
    var = np.abs(_rand((4,), 14)) + 0.1
    want = jops.batch_norm(jnp.asarray(x, getattr(jnp, dtype)),
                           *(jnp.asarray(a) for a in (scale, bias, mean,
                                                      var)),
                           1e-3, format=fmt)
    got = tops.batch_norm(torch.from_numpy(x).to(getattr(torch, dtype)),
                          *(torch.from_numpy(a) for a in (scale, bias, mean,
                                                          var)),
                          1e-3, format=fmt)
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, dtype)


@pytest.mark.parametrize("name", ["relu", "leaky_relu", "sigmoid", "tanh",
                                  "swish", "gelu", "gelu_tanh", "softmax"])
def test_activations(name):
    x = _rand((3, 17), 15)
    fn = {"gelu_tanh": (lambda m: lambda a: m.gelu(a, True)),
          "leaky_relu": (lambda m: lambda a: m.leaky_relu(a, 0.2))}.get(
        name, lambda m: getattr(m, name))
    _close(fn(tops)(torch.from_numpy(x)), fn(jops)(jnp.asarray(x)))


@pytest.mark.parametrize("ta,tb,bias", [(False, False, True),
                                        (True, False, False),
                                        (False, True, True)])
def test_gemm(ta, tb, bias):
    a = _rand((5, 7) if not ta else (7, 5), 16)
    w = _rand((7, 3) if not tb else (3, 7), 17)
    b = _rand((3,), 18) if bias else None
    want = jops.gemm(jnp.asarray(a), jnp.asarray(w),
                     None if b is None else jnp.asarray(b), ta, tb)
    got = tops.gemm(torch.from_numpy(a), torch.from_numpy(w),
                    None if b is None else torch.from_numpy(b), ta, tb)
    _close(got, want)


def test_dropout_keeps_the_expectation():
    """Inverted dropout: kept values scaled by 1 / (1 - rate), about
    ``rate`` of them zeroed; a seeded generator replays; ``entirety``
    keeps or drops the whole tensor."""
    x = torch.ones(200, 100)
    g = torch.Generator().manual_seed(3)
    y = tops.dropout(x, 0.25, g)
    kept = y != 0
    assert torch.all(y[kept] == 1 / 0.75)
    assert abs(float(kept.float().mean()) - 0.75) < 0.01
    assert torch.equal(y, tops.dropout(x, 0.25,
                                       torch.Generator().manual_seed(3)))
    whole = tops.dropout(x, 0.5, g, entirety=True)
    assert len(torch.unique(whole)) == 1
