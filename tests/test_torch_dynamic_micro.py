"""Port parity: the dynamic graph (nn/dynamic.py) and the micro-ops IR
(nn/micro.py) of ccv_tpu_torch against ccv_tpu's on the same inputs, on
the CPU.

Tolerances: float32 results within 1e-6 of the largest magnitude (the
same arithmetic; autograd and jax.vjp sum the same terms), gather and
select results equal; the optimizer steps of ``minimize`` as
tests/test_torch_train.py's (1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccv_tpu.nn import micro as jmicro
from ccv_tpu.nn import optimizers as jopt
from ccv_tpu.nn.dynamic import DynamicGraph as JGraph
from ccv_tpu_torch.nn import micro as tmicro
from ccv_tpu_torch.nn import optimizers as topt
from ccv_tpu_torch.nn.dynamic import DynamicGraph as TGraph


def _close(got, want, rel=1e-6):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    tol = rel * max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol


# ---------------------------------------------------------------------------
# the dynamic graph
# ---------------------------------------------------------------------------

def _chain(g, lib, x0, w0, w1):
    """Two layers: tanh(x @ w0) @ w1, the loss sum of squares."""
    x = g.constant(x0)
    a, b = g.variable(w0), g.variable(w1)
    h = g.exec(lambda u, v: lib.tanh(u @ v), x, a)
    y = g.exec(lambda u, v: u @ v, h, b)
    loss = g.exec(lambda v: (v * v).sum(), y)
    return loss, (a, b)


def _arrays(seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (4, 5)).astype(np.float32),
            rng.normal(0, 0.5, (5, 6)).astype(np.float32),
            rng.normal(0, 0.5, (6, 3)).astype(np.float32))


def test_dynamic_backward_two_layers():
    """d loss / d (w0, w1) of the two-layer chain, and the backward with a
    seed ``dy`` on an intermediate."""
    arrs = _arrays(0)
    jg, tg = JGraph(), TGraph(device="cpu")
    jl, jw = _chain(jg, jnp, *arrs)
    tl, tw = _chain(tg, torch, *arrs)
    _close(tl.value, jl.value)
    for a, b in zip(tg.backward(tl, tw), jg.backward(jl, jw)):
        _close(a, b)
    dy = np.linspace(-1, 1, 24, dtype=np.float32).reshape(4, 6)
    jh, th = jg._tape[0][2][0], tg._tape[0][2][0]
    (ja,) = jg.backward(jh, jw[:1], dy=dy)
    (ta,) = tg.backward(th, tw[:1], dy=dy)
    _close(ta, ja)


def test_dynamic_unreached_and_no_grad():
    """A wrt variable the output does not reach gets zeros (jax.vjp's);
    no_grad records nothing; an output no wrt reaches raises."""
    g = TGraph(device="cpu")
    a, b = g.variable(np.float32(3.0)), g.variable(np.float32(4.0))
    c = g.exec(lambda u: u * u, a)
    da, db = g.backward(c, (a, b))
    assert float(da) == 6.0 and float(db) == 0.0
    with g.no_grad():
        d = g.exec(lambda u: u * 10.0, b)
    assert len(g._tape) == 1 and float(d.value) == 40.0
    with pytest.raises(ValueError, match="does not depend"):
        g.backward(d, (a,))
    assert "lambda" in g.dot()


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_dynamic_minimize(opt):
    """Three ``minimize`` steps of the chain (tape reset between them):
    the variables' values against ccv_tpu's."""
    x0, w0, w1 = _arrays(1)
    make = {"sgd": (jopt.sgd(rate=0.05), topt.sgd(rate=0.05)),
            "adam": (jopt.adam(rate=0.01), topt.adam(rate=0.01))}[opt]
    results = []
    for g, lib, o in ((JGraph(), jnp, make[0]),
                      (TGraph(device="cpu"), torch, make[1])):
        state = None
        a, b = g.variable(w0), g.variable(w1)
        x = g.constant(x0)
        for _ in range(3):
            g.reset_tape()
            h = g.exec(lambda u, v: lib.tanh(u @ v), x, a)
            y = g.exec(lambda u, v: u @ v, h, b)
            loss = g.exec(lambda v: (v * v).sum(), y)
            state = g.minimize(loss, o, (a, b), state)
        results.append((a.value, b.value))
    for t, j in zip(results[1], results[0]):
        _close(t, j)
    # the variables were copies: the caller's arrays are unchanged
    assert np.array_equal(w0, _arrays(1)[1]) and np.array_equal(
        w1, _arrays(1)[2])


# ---------------------------------------------------------------------------
# micro ops: the cases of tests/test_micro.py, both packages
# ---------------------------------------------------------------------------

def _conv(m, with_params):
    x, w = m.input(4), m.input(4)
    kh, kw, kc = ("$kh", "$kw", "$kc") if with_params else ("3", "3", "2")
    params = ["$kh", "$kw", "$kc"] if with_params else []
    shape = ["dA0", f"dA1 - {kh} + 1", f"dA2 - {kw} + 1", kh, kw, "dA3", kc]
    xx = m.reindex(shape, [x], ["i0", "i1 + i3", "i2 + i4", "i5"], x)
    ww = m.reindex(shape, [x], ["i6", "i3", "i4", "i5"], w)
    y = m.reduce(m.REDUCE_OP_SUM, [3, 4, 5],
                 m.binary(m.BINARY_OP_MUL, xx, ww))
    return m.Combine([x, w], params, [y], [m.grad(y), x, w],
                     [m.grad(x), m.grad(w)])


def _matmul(m):
    a, b = m.input(2), m.input(2)
    aa = m.reindex(["dA0", "dA1[=dB0]", "dB1"], [a, b], ["i0", "i1"], a)
    bb = m.reindex(["dA0", "dB0[=dA1]", "dB1"], [a, b], ["i1", "i2"], b)
    c = m.reduce(m.REDUCE_OP_SUM, [1], m.binary(m.BINARY_OP_MUL, aa, bb))
    return m.Combine([a, b], [], [c], [m.grad(c), a, b],
                     [m.grad(a), m.grad(b)])


def _unary_transpose(m):
    x = m.input(2)
    t = m.reindex(["dA1", "dA0"], [x], ["i1", "i0"], x)
    return m.Combine([x], [], [m.unary(m.UNARY_OP_EXP, t)])


def _shift(m):
    """An out-of-bounds read (the column shifted off reads 0)."""
    x = m.input(2)
    return m.Combine([x], [], [m.reindex(["dA0", "dA1"], [x],
                                         ["i0", "i1 - 1"], x)])


def _select(m):
    x, idx = m.input(2), m.input(2)
    return m.Combine([x, idx], [], [m.select(1, x, idx)])


def _reduce(op):
    def build(m):
        x = m.input(2)
        s = m.reindex(["dA0 / $k", "dA1"], [x], ["i0 * $k", "i1"], x)
        return m.Combine([x], ["$k"], [m.reduce(getattr(m, op), [1], s)])
    return build


def _truncating(m):
    """(i0 - 1) / 2 at i0 = 0 is 0 in C (floor division would read -1)."""
    x = m.input(1)
    return m.Combine([x], [], [m.reindex(["dA0"], [x], ["(i0 - 1) / 2"], x)])


def _binaries(m):
    a, b = m.input(2), m.input(2)
    outs = [m.binary(getattr(m, op), a, b) for op in (
        "BINARY_OP_PLUS", "BINARY_OP_MINUS", "BINARY_OP_DIV",
        "BINARY_OP_MAX", "BINARY_OP_MIN", "BINARY_OP_EQUAL_TO",
        "BINARY_OP_LESS_THAN")]
    outs += [m.unary(m.UNARY_OP_NEG, a), m.unary(m.UNARY_OP_LOG,
                                                m.binary(m.BINARY_OP_MUL,
                                                         a, a))]
    return m.Combine([a, b], [], outs)


def _inputs(case, rng):
    if case in ("conv", "conv_params"):
        return [rng.random((1, 4, 4, 5), np.float32),
                rng.random((2, 3, 3, 5), np.float32)]
    if case == "matmul":
        return [rng.random((4, 2), np.float32), rng.random((2, 3), np.float32)]
    if case == "select":
        return [np.arange(6, dtype=np.float32).reshape(2, 3),
                np.array([[2, 0, 1], [1, 1, 0]], np.float32)]
    if case == "truncating":
        return [np.arange(4, dtype=np.float32) + 1.0]
    if case.startswith("reduce"):
        return [rng.normal(0, 1, (4, 3)).astype(np.float32)]
    if case == "binaries":
        a = rng.normal(0, 1, (3, 4)).astype(np.float32)
        b = rng.normal(0, 1, (3, 4)).astype(np.float32)
        b[0, :2] = a[0, :2]
        return [a, b]
    return [np.arange(6, dtype=np.float32).reshape(2, 3)]


CASES = {"conv": lambda m: _conv(m, False), "conv_params": lambda m: _conv(
    m, True), "matmul": _matmul, "unary_transpose": _unary_transpose,
    "shift": _shift, "select": _select, "truncating": _truncating,
    "binaries": _binaries,
    **{f"reduce_{op[10:].lower()}": _reduce(op) for op in (
        "REDUCE_OP_SUM", "REDUCE_OP_MAX", "REDUCE_OP_MIN", "REDUCE_OP_MEAN",
        "REDUCE_OP_PROD", "REDUCE_OP_ARGMAX", "REDUCE_OP_ARGMIN")}}
VALUES = {"conv_params": [3, 3, 2]}


@pytest.mark.parametrize("case", sorted(CASES))
def test_micro_forward(case):
    """Each case's forward through both interpreters."""
    ins = _inputs(case, np.random.default_rng(1))
    values = VALUES.get(case, [2] if case.startswith("reduce") else [])
    want = CASES[case](jmicro).interpret("forward", ins, values)
    got = CASES[case](tmicro).interpret("forward", ins, values,
                                        device="cpu")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("case", ["conv", "conv_params", "matmul"])
def test_micro_backward(case):
    """The backward convention (cotangent, then the forward inputs again):
    both gradients against ccv_tpu's jax.vjp, and into given buffers."""
    rng = np.random.default_rng(2)
    ins = _inputs(case, rng)
    c_j, c_t = CASES[case](jmicro), CASES[case](tmicro)
    values = VALUES.get(case, [])
    (y,) = c_j.interpret("forward", ins, values)
    dy = rng.normal(0, 1, y.shape).astype(np.float32)
    want = c_j.interpret("backward", [dy] + ins, values)
    bufs = [np.zeros(a.size, np.float32) for a in ins]
    got = c_t.interpret("backward", [dy] + ins, values, outputs=bufs,
                        device="cpu")
    for g, w, b in zip(got, want, bufs):
        _close(g, w)
        _close(b.reshape(w.shape), w)


def test_micro_errors():
    """Annotation, rank and convention errors raise as in ccv_tpu."""
    a, b = tmicro.input(2), tmicro.input(2)
    aa = tmicro.reindex(["dA0", "dA1[=dB0]", "dB1"], [a, b], ["i0", "i1"], a)
    with pytest.raises(ValueError, match="annotation"):
        tmicro.Combine([a, b], [], [aa]).interpret(
            "forward", [np.ones((4, 2), np.float32),
                        np.ones((5, 3), np.float32)], device="cpu")
    x = tmicro.input(2)
    y = tmicro.reindex(["dA0"], [x], ["i0"], x)
    with pytest.raises(ValueError, match="index expressions"):
        tmicro.Combine([x], [], [y]).interpret(
            "forward", [np.zeros((2, 2), np.float32)], device="cpu")
    c = tmicro.Combine([x], [], [y], [tmicro.grad(y)], [tmicro.grad(x)])
    with pytest.raises(ValueError, match="supply every forward input"):
        c.interpret("backward", [np.zeros(2, np.float32)], device="cpu")
    with pytest.raises(ValueError, match="unknown unary"):
        tmicro.unary("sin", x)


def test_micro_emit_names_the_op():
    """``emit`` gives the traced program's code, which names each op."""
    x = tmicro.input(1)
    text = tmicro.Combine([x], [], [tmicro.unary(tmicro.UNARY_OP_EXP, x)]
                          ).emit([], [(8,)])
    assert "exp" in text
    text = CASES["matmul"](tmicro).emit([], [(4, 2), (2, 3)])
    assert "mul" in text and "sum" in text
