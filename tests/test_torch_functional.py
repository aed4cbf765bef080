"""Port parity: the graph-model API of ccv_tpu_torch/nn/functional.py
against ccv_tpu/nn/functional.py, on the CPU.

Every constructor runs in a one-node graph of each package, with
``ccv_tpu``'s parameters carried across by ``params_from_jax`` (topological
position), on the same numpy inputs. Then a small residual network:
``build``'s shapes, ``dot``'s text (both node counters set to the same
start), ``model_copy``, parameter access, and checkpoints written by each
package and read by the other.

Tolerances: float32 outputs within 1e-5 + 1e-5 * max|ccv_tpu| (the same
arithmetic in another order); integer outputs, shapes and checkpoint bits
equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccv_tpu.nn import functional as JF
from ccv_tpu.nn import layers as JL
from ccv_tpu.nn import ops as jops
from ccv_tpu_torch.nn import functional as TF
from ccv_tpu_torch.nn import layers as TL
from ccv_tpu_torch.nn import ops as tops
from ccv_tpu_torch.nn.model import Sequential

S = (2, 3, 4)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want):
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    assert got.shape == want.shape, (got.shape, want.shape)
    tol = 1e-5 + 1e-5 * float(np.abs(want).max()) if want.size else 0
    assert float(np.abs(got - want).max(initial=0)) <= tol


def _same(got, want):
    """Integer results equal, float ones within the float32 tolerance."""
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    w = np.asarray(want)
    if np.issubdtype(w.dtype, np.integer) or w.dtype == bool:
        np.testing.assert_array_equal(got.numpy(), w)
    else:
        _close(got, w)


# name: (input shapes; "int:<n>" draws integers below n), graph builder
# (functional module, layers module, ops module, dtypes, nodes) -> outputs
CASES = {
    "add": ([S, S, S], lambda F, L, O, D, n: F.Add()(*n)),
    "mul": ([S, S], lambda F, L, O, D, n: F.Mul(0.5)(*n)),
    "concat": ([S, (2, 3, 2)], lambda F, L, O, D, n: F.Concat(-1)(*n)),
    "concat_axis0": ([S, S], lambda F, L, O, D, n: F.Concat(0)(*n)),
    "chunk_pick": ([S], lambda F, L, O, D, n: [
        F.Pick(i)(F.Chunk(2, -1)(n[0])) for i in (1, 0)]),
    "extract": ([S], lambda F, L, O, D, n: F.Extract(2)(
        F.Chunk(3, 1)(n[0]))),
    "reduce_sum": ([S], lambda F, L, O, D, n: F.Reduce("sum", 1)(n[0])),
    "reduce_mean": ([S], lambda F, L, O, D, n: F.Reduce(
        "mean", (0, 2), keepdims=True)(n[0])),
    "reduce_max": ([S], lambda F, L, O, D, n: F.Reduce("max", -1)(n[0])),
    "reduce_min": ([S], lambda F, L, O, D, n: F.Reduce("min", 0)(n[0])),
    "reduce_norm2": ([S], lambda F, L, O, D, n: F.Reduce(
        "norm2", (1, 2))(n[0])),
    "gru": ([(2, 5, 3)], lambda F, L, O, D, n: F.GRU(4)(n[0])),
    "index_select": ([(6, 4), "int:6"], lambda F, L, O, D, n:
                     F.IndexSelect()(*n)),
    "div": ([S, S], lambda F, L, O, D, n: F.Div()(*n)),
    "div_reciprocal": ([S], lambda F, L, O, D, n: F.Div(True)(n[0])),
    "max": ([S, S], lambda F, L, O, D, n: F.Max()(*n)),
    "min": ([S, S], lambda F, L, O, D, n: F.Min()(*n)),
    "matmul": ([(2, 3, 4), (2, 4, 5)], lambda F, L, O, D, n:
               F.Matmul()(*n)),
    "matmul_t": ([(2, 4, 3), (2, 5, 4)], lambda F, L, O, D, n:
                 F.Matmul(True, True)(*n)),
    "cmul": ([S, S], lambda F, L, O, D, n: F.CMul()(*n)),
    "masked_fill": ([S, "int:2"], lambda F, L, O, D, n:
                    F.MaskedFill(1.0, -5.0)(*n)),
    "scalar": ([S], lambda F, L, O, D, n: F.Scalar(2.5)(n[0])),
    "scalar_mul": ([S], lambda F, L, O, D, n: F.ScalarMul(-3.0)(n[0])),
    "clamp": ([S], lambda F, L, O, D, n: F.Clamp(-0.5, 0.25)(n[0])),
    "sqrt": ([S], lambda F, L, O, D, n: F.Sqrt()(
        F.Clamp(0.0, None)(n[0]))),
    "argmax": ([S], lambda F, L, O, D, n: F.ArgMax(1)(n[0])),
    "argmin": ([S], lambda F, L, O, D, n: F.ArgMin(-1)(n[0])),
    "cast": ([S], lambda F, L, O, D, n: F.DatatypeConversion(
        D["int32"])(F.ScalarMul(10.0)(n[0]))),
    "contiguous": ([S], lambda F, L, O, D, n: F.Contiguous()(
        L.Transpose(0, 2)(n[0]))),
    "move": ([S], lambda F, L, O, D, n: F.Move()(n[0])),
    "parameter": ([S], lambda F, L, O, D, n: F.Add()(
        n[0], F.Parameter((3, 4), init_bound=0.5)(n[0]))),
    "parameter_zeros": ([S], lambda F, L, O, D, n: F.Parameter((5,))(n[0])),
    "variable": ([S], lambda F, L, O, D, n: F.Variable((2, 2))(n[0])),
    "debug": ([S], lambda F, L, O, D, n: F.Debug(lambda v: None)(n[0])),
    "squeeze": ([(2, 1, 4, 1)], lambda F, L, O, D, n: F.Squeeze()(n[0])),
    "squeeze_axis": ([(2, 1, 4, 1)], lambda F, L, O, D, n:
                     F.Squeeze(-1)(n[0])),
    "cmd_exec": ([S], lambda F, L, O, D, n: F.CmdExec(O.softmax)(n[0])),
    "dynamic": ([S], lambda F, L, O, D, n: F.Dynamic(
        lambda s: L.Dense(s[-1] * 2))(n[0])),
}
J_DT = {"int32": jnp.int32}
T_DT = {"int32": torch.int32}


def _inputs(specs, seed):
    out = []
    for i, s in enumerate(specs):
        if isinstance(s, str):
            n = int(s.split(":")[1])
            shape = (2, 3, 4) if n == 2 else (5,)
            out.append(np.random.default_rng(seed + i).integers(
                0, n, shape).astype(np.int32))
        else:
            out.append(_rand(s, seed + i))
    return out


def _pair(specs, build, xs):
    jin = [JF.Input() for _ in specs]
    tin = [TF.Input() for _ in specs]
    jout = build(JF, JL, jops, J_DT, jin)
    tout = build(TF, TL, tops, T_DT, tin)
    jout = jout if isinstance(jout, list) else [jout]
    tout = tout if isinstance(tout, list) else [tout]
    jm, tm = JF.Model(jin, jout), TF.Model(tin, tout)
    shapes = [x.shape for x in xs]
    assert tm.build(shapes, device="cpu") == \
        jm.build(shapes, key=jax.random.PRNGKey(0))
    TF.params_from_jax(jm, tm, "cpu")
    return jm, tm


@pytest.mark.parametrize("name", sorted(CASES))
def test_constructor_matches_ccv_tpu(name):
    specs, build = CASES[name]
    xs = _inputs(specs, 40)
    jm, tm = _pair(specs, build, xs)
    want = jm.evaluate([jnp.asarray(x) for x in xs])
    got = tm.evaluate([torch.from_numpy(x) for x in xs])
    _same(got, want)
    _same(tm([torch.from_numpy(x) for x in xs]), want)


def test_dynamic_builds_its_inner_layer_at_init():
    layer = TF.Dynamic(lambda s: TL.Dense(s[-1] + 1))
    with pytest.raises(RuntimeError):
        layer.apply({}, {}, torch.zeros(1, 2))
    p, _, out = layer.init(torch.Generator().manual_seed(0), (3, 4))
    assert out == (3, 5) and p["w"].shape == (4, 5)


def test_layer_call_takes_nodes_only():
    with pytest.raises(TypeError):
        TL.ReLU()(torch.zeros(2))


def test_training_waits():
    """The training methods wait for their prerequisites: ``compile`` for
    a built model, ``fit`` / ``backward`` for ``compile``,
    ``apply_gradients`` for ``backward``; data parallelism over more
    ranks than the process group holds raises, naming its world size
    (tests/test_torch_train.py trains the graph model)."""
    from ccv_tpu_torch.nn import optimizers

    x = TF.Input()
    m = TF.Model([x], [TL.Dense(2)(x)])
    with pytest.raises(RuntimeError, match="build"):
        m.compile(optimizers.sgd(), "mse")
    for meth in (m.fit, m.backward):
        with pytest.raises(RuntimeError, match="compile"):
            meth(torch.zeros(1, 3), torch.zeros(1, 2))
    m.build((1, 3), device="cpu")
    m.compile(optimizers.sgd(), "mse")
    with pytest.raises(RuntimeError, match="backward"):
        m.apply_gradients()
    with pytest.raises(ValueError, match="holds 1 rank"):
        m.set_data_parallel(2)


# ---------------------------------------------------------------------------
# a residual network: shapes, dot, copy, parameters, checkpoints
# ---------------------------------------------------------------------------

NET_IN = (2, 8, 8, 3)


def _net(F, L):
    x = F.Input()
    h = L.Convolution(8, (3, 3), name="stem")(x)
    h = L.BatchNorm(name="bn")(h)
    h = L.ReLU()(h)
    a = L.Convolution(8, (3, 3), no_bias=True, name="a")(h)
    b = L.Convolution(8, (1, 1), name="b")(h)
    y = F.Add()(a, b, h)
    y = L.MaxPool((2, 2))(y)
    c = F.Concat(-1)(y, L.AvgPool((2, 2))(h))
    out = L.Dense(5, name="head")(L.Flatten()(c))
    return F.Model([x], [out, c], name="resnet_tiny")


def _randomize_state(model, seed):
    rng = np.random.default_rng(seed)
    for uid in model.state:
        for k, v in model.state[uid].items():
            lo = 0.5 if k == "var" else -0.5
            model.state[uid][k] = jnp.asarray(rng.uniform(
                lo, 1.5, np.shape(v)).astype(np.float32))
    for uid in model.params:
        for k, v in model.params[uid].items():
            if k in ("b", "bias", "scale"):
                model.params[uid][k] = jnp.asarray(rng.normal(
                    0, 0.5, np.shape(v)).astype(np.float32))


@pytest.fixture(scope="module")
def nets():
    start = max(JF.Node._counter[0], TF.Node._counter[0]) + 1
    JF.Node._counter[0] = TF.Node._counter[0] = start
    jm = _net(JF, JL)
    JF.Node._counter[0] = start
    tm = _net(TF, TL)
    assert tm.build(NET_IN, device="cpu") == \
        jm.build(NET_IN, key=jax.random.PRNGKey(3))
    _randomize_state(jm, 4)
    TF.params_from_jax(jm, tm, "cpu")
    return jm, tm


def _outputs_equal(jm, tm, seed=5):
    x = _rand(NET_IN, seed)
    want = jm.evaluate(jnp.asarray(x))
    got = tm.evaluate(torch.from_numpy(x))
    _same(got, want)


def test_network_matches_ccv_tpu(nets):
    jm, tm = nets
    assert [n.layer.name for n in tm.order] == \
        [n.layer.name for n in jm.order]
    assert tm.output_shape == jm.output_shape
    assert tm.parameter_count() == jm.parameter_count()
    assert not tm.parameters_isnan()
    _outputs_equal(jm, tm)


def test_dot_text_equal(nets):
    jm, tm = nets
    assert tm.dot() == jm.dot()


def test_checkpoints_cross_packages(nets, tmp_path):
    """ccv_tpu's checkpoint read by the port, the port's by ccv_tpu: the
    same rows, the same bits, the same outputs."""
    jm, tm = nets
    jpath, tpath = str(tmp_path / "j.sqlite3"), str(tmp_path / "t.sqlite3")
    jm.write(jpath)
    fresh = _net(TF, TL)
    fresh.build(NET_IN, torch.Generator().manual_seed(9), device="cpu")
    fresh.read(jpath, name="resnet_tiny")
    _outputs_equal(jm, fresh)
    tm.write(tpath)
    jfresh = _net(JF, JL)
    jfresh.build(NET_IN, key=jax.random.PRNGKey(11))
    jfresh.read(tpath, name="resnet_tiny")
    _outputs_equal(jfresh, tm)
    import sqlite3

    rows = [sqlite3.connect(p).execute(
        "SELECT name, type, datatype, dim, data FROM tensors ORDER BY name"
    ).fetchall() for p in (jpath, tpath)]
    assert rows[0] == rows[1]


def test_read_missing_row_raises(nets, tmp_path):
    _, tm = nets
    path = str(tmp_path / "other.sqlite3")
    tm.write(path, name="other")
    with pytest.raises(KeyError):
        tm.read(path)


def test_params_from_jax_checks_topology(nets):
    jm, _ = nets
    x = TF.Input()
    other = TF.Model([x], [TL.Dense(5)(x)])
    other.build((2, 3), device="cpu")
    with pytest.raises(ValueError):
        TF.params_from_jax(jm, other, "cpu")


def test_model_copy(nets):
    _, tm = nets
    new = TF.model_copy(tm, is_trainable=False)
    assert new is not tm and new.params is None and not new.is_trainable
    assert [n.layer.name for n in new.order] == \
        [n.layer.name for n in tm.order]
    assert new.build(NET_IN, device="cpu") == tm.output_shape
    assert new.dot() == tm.dot()
    seq = Sequential([TL.Dense(3), TL.ReLU()], name="s")
    copied = TF.model_copy(seq)
    assert isinstance(copied, Sequential) and copied.name == "s"
    assert copied.layers[0] is not seq.layers[0]
    with pytest.raises(TypeError):
        TF.model_copy(object())


def test_set_parameters_and_call(nets):
    jm, tm = nets
    x = torch.from_numpy(_rand(NET_IN, 6))
    params = tm.parameters()
    tm.set_parameters(params)
    out, c = tm(x)
    assert out.shape == (2, 5) and c.shape == tuple(jm.output_shape[1])
    assert out.requires_grad is False
