"""Port parity: training in ccv_tpu_torch (nn/optimizers.py's tree
optimizers, clip_grad_norm and grads_isnan; batch norm in training; the
training half of Sequential and the graph Model; gradient checkpointing,
memory compression and reduction; trainer checkpoints) against ccv_tpu on
the same parameters and inputs, on the CPU.

Tolerances:
- optimizer updates, batch norm: within 1e-6 of each tensor's largest
  magnitude (the same float32 arithmetic, fused or ordered otherwise);
- model steps (three fits, backward + apply_gradients, resumed
  checkpoints): losses, parameters, layer states and optimizer states
  within 1e-5 of each tensor's largest magnitude (XLA's and oneDNN's
  convolution sums in other orders, through three updates). The narrow
  models' convolutions before a batch norm carry no bias: its exact
  gradient is 0, and Adam would move it on rounding noise;
- the port against itself (checkpointing, memory reduction on inputs that
  bfloat16 holds exactly, the replayed dropout masks): within 1e-6.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccv_tpu.nn import functional as JF
from ccv_tpu.nn import layers as JL
from ccv_tpu.nn import model as jmodel
from ccv_tpu.nn import ops as jops
from ccv_tpu.nn import optimizers as jopt
from ccv_tpu_torch.nn import functional as TF
from ccv_tpu_torch.nn import layers as TL
from ccv_tpu_torch.nn import model as tmodel
from ccv_tpu_torch.nn import ops as tops
from ccv_tpu_torch.nn import optimizers as topt
from ccv_tpu_torch.utils import flags

SEQ_IN = (4, 8, 8, 3)
CLASSES = 5
OPTIMIZERS = {
    "sgd": dict(rate=0.05, momentum=0.9),
    "sgd_nesterov": dict(rate=0.05, momentum=0.9, decay=0.01, nesterov=True),
    "sgd_dampened": dict(rate=0.05, momentum=0.5, dampening=0.2, scale=0.5),
    "rmsprop": dict(rate=0.01, decay=0.01),
    "lamb": dict(rate=0.01, decay=0.01),
    "adam": dict(rate=0.01),
    "adamw": dict(rate=0.01, decay=0.05),
}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _opt(mod, name):
    kind = name.split("_")[0]
    return getattr(mod, kind)(**OPTIMIZERS[name])


def _np(t):
    return t.detach().cpu().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _close(got, want, rel):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    tol = rel * max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol, \
        (float(np.abs(got - want).max()), tol)


def _tree(seed):
    rng = np.random.default_rng(seed)
    return [{"w": rng.normal(0, 1, (3, 4)).astype(np.float32),
             "b": rng.normal(0, 1, (4,)).astype(np.float32)},
            {"k": rng.normal(0, 1, (2, 2, 3)).astype(np.float32)}]


def _torch_tree(tree):
    return [{k: torch.from_numpy(v.copy()) for k, v in d.items()}
            for d in tree]


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_tree_optimizer_three_updates(name):
    """Three updates from the same parameters and gradients: parameters and
    every state leaf (in ccv_tpu's leaf order) within 1e-6."""
    jp = jax.tree_util.tree_map(jnp.asarray, _tree(0))
    tp = _torch_tree(_tree(0))
    jo, to = _opt(jopt, name), _opt(topt, name)
    js, ts = jo.init(jp), to.init(tp)
    for step in range(3):
        g = _tree(10 + step)
        jp, js = jo.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        tp, ts = to.update(_torch_tree(g), ts, tp)
    for a, b in zip(topt.leaves(tp), jax.tree_util.tree_leaves(jp)):
        _close(a, b, 1e-6)
    jl = jax.tree_util.tree_leaves(js)
    tl = topt.state_leaves(ts)
    assert len(jl) == len(tl)
    for a, b in zip(tl, jl):
        _close(a, b, 1e-6)


@pytest.mark.parametrize("name", ["sgd", "rmsprop", "lamb", "adam"])
def test_opt_state_from_jax(name):
    """A ccv_tpu state after two updates carried across, then one update
    on each side: the same parameters."""
    jp = jax.tree_util.tree_map(jnp.asarray, _tree(1))
    jo, to = _opt(jopt, name), _opt(topt, name)
    js = jo.init(jp)
    for step in range(2):
        jp, js = jo.update(jax.tree_util.tree_map(jnp.asarray,
                                                  _tree(20 + step)), js, jp)
    tp = _torch_tree(jax.tree_util.tree_map(np.asarray, jp))
    ts = topt.opt_state_from_jax(js, to.init(tp))
    g = _tree(30)
    jp, js = jo.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
    tp, ts = to.update(_torch_tree(g), ts, tp)
    for a, b in zip(topt.leaves(tp), jax.tree_util.tree_leaves(jp)):
        _close(a, b, 1e-6)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_grad_norm(max_norm):
    """The total norm and the clipped gradients (the factor below 1, and
    1 when the norm is under the limit)."""
    g = _tree(2)
    jg, jt = jopt.clip_grad_norm(jax.tree_util.tree_map(jnp.asarray, g),
                                 max_norm)
    tg, tt = topt.clip_grad_norm(_torch_tree(g), max_norm)
    _close(tt, jt, 1e-6)
    for a, b in zip(topt.leaves(tg), jax.tree_util.tree_leaves(jg)):
        _close(a, b, 1e-6)
    factor = min(1.0, max_norm / float(tt))
    assert (factor < 1.0) == (max_norm < 1.0)
    assert abs(float(tg[0]["w"][0, 0]) - g[0]["w"][0, 0] * factor) <= 1e-6


@pytest.mark.parametrize("nan", [False, True])
def test_grads_isnan(nan):
    g = _tree(3)
    if nan:
        g[1]["k"][1, 0, 2] = np.nan
    want = bool(jopt.grads_isnan(jax.tree_util.tree_map(jnp.asarray, g)))
    got = topt.grads_isnan(_torch_tree(g))
    assert got.dtype == torch.bool and bool(got) == want == nan


# ---------------------------------------------------------------------------
# batch norm in training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["NHWC", "NCHW", "CHWN", None])
def test_batch_norm_training(fmt):
    """y, the running mean and the running var (population variance) of
    both branches, ``format=`` and ``axis=``, within 1e-6."""
    rng = np.random.default_rng(4)
    x = rng.normal(1, 2, (3, 5, 6, 4)).astype(np.float32)
    if fmt == "NCHW":
        x = x.transpose(0, 3, 1, 2).copy()
    elif fmt == "CHWN":
        x = x.transpose(3, 1, 2, 0).copy()
    c = 4
    scale, bias, mean = (rng.normal(0, 1, c).astype(np.float32)
                         for _ in range(3))
    var = rng.uniform(0.5, 2, c).astype(np.float32)
    kw = dict(is_training=True, momentum=0.8)
    if fmt is not None:
        kw["format"] = fmt
    want = jops.batch_norm(jnp.asarray(x), *(jnp.asarray(a) for a in (
        scale, bias, mean, var)), 1e-4, **kw)
    got = tops.batch_norm(torch.from_numpy(x), *(torch.from_numpy(a) for a in (
        scale, bias, mean, var)), 1e-4, **kw)
    for a, b in zip(got, want):
        _close(a, b, 1e-6)


def test_batch_norm_layer_training_state():
    """The layer in training: batch statistics out, the running ones as
    its state (detached); at inference the state is used."""
    rng = np.random.default_rng(5)
    x = rng.normal(0, 3, (6, 4, 4, 3)).astype(np.float32)
    jl, tl = JL.BatchNorm(momentum=0.7), TL.BatchNorm(momentum=0.7)
    jp, js, _ = jl.init(jax.random.PRNGKey(0), x.shape)
    tp, ts, _ = tl.init(torch.Generator().manual_seed(0), x.shape)
    jy, jns = jl.apply(jp, js, jnp.asarray(x), training=True)
    xt = torch.from_numpy(x).requires_grad_()
    ty, tns = tl.apply(tp, ts, xt, training=True)
    _close(ty, jy, 1e-6)
    for k in ("mean", "var"):
        _close(tns[k], jns[k], 1e-6)
        assert not tns[k].requires_grad
    _close(tl.apply(tp, tns, xt)[0], jl.apply(jp, jns, jnp.asarray(x))[0],
           1e-6)


_WIDE_OPS = {
    "batch_norm": lambda x: tops.batch_norm(
        x, torch.ones(3, dtype=x.dtype), torch.zeros(3, dtype=x.dtype),
        torch.zeros(3, dtype=x.dtype), torch.ones(3, dtype=x.dtype),
        is_training=True)[0],
    "avg_pool": lambda x: tops.avg_pool(x, (2, 2), (1, 1), "SAME"),
    "upsample": lambda x: tops.upsample(x, 2, 2, "bilinear"),
    "layer_norm": lambda x: tops.layer_norm(x),
    "gemm": lambda x: tops.gemm(x.reshape(-1, 3), x.reshape(-1, 3).mT),
}


@pytest.mark.parametrize("op", sorted(_WIDE_OPS))
def test_float64_stays_float64(op):
    """The ops that sum "in float32" keep a float64 input in float64 (the
    coco step's float64 gradients, card against CPU, rest on it): the
    result is float64, and a change of one element that float32 cannot
    hold moves it."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.normal(1.0, 1.0, (2, 5, 5, 3)))
    fn = _WIDE_OPS[op]
    y = fn(x)
    assert y.dtype == torch.float64
    x2 = x.clone()
    x2[0, 0, 0, 0] += 1e-9
    assert 0 < float((fn(x2) - y).abs().max()) < 1e-6
    torch.testing.assert_close(fn(x.float()), y.float(), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

def _seq_layers(L):
    return [L.Convolution(8, (3, 3), no_bias=True, name="c0"),
            L.BatchNorm(name="bn"), L.ReLU(), L.Flatten(),
            L.Dense(CLASSES, name="fc")]


def _graph(F, L):
    """A residual block: conv, BN, ReLU, conv, BN, Add with the first
    ReLU's output, ReLU, 2x2 pool, flatten, dense."""
    x = F.Input()
    h = L.ReLU()(L.BatchNorm(name="bn0")(
        L.Convolution(8, (3, 3), no_bias=True, name="c0")(x)))
    h2 = L.BatchNorm(name="bn1")(
        L.Convolution(8, (3, 3), no_bias=True, name="c1")(h))
    y = L.ReLU()(F.Add()(h2, h))
    y = L.Flatten()(L.AvgPool((2, 2), (2, 2))(y))
    return F.Model([x], [L.Dense(CLASSES, name="fc")(y)], name="res")


def _pair(kind, opt_name=None, loss="softmax_crossentropy"):
    """(ccv_tpu model, port model) built on SEQ_IN with the port's
    parameters and states carried from ccv_tpu's, both compiled."""
    if kind == "seq":
        jm = jmodel.Sequential(_seq_layers(JL))
        tm = tmodel.Sequential(_seq_layers(TL))
        jm.build(SEQ_IN, jax.random.PRNGKey(0))
        tm.build(SEQ_IN, device="cpu")
        tm.params = tmodel.params_from_jax(jm.params, "cpu")
        tm.state = tmodel.params_from_jax(jm.state, "cpu")
    else:
        jm, tm = _graph(JF, JL), _graph(TF, TL)
        jm.build(SEQ_IN, jax.random.PRNGKey(0))
        tm.build(SEQ_IN, device="cpu")
        TF.params_from_jax(jm, tm, "cpu")
    _randomize(jm, tm)
    if opt_name is not None:
        jm.compile(_opt(jopt, opt_name), loss)
        tm.compile(_opt(topt, opt_name), loss)
    return jm, tm


def _randomize(jm, tm):
    """BN scales and shifts and the dense bias from a seed, on both."""
    rng = np.random.default_rng(6)
    for jt, tt in zip(_param_dicts(jm), _param_dicts(tm)):
        for k in sorted(jt):
            if k in ("scale", "bias", "b"):
                lo, hi = (0.5, 1.5) if k == "scale" else (-0.3, 0.3)
                a = rng.uniform(lo, hi, np.shape(jt[k])).astype(np.float32)
                jt[k] = jnp.asarray(a)
                tt[k] = torch.from_numpy(a.copy())


def _param_dicts(m):
    """A model's per-layer parameter dicts in layer (topological) order."""
    if isinstance(m.params, list):
        return m.params
    return [m.params[str(n.uid)] for n in m.order]


def _state_dicts(m):
    if isinstance(m.state, list):
        return m.state
    return [m.state[str(n.uid)] for n in m.order]


def _ordered(m):
    """A model's parameter, then state, tensors by layer (topological)
    position: comparable between two builds of a graph model, whose leaf
    orders follow their node uids."""
    return [d[k] for tree in (_param_dicts(m), _state_dicts(m))
            for d in tree for k in sorted(d)]


def _perm(jm, tm):
    return None if isinstance(tm.params, list) else TF.leaf_order(jm, tm)


def _batch(seed, n=SEQ_IN[0]):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n,) + SEQ_IN[1:]).astype(np.float32)
    y = rng.integers(0, CLASSES, n).astype(np.int32)
    return x, y


def _same_models(jm, tm, rel=1e-5, opt=True):
    for jt, tt in itertools.chain(zip(_param_dicts(jm), _param_dicts(tm)),
                                  zip(_state_dicts(jm), _state_dicts(tm))):
        assert sorted(jt) == sorted(tt)
        for k in jt:
            _close(tt[k], jt[k], rel)
    if opt:
        jl = jax.tree_util.tree_leaves(jm.opt_state)
        tl = topt.state_leaves(tm.opt_state)
        perm = _perm(jm, tm)
        if perm is not None:  # reorder the port's slots to ccv_tpu's
            n = len(perm)
            head = len(tl) % n
            inv = np.argsort(perm)
            tl = tl[:head] + [tl[head + k * n + int(i)]
                              for k in range((len(tl) - head) // n)
                              for i in inv]
        assert len(jl) == len(tl)
        for a, b in zip(tl, jl):
            _close(a, b, rel)


@pytest.mark.parametrize("kind,opt_name", list(itertools.product(
    ("seq", "graph"), ("sgd", "adam"))))
def test_three_fit_steps(kind, opt_name):
    """Three ``fit`` steps on three batches: each loss, then parameters,
    batch-norm running statistics and the optimizer state within 1e-5."""
    jm, tm = _pair(kind, opt_name)
    for step in range(3):
        x, y = _batch(40 + step)
        jl = jm.fit(jnp.asarray(x), jnp.asarray(y))
        tl = tm.fit(torch.from_numpy(x), torch.from_numpy(y))
        assert abs(tl - jl) <= 1e-5 * abs(jl), (step, tl, jl)
    _same_models(jm, tm)
    x, _ = _batch(50)
    _close(tm.evaluate(torch.from_numpy(x)), jm.evaluate(jnp.asarray(x)),
           1e-5)


@pytest.mark.parametrize("kind", ["seq", "graph"])
def test_backward_accumulates(kind):
    """``backward`` twice then ``apply_gradients`` = ccv_tpu's gradient
    accumulation: the losses, the summed step and the states."""
    jm, tm = _pair(kind, "sgd")
    for step in range(2):
        x, y = _batch(60 + step)
        jl = jm.backward(jnp.asarray(x), jnp.asarray(y))
        tl = tm.backward(torch.from_numpy(x), torch.from_numpy(y))
        assert abs(tl - jl) <= 1e-5 * abs(jl)
    jm.apply_gradients()
    tm.apply_gradients()
    assert tm._pending_grads is None
    _same_models(jm, tm)
    with pytest.raises(RuntimeError, match="backward"):
        tm.apply_gradients()


def test_cancel():
    """A cancelled fit returns None and changes nothing; the flag clears;
    a cancelled apply_gradients drops the stashed gradients."""
    _, tm = _pair("seq", "sgd")
    x, y = torch.from_numpy(_batch(70)[0]), torch.from_numpy(_batch(70)[1])
    before = [t.clone() for t in topt.leaves(tm.params)]
    tm.cancel()
    assert tm.fit(x, y) is None
    assert all(torch.equal(a, b) for a, b in zip(before,
                                                 topt.leaves(tm.params)))
    assert tm.fit(x, y) is not None
    tm.cancel()
    assert tm.backward(x, y) is None and tm._pending_grads is None
    assert tm.backward(x, y) is not None
    tm.cancel()
    tm.apply_gradients()
    assert tm._pending_grads is None


def test_data_parallel_not_ported():
    """set_data_parallel needs as many ranks as it is given: 2 in a world
    of one process raises naming the world size; 1 is the one-rank step
    (tests/test_torch_parallel_data.py runs 4 ranks)."""
    jm, tm = _pair("seq", "sgd")
    with pytest.raises(ValueError, match="holds 1 rank"):
        tm.set_data_parallel(2)
    tm.set_data_parallel(1)
    x, y = _batch(80)
    tl, jl = tm.fit(x, y), jm.fit(jnp.asarray(x), jnp.asarray(y))
    assert abs(tl - jl) <= 1e-5 * abs(jl)
    _same_models(jm, tm)


def test_parameters_zip_map():
    jm, tm = _pair("seq", None)
    other = [{k: torch.ones_like(v) for k, v in d.items()} for d in tm.params]
    tm.parameters_zip_map(lambda a, b: a + 2 * b, other)
    jm.parameters_zip_map(lambda a, b: a + 2 * b, jax.tree_util.tree_map(
        lambda v: jnp.ones_like(v), jm.params))
    _same_models(jm, tm, 1e-6, opt=False)


@pytest.mark.parametrize("loss", sorted(tmodel.LOSSES))
def test_losses(loss):
    """Every loss of ``LOSSES`` against ccv_tpu's on the same outputs."""
    rng = np.random.default_rng(7)
    out = rng.normal(0, 1, (6, 4)).astype(np.float32)
    if loss == "softmax_crossentropy":
        fit = rng.integers(0, 4, 6).astype(np.int32)
    elif loss == "categorical_crossentropy":
        out = np.abs(out) / np.abs(out).sum(-1, keepdims=True)
        fit = rng.integers(0, 4, 6).astype(np.int32)
    elif loss == "sigmoid_binary_crossentropy":
        fit = rng.integers(0, 2, (6, 4)).astype(np.float32)
    else:
        fit = rng.normal(0, 1, (6, 4)).astype(np.float32)
    want = jmodel.LOSSES[loss](jnp.asarray(out), jnp.asarray(fit))
    got = tmodel.LOSSES[loss](torch.from_numpy(out), torch.from_numpy(fit))
    _close(got, want, 1e-6)


# ---------------------------------------------------------------------------
# gradient checkpointing, memory compression and reduction
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["seq", "graph"])
def test_gradient_checkpointing_same_step(kind):
    """A step with gradient checkpointing = the step without, within
    1e-6 (the same arithmetic, recomputed)."""
    x, y = (torch.from_numpy(a) for a in _batch(80))
    runs = []
    for on in (False, True):
        _, tm = _pair(kind, "adam")
        tm.set_gradient_checkpointing(on)
        runs.append((tm.fit(x, y), _ordered(tm)))
    assert abs(runs[0][0] - runs[1][0]) <= 1e-6 * abs(runs[0][0])
    for a, b in zip(runs[0][1], runs[1][1]):
        _close(b, a, 1e-6)


def _dropout_model(rate=0.5):
    """Dense, then Dropout: the dense layer saves the input (exact in
    bfloat16 below), the dropout's gradient is its mask."""
    return tmodel.Sequential([TL.Dense(6, name="d0"), TL.Dropout(rate)])


def _exact_batch():
    """Inputs bfloat16 holds exactly (multiples of 1/8 in [-4, 4])."""
    rng = np.random.default_rng(9)
    x = rng.integers(-32, 33, (5, 8)).astype(np.float32) / 8
    return torch.from_numpy(x), torch.from_numpy(
        rng.normal(0, 1, (5, 6)).astype(np.float32))


@pytest.mark.parametrize("option", ["memory_reduction",
                                    "gradient_checkpointing"])
def test_recompute_replays_dropout(option):
    """Dropout(0.5) under ``option``: the recompute in the backward draws
    the forward's masks, so the gradients equal the plain step's with the
    same seed (another mask would give the gradients of another forward
    than the loss's). With inputs bfloat16 holds exactly, the dense
    layer's saved input round-trips exactly."""
    x, fit = _exact_batch()
    grads = []
    for on in (False, True):
        m = _dropout_model()
        m.build(tuple(x.shape), torch.Generator().manual_seed(3),
                device="cpu")
        m.compile(topt.sgd(rate=0.1, momentum=0.0), "mse")
        getattr(m, f"set_{option}")(on)
        _, g, _ = m._step(x, fit)
        grads.append(g)
        m._step_key[:] = 0  # the same generator again
    for a, b in zip(*grads):
        assert torch.equal(a, b), float((a - b).abs().max())
    assert any(float(g.abs().max()) > 0 for g in grads[0])


@pytest.mark.parametrize("wrap", ["reduced", "compressed"])
def test_recomputed_apply_replays_the_generator(wrap):
    """``compression.reduced_apply`` / ``compressed_apply`` around a layer
    that draws a dropout mask: the gradient equals the plain apply's with
    a generator at the same state, so the recompute drew the forward's
    mask, not the next one."""
    from ccv_tpu_torch.nn import compression

    def apply(p, s, x, training, gen):
        return tops.dropout(x * p["w"], 0.5, gen), s

    x = torch.from_numpy(np.arange(-8, 8, dtype=np.float32).reshape(
        1, 2, 2, 4) / 4)
    grads = []
    for wrapped in (False, True):
        w = torch.full((4,), 0.5, requires_grad=True)
        gen = torch.Generator().manual_seed(7)
        fn = apply
        if wrapped:
            fn = (compression.reduced_apply(apply, x.dtype, True)
                  if wrap == "reduced" else
                  compression.compressed_apply(apply, x.shape, x.dtype, True))
            y, _ = fn({"w": w}, {}, x, gen)
        else:
            y, _ = fn({"w": w}, {}, x, True, gen)
        (g,) = torch.autograd.grad((y * torch.arange(16.0).reshape(
            y.shape)).sum(), [w])
        grads.append(g)
    assert torch.equal(grads[0], grads[1]), grads


def test_memory_reduction_same_step_on_exact_inputs():
    """Memory reduction's step = the plain step (within 1e-6) where every
    saved input is on bfloat16's grid."""
    x, fit = _exact_batch()
    runs = []
    for on in (False, True):
        m = _dropout_model(rate=0.0)
        m.build(tuple(x.shape), torch.Generator().manual_seed(3),
                device="cpu")
        m.compile(topt.adam(rate=0.01), "mse")
        m.set_memory_reduction(on)
        runs.append((m.fit(x, fit), topt.leaves(m.params)))
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        _close(b, a, 1e-6)


@pytest.mark.parametrize("option", ["memory_reduction",
                                    "memory_compression"])
def test_memory_options_against_ccv_tpu(option):
    """The lossy options against ccv_tpu's: the same bf16 rounding or LSSC
    codes, so the same (lossy) step. One step: the two sides' activations
    differ in their last bits, which can move a value across a bf16
    rounding or LSSC level boundary, and later steps grow such a flip."""
    jm, tm = _pair("seq", "sgd")
    getattr(jm, f"set_{option}")(True)
    getattr(tm, f"set_{option}")(True)
    x, y = _batch(90)
    jl = jm.fit(jnp.asarray(x), jnp.asarray(y))
    tl = tm.fit(torch.from_numpy(x), torch.from_numpy(y))
    assert abs(tl - jl) <= 1e-5 * abs(jl)
    _same_models(jm, tm)


@pytest.mark.parametrize("kind", ["seq", "graph"])
def test_memory_compression_flag(kind, monkeypatch):
    """DISABLE_MEMORY_COMPRESSION turns the option off: the exact step;
    with the flag clear the (lossy) compressed step differs. The graph
    model takes the option too (ccv_tpu's Model has no such setter)."""
    x, y = (torch.from_numpy(a) for a in _batch(95))
    runs = []
    for option, flag in ((False, False), (True, True), (True, False)):
        if flag:
            monkeypatch.setattr(flags, "_flags",
                                flags.DISABLE_MEMORY_COMPRESSION)
        else:
            monkeypatch.setattr(flags, "_flags", 0)
        _, tm = _pair(kind, "sgd")
        tm.set_memory_compression(option)
        tm.fit(x, y)
        runs.append(_ordered(tm))
    assert all(torch.equal(a, b) for a, b in zip(runs[0], runs[1]))
    assert not all(torch.equal(a, b) for a, b in zip(runs[0], runs[2]))


# ---------------------------------------------------------------------------
# attention routing and a graph model with attention, trained
# ---------------------------------------------------------------------------

def test_attention_route_honours_the_flag(monkeypatch):
    """The route is the device and T alone: K2 on the card from T 1024, the
    plain op on the CPU or below 1024. DISABLE_PALLAS_FLASH_ATTENTION picks
    ccv_tpu's Pallas kernel or its plain op on the TPU; in the port a CUDA
    tensor launches K2 or raises, so the flag leaves the route as it is."""
    want = {("cuda", 1024): "flash", ("cuda", 4096): "flash",
            ("cuda", 1023): "plain", ("cpu", 4096): "plain",
            ("cpu", 16): "plain"}
    for bits in (0, flags.DISABLE_PALLAS_FLASH_ATTENTION):
        monkeypatch.setattr(flags, "_flags", bits)
        assert {key: TL.attention_route(*key) for key in want} == want
    layer = TL.ScaledDotProductAttention(2, 8)
    assert not layer._use_flash(torch.zeros(1, 1024, 16))


def test_loss_and_grads():
    """model.loss_and_grads, the step of fit and of the coco trainer:
    autograd's gradients in leaves() order at the parameters (left
    untouched), zeros for a leaf the loss does not reach and for an
    integer leaf, the loss and the aux tree detached."""
    rng = np.random.default_rng(7)
    params = {"b": torch.from_numpy(rng.normal(size=3)),
              "a": [torch.from_numpy(rng.normal(size=(2, 3))),
                    torch.from_numpy(rng.normal(size=4))],
              "n": torch.arange(3)}

    def loss_of(tp):
        y = tp["a"][0] @ tp["b"] * tp["n"][1]
        return (y ** 2).sum(), {"y": y, "pair": (y * 2, tp["b"])}
    loss, grads, aux = tmodel.loss_and_grads(params, loss_of)
    a0, b = params["a"][0], params["b"]
    y = a0 @ b
    assert not loss.requires_grad
    torch.testing.assert_close(loss, (y ** 2).sum(), rtol=0, atol=0)
    want = [2 * y[:, None] * b[None, :], torch.zeros(4),
            2 * a0.T @ y, torch.zeros(3, dtype=torch.int64)]
    assert [g.shape for g in grads] == [w.shape for w in want]
    for g, w in zip(grads, want):
        torch.testing.assert_close(g, w.to(g.dtype), rtol=1e-12,
                                   atol=1e-12)
    assert all(not t.requires_grad for t in topt.leaves(aux))
    torch.testing.assert_close(aux["pair"][0], 2 * y, rtol=0, atol=0)
    assert not any(p.requires_grad for p in topt.leaves(params))


def _attention_graph(F, L):
    inp = F.Input()
    h = L.LayerNorm(name="ln")(inp)
    a = L.ScaledDotProductAttention(2, 8, is_causal=True)(h)
    return F.Model([inp], [F.Add()(inp, a)], name="attention")


def test_attention_graph_fit():
    """Path B's model kind at a small size: LayerNorm, causal attention
    and a residual Add under compile(adamw, "mse"), three fits against
    ccv_tpu's (the plain route on both sides)."""
    shape = (2, 16, 16)
    jm, tm = _attention_graph(JF, JL), _attention_graph(TF, TL)
    jm.build(shape, jax.random.PRNGKey(0))
    tm.build(shape, device="cpu")
    TF.params_from_jax(jm, tm, "cpu")
    jm.compile(jopt.adamw(rate=1e-2), "mse")
    tm.compile(topt.adamw(rate=1e-2), "mse")
    rng = np.random.default_rng(11)
    for step in range(3):
        x = rng.normal(0, 1, shape).astype(np.float32)
        y = rng.normal(0, 1, shape).astype(np.float32)
        jl = jm.fit(jnp.asarray(x), jnp.asarray(y))
        tl = tm.fit(torch.from_numpy(x), torch.from_numpy(y))
        assert abs(tl - jl) <= 1e-5 * abs(jl)
    _same_models(jm, tm)


# ---------------------------------------------------------------------------
# trainer checkpoints, both ways
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["ccv_tpu", "port"])
def test_checkpoint_resume_across(writer, tmp_path):
    """Two adam fits by ``writer``, ``checkpoint``, ``resume`` into a fresh
    compiled model of the other package, then the same next fit on both:
    the same loss, parameters, states and optimizer state."""
    path = str(tmp_path / "ckpt.sqlite3")
    jm, tm = _pair("seq", "adam")
    src = jm if writer == "ccv_tpu" else tm
    for step in range(2):
        x, y = _batch(100 + step)
        if writer == "ccv_tpu":
            src.fit(jnp.asarray(x), jnp.asarray(y))
        else:
            src.fit(torch.from_numpy(x), torch.from_numpy(y))
    src.checkpoint(path)
    jm2, tm2 = _pair("seq", "adam")
    if writer == "ccv_tpu":
        tm2.resume(path)
        np.testing.assert_array_equal(tm2._step_key,
                                      np.asarray(jm._step_key))
        jm2 = jm
    else:
        jm2.resume(path)
        tm2 = tm
        assert tm2.opt_state.step == int(jm2.opt_state.step) == 2
    x, y = _batch(110)
    jl = jm2.fit(jnp.asarray(x), jnp.asarray(y))
    tl = tm2.fit(torch.from_numpy(x), torch.from_numpy(y))
    assert abs(tl - jl) <= 1e-5 * abs(jl)
    _same_models(jm2, tm2)


def test_checkpoint_resume_replays_the_step_key(tmp_path):
    """The port's own round trip: after ``resume`` the next fit of a model
    with dropout draws the masks the uninterrupted run drew."""
    path = str(tmp_path / "ckpt.sqlite3")
    x, fit = _exact_batch()

    def fresh():
        m = _dropout_model(0.3)
        m.build(tuple(x.shape), torch.Generator().manual_seed(4),
                device="cpu")
        m.compile(topt.rmsprop(rate=0.01), "mse")
        return m

    a = fresh()
    a.fit(x, fit)
    a.checkpoint(path)
    want = a.fit(x, fit)
    b = fresh()
    b.resume(path)
    assert b.fit(x, fit) == want
    for p, q in zip(topt.leaves(a.params), topt.leaves(b.params)):
        assert torch.equal(p, q)


def test_imdb_lstm_fit_steps():
    """The imdb_lstm twin's model (Embedding, LSTM, mean over time,
    Dense(2)) under adam and softmax cross-entropy: three fits on the demo
    corpus from ccv_tpu's weights, losses and parameters within 1e-5."""
    from ccv_tpu_torch.bin import imdb_lstm
    from ccv_tpu_torch.bin.bin_imdb_shared import synthetic_corpus

    xs, ys = synthetic_corpus(np.random.default_rng(0), n=24, max_len=12)
    batch, dim = 8, 16
    jm = jmodel.Sequential([
        JL.Embedding(200, dim), JL.LSTM(dim),
        JL._Stateless(lambda x: jnp.mean(x, axis=1),
                      shape_fn=lambda s: (s[0], s[2]), name="meanpool"),
        JL.Dense(2)])
    jm.build((batch, 12), jax.random.PRNGKey(0))
    jm.compile(jopt.adam(rate=1e-2), "softmax_crossentropy")
    tm = imdb_lstm.build(200, dim, batch, 12, 1e-2, torch.device("cpu"))
    tm.params = tmodel.params_from_jax(jm.params, "cpu")
    tm.opt_state = tm.opt.init(tm.params)
    for i in range(3):
        x, y = xs[i * batch:(i + 1) * batch], ys[i * batch:(i + 1) * batch]
        jl = jm.fit(jnp.asarray(x), jnp.asarray(y))
        tl = tm.fit(torch.from_numpy(x.astype(np.int64)),
                    torch.from_numpy(y.astype(np.int64)))
        assert abs(tl - jl) <= 1e-5 * abs(jl)
    _same_models(jm, tm)


@pytest.mark.parametrize("kind", ["seq", "graph"])
def test_checkpoint_resume_own_round_trip(kind, tmp_path):
    """The port's own ``checkpoint`` / ``resume`` (the graph model's rows
    are its ``write`` rows plus the optimizer's and layers' states): the
    resumed model's next fit equals the uninterrupted one's."""
    path = str(tmp_path / "ckpt.sqlite3")
    _, a = _pair(kind, "lamb")
    for step in range(2):
        a.fit(*(torch.from_numpy(t) for t in _batch(120 + step)))
    a.checkpoint(path)
    x, y = (torch.from_numpy(t) for t in _batch(130))
    want = a.fit(x, y)
    _, b = _pair(kind, "lamb")
    b.resume(path)
    assert b.opt_state.step == 2
    assert b.fit(x, y) == want
    for p, q in zip(_ordered(a), _ordered(b)):
        assert torch.equal(p, q)
