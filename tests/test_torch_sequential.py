"""Port parity: the CNNP model path of ccv_tpu_torch (nn/layers.py,
nn/model.py Sequential, nn/tensor_io.py, models/vgg.py) against ccv_tpu on
the same parameters (``params_from_jax``) and inputs, on the CPU.

Tolerances:
- float32 logits: within 1e-5 + 1e-5 * max|ccv_tpu| (the same float32
  arithmetic, summed in another order);
- bfloat16 logits: within 3e-2 of the largest logit magnitude (the LM
  tests' fraction): both sides round each layer's output to bf16, and XLA
  and the CPU's convolution may round a sum on either side of a boundary,
  which grows through VGG-D's 16 layers;
- checkpoints: the same bits both ways, then the logits as above.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccv_tpu.models import vgg as jvgg
from ccv_tpu.nn import layers as JL
from ccv_tpu.nn import tensor_io as jtio
from ccv_tpu.nn.model import Sequential as JSequential
from ccv_tpu_torch.bin import vgg_bench
from ccv_tpu_torch.models import vgg as tvgg
from ccv_tpu_torch.nn import layers as TL
from ccv_tpu_torch.nn import tensor_io as ttio
from ccv_tpu_torch.nn.model import Sequential as TSequential
from ccv_tpu_torch.nn.model import params_from_jax

NARROW_IN = (2, 15, 13, 3)
VGG_IN = (2, 64, 64, 3)  # five 2x pools: fc6 sees 2 x 2 x 512


def _narrow(L):
    """conv, ReLU, 3x3 max-pool "SAME" at stride 2 (uneven pads), a
    stride-2 conv, BatchNorm, a 2x2 average pool "SAME", flatten at 2 x 2
    x 16, dense."""
    return [L.Convolution(8, (3, 3), padding="SAME", name="c0"), L.ReLU(),
            L.MaxPool((3, 3), (2, 2), "SAME"),
            L.Convolution(16, (3, 3), stride=(2, 2), padding="SAME",
                          name="c1"),
            L.BatchNorm(name="bn"), L.AvgPool((2, 2), (2, 2), "SAME"),
            L.Flatten(), L.Dense(10, name="fc")]


def _randomize(tree, seed):
    """Biases, BN scales and shifts, running means and variances drawn
    from a seed (ccv_tpu initialises them to constants)."""
    rng = np.random.default_rng(seed)
    out = []
    for layer in tree:
        d = {}
        for k, v in layer.items():
            v = np.asarray(v)
            if k in ("b", "bias", "mean"):
                v = rng.normal(0, 0.5, v.shape).astype(np.float32)
            elif k in ("scale", "var"):
                v = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            d[k] = v
        out.append(d)
    return out


def _pair(layers_fn, shape, seed):
    """A ccv_tpu model and the port's, with the same parameters and
    state."""
    jm = JSequential(layers_fn(JL))
    jm.build(shape, key=jax.random.PRNGKey(seed))
    jm.params = _randomize(jm.params, seed)
    jm.state = _randomize(jm.state, seed + 1)
    tm = TSequential(layers_fn(TL))
    assert tm.build(shape, device="cpu") == jm.output_shape
    tm.set_parameters(params_from_jax(jm.params, "cpu"))
    tm.state = params_from_jax(jm.state, "cpu")
    return jm, tm


def _input(shape, seed=0):
    return np.random.default_rng(seed).normal(0, 50, shape).astype(
        np.float32)


def _close(got: torch.Tensor, want, dtype):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    tol = 3e-2 * scale if dtype == "bfloat16" else 1e-5 + 1e-5 * scale
    assert float(np.abs(got - want).max()) <= tol


@pytest.fixture(scope="module")
def narrow():
    return _pair(_narrow, NARROW_IN, 1)


@pytest.fixture(scope="module")
def vgg():
    """VGG-D with 10 classes at 64 x 64, built once for the file."""
    return _pair(lambda L: (jvgg if L is JL else tvgg).vgg_d(
        num_classes=10).layers, VGG_IN, 2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("model", ["narrow", "vgg"])
def test_logits_match_ccv_tpu(request, model, dtype):
    jm, tm = request.getfixturevalue(model)
    x = _input(NARROW_IN if model == "narrow" else VGG_IN)
    want = jm.evaluate(jnp.asarray(x, getattr(jnp, dtype)))
    got = tm.evaluate(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, dtype)


def test_shapes_and_counts_match(narrow, vgg):
    for jm, tm in (narrow, vgg):
        assert tm.output_shape == jm.output_shape
        assert tm.parameter_count() == jm.parameter_count()
        assert tm.dot() == jm.dot()
        assert not tm.parameters_isnan()
        for jp, tp in zip(jm.params, tm.parameters()):
            assert {k: tuple(v.shape) for k, v in jp.items()} == \
                {k: tuple(v.shape) for k, v in tp.items()}


def test_params_from_jax_is_a_copy(narrow):
    jm, tm = narrow
    for jp, tp in zip(jm.params, tm.params):
        for k in jp:
            assert tp[k].dtype == torch.float32
            np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
    # bfloat16 arrays keep their bits
    b = jnp.asarray([1.0, -2.5, 3e-3], jnp.bfloat16)
    got = params_from_jax([{"w": b}], "cpu")[0]["w"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(b.astype(jnp.float32)))


def test_flatten_is_h_w_c_order():
    """NHWC flattens with C fastest, as ccv_tpu's reshape, so fc6's inputs
    line up (checked at 2 x 3, above 1 x 1)."""
    x = np.arange(2 * 2 * 3 * 4, dtype=np.float32).reshape(2, 2, 3, 4)
    got, _ = TL.Flatten().apply({}, {}, torch.from_numpy(x))
    want, _ = JL.Flatten().apply({}, {}, jnp.asarray(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[0, :5].tolist() == [0, 1, 2, 3, 4]


def test_build_infers_vgg_shapes():
    """Shape inference on the meta device, as ccv_tpu's eval_shape: VGG-D
    at 224 ends at (B, 1000) with 138,357,544 parameters."""
    m = tvgg.vgg_d()
    m.layers = m.layers[:-8]  # stop before fc6: no large weights to draw
    assert m.build((1, 224, 224, 3), device="cpu") == (1, 7, 7, 512)
    full = tvgg.vgg_d()
    shapes, shape = [], (1, 224, 224, 3)
    for layer in full.layers:
        if isinstance(layer, TL.Dense):
            n = shape[-1] * layer.count + layer.count
            shape = (*shape[:-1], layer.count)
        else:
            p, _, shape = layer.init(torch.Generator(), shape)
            n = sum(v.numel() for v in p.values())
        shapes.append(n)
    assert shape == (1, 1000)
    assert sum(shapes) == 138_357_544


def test_no_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device is required"):
        params_from_jax([{"w": np.ones(3, np.float32)}])
    with pytest.raises(RuntimeError, match="CUDA device is required"):
        TSequential([TL.Dense(2)]).build((1, 3))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ccv_tpu_checkpoint_read_by_the_port(narrow, tmp_path, dtype):
    """A file ccv_tpu's write_model wrote (parameters in ``dtype``) read by
    the port's read_model gives ccv_tpu's logits."""
    jm, _ = narrow
    path = str(tmp_path / "narrow.sqlite3")
    saved = jm.params
    jm.params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, getattr(jnp, dtype)), saved)
    try:
        jtio.write_model(jm, path, "narrow")
        x = _input(NARROW_IN, 3)
        want = jm.evaluate(jnp.asarray(x))
    finally:
        jm.params = saved
    tm = TSequential(_narrow(TL))
    tm.build(NARROW_IN, device="cpu")
    ttio.read_model(tm, path, "narrow")
    assert tm.params[0]["w"].dtype == getattr(torch, dtype)
    _close(tm.evaluate(torch.from_numpy(x)), want, "float32")


def test_port_checkpoint_read_by_ccv_tpu(narrow, tmp_path):
    """A file the port wrote (Sequential.write) read by ccv_tpu's
    read_model gives the port's logits; the row names are ccv_tpu's."""
    jm0, tm = narrow
    path = str(tmp_path / "port.sqlite3")
    tm.write(path, "narrow")
    jm = JSequential(_narrow(JL))
    jm.build(NARROW_IN, key=jax.random.PRNGKey(9))
    jtio.read_model(jm, path, "narrow")
    conn = jtio.open_db(path)
    try:
        assert jtio.list_tensors(conn) == ttio.list_tensors(conn)
        assert "__narrow__/4/bn/state/var" in jtio.list_tensors(conn)
    finally:
        conn.close()
    x = _input(NARROW_IN, 4)
    _close(tm.evaluate(torch.from_numpy(x)), jm.evaluate(jnp.asarray(x)),
           "float32")


def test_bfloat16_rows_both_ways(tmp_path):
    path = str(tmp_path / "rows.sqlite3")
    vals = np.array([[1.0, -2.5, 3e-3], [65504.0, 1e-20, -0.0]], np.float32)
    conn = ttio.open_db(path)
    ttio.tensor_write(conn, "port", torch.from_numpy(vals).bfloat16())
    jtio.tensor_write(conn, "jax", np.asarray(jnp.asarray(vals,
                                                          jnp.bfloat16)))
    conn.commit()
    from_jax = ttio.tensor_read(conn, "jax")
    from_port = jtio.tensor_read(conn, "port")
    conn.close()
    assert from_jax.dtype == torch.bfloat16 and from_jax.shape == (2, 3)
    assert str(from_port.dtype) == "bfloat16"
    bits = torch.from_numpy(vals).bfloat16().view(torch.int16).numpy()
    np.testing.assert_array_equal(from_jax.view(torch.int16).numpy(), bits)
    np.testing.assert_array_equal(from_port.view(np.int16), bits)


def test_missing_rows_raise(narrow, tmp_path):
    _, tm = narrow
    path = str(tmp_path / "other.sqlite3")
    tm.write(path, "narrow")
    with pytest.raises(KeyError):
        ttio.read_model(tm, path, "not-this-model")


def test_vgg_classify_matches_ccv_tpu(vgg):
    """The center-patch protocol: crop, mean, softmax, top 5."""
    jm, tm = vgg
    img = np.random.default_rng(5).integers(0, 256, (70, 80, 3), np.uint8)
    big = np.zeros((224 + 6, 224 + 2, 3), np.uint8)
    big[:70, :80] = img
    np.testing.assert_allclose(
        tvgg.preprocess(torch.from_numpy(big)).numpy(),
        np.asarray(jvgg.preprocess(jnp.asarray(big))), atol=1e-5)
    # a VGG-D at 64 x 64 classifies the 64 x 64 corner of the patch
    x = tvgg.preprocess(torch.from_numpy(big))[None, :64, :64]
    probs = torch.softmax(tm.evaluate(x), -1)
    want = jax.nn.softmax(jm.evaluate(jnp.asarray(x.numpy())), -1)
    np.testing.assert_allclose(probs.numpy(), np.asarray(want), atol=1e-6)


def test_vgg_flops_are_bench_py_s():
    """bench.py's formula at 224: 30.94 GFLOP an image (30.9 as it
    rounds)."""
    assert round(tvgg.forward_flops() / 1e9, 2) == 30.94
    assert round(tvgg.forward_flops() / 1e9, 1) == 30.9


def test_vgg_bench_split_by_kernel_kind():
    got = vgg_bench.split({
        "sm90_xmma_fprop_implicit_gemm_bf16": 2.0,
        "void cudnn::ops::nhwcToNchwKernel conv": 0.5,
        "nvjet_tst_192x192_64x3": 1.0,
        "void at::native::direct_copy_kernel_cuda": 0.25,
        "void at::native::vectorized_elementwise_kernel relu": 0.125})
    assert got == {"conv_ms": 2.5, "gemm_ms": 1.0, "cast_ms": 0.25,
                   "other_ms": 0.125}


def test_vgg_bench_needs_a_card():
    out = subprocess.run([sys.executable, "-c",
                          "import torch; torch.cuda.is_available = lambda: "
                          "False\nfrom ccv_tpu_torch.bin import vgg_bench\n"
                          "vgg_bench.measure()"],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "CUDA device is required" in out.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["narrow", "vgg"])
def test_card_matches_cpu(request, model):
    """On the card (TF32 off) the float32 logits are the CPU's within
    1e-4 of their largest magnitude; bf16 within 3e-2."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, tm = request.getfixturevalue(model)
    card = TSequential(tm.layers)
    card.build(tm.input_shape, device="cuda")
    card.set_parameters([{k: v.cuda() for k, v in p.items()}
                         for p in tm.params])
    card.state = [{k: v.cuda() for k, v in s.items()} for s in tm.state]
    x = torch.from_numpy(_input(tm.input_shape, 6))
    for dtype, frac in ((torch.float32, 1e-4), (torch.bfloat16, 3e-2)):
        want = tm.evaluate(x.to(dtype)).float()
        got = card.evaluate(x.cuda().to(dtype)).float().cpu()
        assert float((got - want).abs().max()) <= \
            frac * float(want.abs().max())
