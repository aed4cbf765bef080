"""Port parity: the legacy convnet (ccv_tpu_torch/models/convnet.py) and
the cnnclassify CLI against ccv_tpu/models/convnet.py, on the CPU.

The reference-written files tests/data/tiny_convnet_{f32,f16}.sqlite3 (a
5x5 convolution, LRN, max-pool, a 3x3 convolution in 2 partitions, an
average pool, a full-connect layer of 10) are read by both packages and
classify tests/data/crop180.png and text_test.png (resampled to the net's
32 x 32 by INTER_AREA, 10 patches).

Tolerances:
- classify: the same top-5 ids in the same order, confidences within
  1e-5 (measured: 4e-7);
- encode and every layer's forward: within 1e-5 + 1e-5 * max|ccv_tpu|
  (float32 sums in another order);
- read and write: equal weights, biases and mean image.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccv_tpu.core import io as jio
from ccv_tpu.models import convnet as jcn
from ccv_tpu_torch.bin import cnnclassify
from ccv_tpu_torch.core import io as tio
from ccv_tpu_torch.models import convnet as tcn
from ccv_tpu_torch.nn import layers as TL
from ccv_tpu_torch.nn.model import Sequential as TSequential
from ccv_tpu_torch.nn.model import params_from_jax

DATA = os.path.join(os.path.dirname(__file__), "data")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NETS = ("f32", "f16")
IMAGES = ("crop180.png", "text_test.png")


def _net_path(kind):
    return os.path.join(DATA, f"tiny_convnet_{kind}.sqlite3")


def _close(got: torch.Tensor, want):
    """Within tolerance; -inf (a max-pool window wholly in the padding)
    where ccv_tpu has it."""
    want = np.asarray(want)
    got = got.cpu().numpy()
    assert got.shape == want.shape
    fin = np.isfinite(want)
    np.testing.assert_array_equal(got[~fin], want[~fin])
    tol = 1e-5 + 1e-5 * float(np.abs(want[fin]).max())
    assert float(np.abs(got[fin] - want[fin]).max()) <= tol


@pytest.fixture(scope="module")
def nets():
    return {k: (jcn.Convnet.read(_net_path(k)),
                tcn.Convnet.read(_net_path(k), device="cpu")) for k in NETS}


@pytest.fixture(scope="module")
def ranks(nets):
    """ccv_tpu's top 5 of each net on each image, once for the file."""
    return {(k, im): nets[k][0].classify(
        jio.read(os.path.join(DATA, im), jio.IO_RGB_COLOR).numpy(), tops=5)
        for k in NETS for im in IMAGES}


@pytest.mark.parametrize("kind", NETS)
def test_read_matches_ccv_tpu(nets, kind):
    jn, tn = nets[kind]
    assert tn.input_size == jn.input_size == (32, 32)
    np.testing.assert_array_equal(tn.mean_activity.numpy(), jn.mean_activity)
    assert [l.type for l in tn.layers] == [l.type for l in jn.layers]
    # the 3x3 convolution runs in 2 partitions (one grouped convolution)
    assert [l.partition for l in tn.layers if l.type == tcn.CONVOLUTIONAL
            ] == [1, 2]
    for a, b in zip(jn.layers, tn.layers):
        for f in ("in_rows", "in_cols", "in_channels", "in_partition",
                  "node_count", "rows", "cols", "channels", "partition",
                  "count", "strides", "border", "size", "relu"):
            assert getattr(a, f) == getattr(b, f), f
        for f in ("kappa", "alpha", "beta"):
            assert float(getattr(a, f) or 0) == float(getattr(b, f) or 0)
        assert a.out_shape(32, 32) == b.out_shape(32, 32)
        if a.w is not None:
            assert b.w.dtype == torch.float32
            np.testing.assert_array_equal(b.w.numpy(), a.w)
            np.testing.assert_array_equal(b.bias.numpy(), a.bias)


@pytest.mark.parametrize("kind", NETS)
def test_encode_matches_ccv_tpu(nets, kind):
    jn, tn = nets[kind]
    x = np.random.default_rng(1).normal(0, 50, (3, 32, 32, 3)).astype(
        np.float32)
    _close(tn.encode(x), jn.encode(x))


@pytest.mark.parametrize("kind", NETS)
@pytest.mark.parametrize("image", IMAGES)
def test_classify_matches_ccv_tpu(nets, ranks, kind, image):
    _, tn = nets[kind]
    img = tio.read(os.path.join(DATA, image), tio.IO_RGB_COLOR,
                   device="cpu").tensor
    got = tn.classify(img, tops=5)
    want = ranks[(kind, image)]
    assert [i for i, _ in got] == [i for i, _ in want]
    for (_, c), (_, w) in zip(got, want):
        assert abs(c - w) <= 1e-5, (c, w)


@pytest.mark.parametrize("case", [
    dict(type=jcn.CONVOLUTIONAL, rows=3, cols=3, channels=4, partition=2,
         count=6, strides=2, border=1),
    dict(type=jcn.CONVOLUTIONAL, rows=5, cols=5, channels=4, partition=1,
         count=3, strides=1, border=2),
    dict(type=jcn.MAX_POOL, size=3, strides=2, border=0),
    dict(type=jcn.MAX_POOL, size=2, strides=2, border=1),
    dict(type=jcn.AVERAGE_POOL, size=3, strides=2, border=0),
    dict(type=jcn.AVERAGE_POOL, size=2, strides=3, border=1),
    dict(type=jcn.LOCAL_RESPONSE_NORM, size=3, kappa=1.0, alpha=1e-2,
         beta=0.75, in_partition=2),
    dict(type=jcn.FULL_CONNECT, count=5, relu=1, node_count=9 * 11 * 4),
], ids=["conv-partitioned", "conv", "max-overhang", "max-border",
        "avg-overhang", "avg-border", "lrn-partitioned", "full-connect"])
def test_layer_forward_matches_ccv_tpu(case):
    """Each layer type on a 9 x 11 x 4 batch: grouped convolutions, pools
    whose windows overhang the bottom/right edge (ceiled output sizes),
    LRN per partition."""
    rng = np.random.default_rng(2)
    spec = dict(in_rows=9, in_cols=11, in_channels=4, in_partition=1,
                node_count=0)
    spec.update(case)
    lay = jcn.ConvnetLayer(**spec)
    if lay.type == jcn.CONVOLUTIONAL:
        lay.w = rng.normal(0, 0.3, (lay.count, lay.rows, lay.cols,
                                    lay.channels // lay.partition)
                           ).astype(np.float32)
        lay.bias = rng.normal(0, 0.3, lay.count).astype(np.float32)
    elif lay.type == jcn.FULL_CONNECT:
        lay.w = rng.normal(0, 0.1, (lay.count, lay.node_count)).astype(
            np.float32)
        lay.bias = rng.normal(0, 0.3, lay.count).astype(np.float32)
    x = rng.normal(0, 2, (2, 9, 11, 4)).astype(np.float32)
    want = np.asarray(jcn._layer_forward(lay, jnp.asarray(x)))
    tlay = tcn.ConvnetLayer(**spec)
    if lay.w is not None:
        tlay.w, tlay.bias = torch.from_numpy(lay.w), torch.from_numpy(lay.bias)
    got = tcn._layer_forward(tlay, torch.from_numpy(x))
    if lay.type in (jcn.MAX_POOL, jcn.AVERAGE_POOL):
        assert got.shape[1:3] == lay.out_shape(9, 11)
    _close(got, want)


@pytest.mark.parametrize("kind", NETS)
@pytest.mark.parametrize("half", [False, True])
def test_write_is_read_by_ccv_tpu(nets, tmp_path, kind, half):
    jn, tn = nets[kind]
    path = str(tmp_path / "net.sqlite3")
    tn.write(path, half_precision=half)
    back = jcn.Convnet.read(path)
    np.testing.assert_array_equal(back.mean_activity,
                                  tn.mean_activity.numpy())
    for a, b in zip(tn.layers, back.layers):
        assert a.type == b.type and a.partition == b.partition
        if a.w is not None:
            want = a.w.numpy().astype(np.float16 if half else np.float32)
            np.testing.assert_array_equal(b.w, want.astype(np.float32))
    if not half:  # and ccv_tpu's writer gives the same file content
        jpath = str(tmp_path / "jax.sqlite3")
        jn.write(jpath)
        again = tcn.Convnet.read(jpath, device="cpu")
        for a, b in zip(again.layers, tn.layers):
            if a.w is not None:
                assert torch.equal(a.w, b.w) and torch.equal(a.bias, b.bias)


def test_local_response_norm_matches_ccv_tpu():
    x = np.random.default_rng(3).normal(0, 10, (2, 5, 6, 16)).astype(
        np.float32)
    want, _ = jcn.LocalResponseNorm().apply({}, {}, jnp.asarray(x))
    got, _ = tcn.LocalResponseNorm().apply({}, {}, torch.from_numpy(x))
    _close(got, want)


@pytest.fixture(scope="module")
def matt():
    """matt_net with 10 classes at 99 x 99 (fc6 sees 2 x 2 x 256), on
    ccv_tpu's parameters with random biases."""
    jm = jcn.matt_net(num_classes=10)
    jm.build((1, 99, 99, 3), key=jax.random.PRNGKey(4))
    rng = np.random.default_rng(4)
    jm.params = [{k: (rng.normal(0, 0.1, np.shape(v)).astype(np.float32)
                      if k == "b" else np.asarray(v)) for k, v in p.items()}
                 for p in jm.params]
    tm = tcn.matt_net(num_classes=10)
    assert tm.build((1, 99, 99, 3), device="cpu") == jm.output_shape
    tm.set_parameters(params_from_jax(jm.params, "cpu"))
    return jm, tm


def test_matt_net_forward_matches_ccv_tpu(matt):
    jm, tm = matt
    x = np.random.default_rng(5).normal(0, 50, (2, 99, 99, 3)).astype(
        np.float32)
    _close(tm.evaluate(torch.from_numpy(x)), jm.evaluate(jnp.asarray(x)))


def test_ten_patch_classify_matches_ccv_tpu(matt):
    jm, tm = matt
    img = np.random.default_rng(6).integers(0, 256, (120, 110, 3), np.uint8)
    np.testing.assert_array_equal(
        tcn.ten_patches(torch.from_numpy(img), 99).numpy(),
        np.asarray(jcn.ten_patches(jnp.asarray(img), 99)))
    idx, probs = tcn.classify(tm, torch.from_numpy(img), top=5, patch=99)
    jidx, jprobs = jcn.classify(jm, jnp.asarray(img), top=5, patch=99)
    assert idx.tolist() == np.asarray(jidx).tolist()
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), atol=1e-6)


def _cli_ids(stdout: str):
    parts = stdout.strip().split(" | ")
    assert parts[-1].endswith("ms")
    return [(int(p.split()[0]) - 1, float(p.split()[1])) for p in parts[:-1]]


@pytest.mark.parametrize("kind", NETS)
def test_cnnclassify_cli(ranks, kind):
    """python -m ccv_tpu_torch.bin.cnnclassify <image> <model> --device
    cpu prints ccv_tpu's top 5 as "<id + 1> <confidence>"."""
    out = subprocess.run(
        [sys.executable, "-m", "ccv_tpu_torch.bin.cnnclassify",
         os.path.join(DATA, "text_test.png"), _net_path(kind),
         "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr
    got = _cli_ids(out.stdout)
    want = ranks[(kind, "text_test.png")]
    assert [i for i, _ in got] == [i for i, _ in want]
    for (_, c), (_, w) in zip(got, want):
        assert abs(c - w) <= 1e-5 + 5e-7  # printed to 6 decimals


def test_cnnclassify_in_process(ranks, capsys):
    assert cnnclassify.main([os.path.join(DATA, "crop180.png"),
                             _net_path("f32"), "--device", "cpu"]) == 0
    got = _cli_ids(capsys.readouterr().out)
    assert [i for i, _ in got] == [i for i, _ in ranks[("f32",
                                                        "crop180.png")]]


def test_cnnclassify_refuses_a_model_that_does_not_load(tmp_path):
    """A tensors-schema file without VGG-D's rows raises (no random
    weights); the convnet schema is told apart by its tables."""
    path = str(tmp_path / "other.sqlite3")
    m = TSequential([TL.Dense(3, name="fc")], name="vgg-d")
    m.build((1, 4), device="cpu")
    m.write(path)
    assert not tcn.is_convnet_file(path)
    assert tcn.is_convnet_file(_net_path("f32"))
    with pytest.raises(KeyError, match="conv0"):
        cnnclassify.classify(os.path.join(DATA, "crop180.png"), path, "cpu")


def test_cnnclassify_needs_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device is required"):
        cnnclassify.classify(os.path.join(DATA, "crop180.png"),
                             _net_path("f32"))
    with pytest.raises(RuntimeError, match="CUDA device is required"):
        tcn.Convnet.read(_net_path("f32"))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", NETS)
def test_card_matches_cpu(nets, kind):
    """On the card (TF32 off): the CPU's top 5 ids, confidences within
    1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, tn = nets[kind]
    card = tcn.Convnet.read(_net_path(kind), device="cuda")
    for image in IMAGES:
        img = tio.read(os.path.join(DATA, image), tio.IO_RGB_COLOR,
                       device="cpu").tensor
        want = tn.classify(img, tops=5)
        got = card.classify(img.cuda(), tops=5)
        assert [i for i, _ in got] == [i for i, _ in want]
        assert max(abs(c - w) for (_, c), (_, w) in zip(got, want)) <= 1e-5
