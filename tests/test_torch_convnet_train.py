"""Port parity: the legacy convnet's trainer (``models.convnet.
supervised_train``, ccv_convnet_supervised_train) and its CLIs
(``bin/cifar_10``, ``bin/image_net``, ``bin/cnnvldtr``) against ccv_tpu's
and bin/'s on the same seeded data, on the CPU.

Gates: one step's weights within 1e-5 of each leaf's largest magnitude
(float32); two epochs of tests/test_convnet_train.py's tiny net with random
flips: each epoch's loss within 1e-4 (relative, floor 1) and the same
accuracies; the nets' drawn weights equal bin/'s to the bit; the CLIs'
printed histories within the same tolerance (and one unit of the printed
last digit); cnnvldtr's line equal.
"""

import contextlib
import dataclasses
import importlib.util
import io
import os
import re
import sys

import numpy as np
import pytest
import torch

from ccv_tpu.models import convnet as jconvnet
from ccv_tpu_torch.bin import cifar_10, cnnvldtr, image_net
from ccv_tpu_torch.models import convnet

import test_convnet_train as jtrain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _bin(name):
    """A bin/ reference script as a module (its file names have hyphens)."""
    spec = importlib.util.spec_from_file_location(
        name.replace("-", "_") + "_ref", os.path.join(REPO, "bin",
                                                      name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port_net(jnet, dtype=torch.float32):
    layers = []
    for lay in jnet.layers:
        fields = {f.name: getattr(lay, f.name)
                  for f in dataclasses.fields(lay)}
        if lay.w is not None:
            fields["w"] = torch.from_numpy(np.asarray(lay.w)).to(dtype)
            fields["bias"] = torch.from_numpy(np.asarray(lay.bias)).to(dtype)
        layers.append(convnet.ConvnetLayer(**fields))
    mean = (None if jnet.mean_activity is None
            else np.asarray(jnet.mean_activity))
    return convnet.Convnet(layers, jnet.input_size, mean, device="cpu")


def _leaves(net):
    return [np.asarray(l.w.cpu() if torch.is_tensor(l.w) else l.w)
            for l in net.layers if l.w is not None] + \
        [np.asarray(l.bias.cpu() if torch.is_tensor(l.bias) else l.bias)
         for l in net.layers if l.w is not None]


def _close(a, b, tol=1e-4):
    return abs(a - b) <= tol * max(1.0, abs(b))


@pytest.mark.parametrize("net_name", ["tiny", "matt_c"])
def test_one_step_matches_ccv_tpu(net_name):
    """One mini-batch step (one epoch of one batch) from the same layers
    and batch: every leaf within 1e-5 of its largest magnitude. MattNet-C
    at the self-test's size: grouped convolutions, LRN over partitions and
    pools whose windows overhang the edge."""
    rng = np.random.default_rng(5)
    if net_name == "tiny":
        jnet = jtrain._tiny_net()
        x, y = jtrain._dataset(16, rng)
        mean = rng.normal(100, 20, (16, 16, 1)).astype(np.float32)
        jnet.mean_activity = mean
    else:
        jnet = _bin("image-net").matt_c_net(num_classes=4, scale=0.08,
                                            input_size=33, seed=0)
        x = rng.integers(0, 255, (16, 33, 33, 3)).astype(np.uint8)
        y = rng.integers(0, 4, 16)
    net = _port_net(jnet)
    params = dict(max_epoch=1, mini_batch=16, learn_rate=0.01,
                  momentum=0.9, decay=5e-4, symmetric=True)
    jh = jconvnet.supervised_train(jnet, x, y,
                                   jconvnet.ConvnetTrainParams(**params))
    th = convnet.supervised_train(net, x, y,
                                  convnet.ConvnetTrainParams(**params))
    assert _close(th[0][0], jh[0][0], 1e-5)
    for got, want in zip(_leaves(net), _leaves(jnet)):
        assert got.shape == want.shape
        if want.size:  # MattNet-C's first full-connect layer takes 0 inputs
            assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.fixture(scope="module")
def two_epochs(tmp_path_factory):
    """tests/test_convnet_train.py's net and data, 2 epochs with flips, in
    both packages, each writing its working file."""
    tmp = tmp_path_factory.mktemp("train")
    rng = np.random.default_rng(1)
    xtr, ytr = jtrain._dataset(240, rng)
    xte, yte = jtrain._dataset(60, rng)
    params = dict(max_epoch=2, mini_batch=32, learn_rate=5e-4, momentum=0.9,
                  decay=1e-4, symmetric=True)
    jnet = jtrain._tiny_net()
    net = _port_net(jnet)
    jh = jconvnet.supervised_train(
        jnet, xtr, ytr, jconvnet.ConvnetTrainParams(**params),
        filename=str(tmp / "jax.sqlite3"), tests=(xte, yte))
    th = convnet.supervised_train(
        net, xtr, ytr, convnet.ConvnetTrainParams(**params),
        filename=str(tmp / "port.sqlite3"), tests=(xte, yte))
    return jh, th, jnet, net, tmp, (xte, yte)


def test_two_epochs_match_ccv_tpu(two_epochs):
    jh, th, _jnet, _net, _tmp, _t = two_epochs
    assert len(th) == len(jh) == 2
    for (tl, ta), (jl, ja) in zip(th, jh):
        assert _close(tl, jl)
        assert ta == ja
    assert th[1][0] < th[0][0]


def test_working_file_reads_back_in_both_packages(two_epochs):
    _jh, _th, jnet, net, tmp, (xte, yte) = two_epochs
    back = convnet.Convnet.read(str(tmp / "port.sqlite3"), device="cpu")
    jback = jconvnet.Convnet.read(str(tmp / "port.sqlite3"))
    for a, b, c in zip(_leaves(back), _leaves(jback), _leaves(net)):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(np.asarray(b), c)
    # ccv_tpu's file in the port, and the nets agree on the test set
    jfile = convnet.Convnet.read(str(tmp / "jax.sqlite3"), device="cpu")
    for a, b in zip(_leaves(jfile), _leaves(jnet)):
        np.testing.assert_array_equal(a, np.asarray(b))
    got = back.encode(xte.astype(np.float32)).argmax(-1).numpy()
    want = np.asarray(jback.encode(xte.astype(np.float32))).argmax(-1)
    np.testing.assert_array_equal(got, want)
    assert (got == yte).mean() == two_epochs[1][-1][1]


@pytest.mark.parametrize("kw", [dict(num_classes=4, scale=0.08,
                                     input_size=33),
                                dict(num_classes=10, scale=0.25,
                                     input_size=97, seed=3)])
def test_matt_c_net_draws_equal_bin_s(kw):
    want = _bin("image-net").matt_c_net(**kw)
    got = image_net.matt_c_net(device="cpu", **kw)
    assert len(got.layers) == len(want.layers) == 16
    for g, w in zip(got.layers, want.layers):
        for f in dataclasses.fields(w):
            if f.name not in ("w", "bias"):
                assert getattr(g, f.name) == getattr(w, f.name), f.name
    for g, w in zip(_leaves(got), _leaves(want)):
        np.testing.assert_array_equal(g, w)
    assert got.input_size == want.input_size


def test_cifar10_net_draws_equal_bin_s():
    want = _bin("cifar-10").cifar10_net(seed=4)
    got = cifar_10.cifar10_net(seed=4, device="cpu")
    for g, w in zip(_leaves(got), _leaves(want)):
        np.testing.assert_array_equal(g, w)
    assert [l.type for l in got.layers] == [l.type for l in want.layers]


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue().splitlines()


def _numbers(lines):
    return [[float(v) for v in re.findall(r"-?\d+(?:\.\d+)?", ln)]
            for ln in lines]


def test_cifar_10_cli_matches_bin_s(tmp_path, monkeypatch):
    """bin/cifar-10.py's synthetic data (its self-test's draws) as npz
    files, 2 epochs at the published settings, through both CLIs."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (256, 31, 31, 3), dtype=np.uint8)
    y = (x.mean(axis=(1, 2, 3)) > 127.5).astype(np.int32)
    np.savez(tmp_path / "train.npz", x=x, y=y)
    np.savez(tmp_path / "test.npz", x=x[:64], y=y[:64])
    args = [str(tmp_path / "train.npz"), str(tmp_path / "test.npz")]
    ref = _bin("cifar-10")
    monkeypatch.setattr(sys, "argv", ["cifar-10.py"] + args
                        + [str(tmp_path / "ref.sqlite3"), "2"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ref.main()
    want = out.getvalue().splitlines()
    rc, got = _run(cifar_10.main, args + [str(tmp_path / "port.sqlite3"),
                                          "2", "--device", "cpu"])
    assert rc == 0 and len(got) == len(want) == 2
    for g, w in zip(_numbers(got), _numbers(want)):
        assert _close(g[1], w[1], 1e-4) or abs(g[1] - w[1]) <= 1e-4
        assert g[0] == w[0] and g[2] == w[2]
    # the self-test mode writes its net to the temporary directory
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    rc, lines = _run(cifar_10.main, ["--device", "cpu"])
    assert rc == 0 and lines[0] == "(no dataset given: synthetic self-test)"
    assert _numbers(lines[1:]) == _numbers(got)
    assert convnet.is_convnet_file(str(tmp_path
                                       / "cifar10_selftest.sqlite3"))


def test_image_net_self_test_matches_bin_s(monkeypatch):
    ref = _bin("image-net")
    monkeypatch.setattr(sys, "argv", ["image-net.py", "--self-test"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ref.main()
    want = out.getvalue().splitlines()
    rc, got = _run(image_net.main, ["--self-test", "--device", "cpu"])
    assert rc == 0 and len(got) == len(want) == 1
    g, w = _numbers(got)[0], _numbers(want)[0]
    assert len(g) == len(w) == 3
    assert all(abs(a - b) <= 1.001e-3 for a, b in zip(g, w))
    assert _numbers(got) != [[]] and got[0].startswith("self-test losses: [")


def test_image_net_load_list_matches_bin_s(tmp_path):
    """The list reader: RGB, INTER_AREA to the net's size in float32,
    clipped to uint8; ccv_tpu's resample sums in another order, so a pixel
    may land one off."""
    lst = tmp_path / "list.txt"
    lst.write_text(f"3 {os.path.join(DATA, 'crop180.png')}\n\n"
                   f"1 {os.path.join(DATA, 'crop120.png')}\n")
    want_x, want_y = _bin("image-net")._load_list(str(lst), 45)
    got_x, got_y = image_net._load_list(str(lst), 45, device="cpu")
    assert got_x.dtype == np.uint8 and got_x.shape == (2, 45, 45, 3)
    np.testing.assert_array_equal(got_y, want_y)
    diff = np.abs(got_x.astype(int) - np.asarray(want_x).astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01


def test_cnnvldtr_prints_bin_s_line(tmp_path, monkeypatch):
    rng = np.random.default_rng(6)
    truth = rng.integers(0, 10, 50)
    (tmp_path / "truth.txt").write_text(
        "".join(f"{t}\n" for t in truth))
    lines = []
    for t in truth:
        ids = rng.permutation(10)[:5]
        if rng.random() < 0.3:
            ids[0] = t
        lines.append(" ".join(f"{i} {rng.random():.4f}" for i in ids))
    (tmp_path / "result.txt").write_text("\n".join(lines)
                                         + "\nelapsed 12.0\n")
    argv = [str(tmp_path / "truth.txt"), str(tmp_path / "result.txt")]
    ref = _bin("cnnvldtr")
    monkeypatch.setattr(sys, "argv", ["cnnvldtr.py"] + argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ref.main()
    rc, got = _run(cnnvldtr.main, argv)
    assert rc == 0 and got == out.getvalue().splitlines()
    assert re.fullmatch(r"\d+\.?\d*% \(1\), \d+\.?\d*% \(5\)", got[0])
    assert cnnvldtr.main(argv[:1]) == 2
