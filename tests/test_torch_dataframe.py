"""Port parity: the dataframe (nn/dataframe.py) and the csvtool CLI of
ccv_tpu_torch against ccv_tpu's on the same files and seeds, on the CPU.
The column store is host numpy in both, so rows, batches and orders must
be equal, not close."""

import os

import numpy as np
import pytest
import torch

from ccv_tpu.nn.dataframe import Dataframe as JFrame
from ccv_tpu_torch.bin import csvtool
from ccv_tpu_torch.nn.dataframe import Dataframe as TFrame

DATA = os.path.join(os.path.dirname(__file__), "data")


def _csv(tmp_path, text, name="d.csv"):
    p = os.path.join(tmp_path, name)
    with open(p, "w", newline="") as f:
        f.write(text)
    return p


def _same_batches(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert len(x) == len(y)
        for u, v in zip(x, y):
            u = u.cpu().numpy() if isinstance(u, torch.Tensor) else u
            np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("text", [
    "a,b\n1,x\n2,y\n3,z\n",                      # the vectorised passes
    "a,b\r\n1,x\r\n2,y\r\n",                     # CRLF
    'a,b\n"x,1",2\n"y",4\n',                     # quotes: the state machine
    "a,b,c\n1,2,3\n4,5\n6\n",                    # ragged rows
    "a,b\n1,2",                                  # no trailing newline
])
def test_from_csv(tmp_path, text):
    p = _csv(tmp_path, text)
    j, t = JFrame.from_csv(p), TFrame.from_csv(p)
    assert t.n == j.n and t.columns == j.columns
    for i in range(j.n):
        assert t.row(i, t.columns) == j.row(i, j.columns)


def test_numeric_and_large_file(tmp_path):
    """A file past 1 MiB (the threaded first pass) and a numeric column."""
    n = 120_000
    p = _csv(tmp_path, "a,b\n" + "\n".join(f"{i},{i * 0.5}" for i in
                                           range(n)) + "\n")
    j, t = JFrame.from_csv(p), TFrame.from_csv(p)
    assert t.n == j.n == n
    for i in (0, 7, 65_432, n - 1):
        assert t.row(i, ["a", "b"]) == j.row(i, ["a", "b"])
    np.testing.assert_array_equal(t.col("b").numeric(), j.col("b").numeric())


def _frames():
    x = np.arange(20, dtype=np.float32)
    y = (np.arange(20) * 7 % 3).astype(np.int32)
    return (JFrame.from_arrays(x=x, y=y), TFrame.from_arrays(x=x, y=y))


@pytest.mark.parametrize("seed", [0, 3])
def test_shuffle_one_hot_batch(seed):
    """``shuffle(seed)`` order, a mapped column, ``one_hot`` and ``batch``
    (with and without the remainder, on threads) equal ccv_tpu's."""
    frames = _frames()
    for df in frames:
        df.map("x2", lambda v: v * 2, ["x"])
        df.one_hot("yh", "y", 3)
        df.shuffle(seed=seed)
    j, t = frames
    _same_batches(t.batch(["x2", "yh"], 6), j.batch(["x2", "yh"], 6))
    _same_batches(t.batch(["x", "y"], 6, drop_remainder=False,
                          num_threads=3),
                  j.batch(["x", "y"], 6, drop_remainder=False))


def test_sample_truncate_combine_tuples():
    frames = _frames()
    outs = []
    for df in frames:
        df.shuffle(seed=1)
        s = df.sample(7, seed=2)
        tr = df.truncate(5)
        both = tr.combine(s)
        both.make_tuple("xy", ["x", "y"]).extract_tuple("y2", "xy", 1)
        both.copy_scalar("one", 1.0)
        both.one_squared("sq", "x", 3, fill=-1.0)
        outs.append(([both.row(i, ["x", "y2", "one", "sq"])
                      for i in range(both.n)], s.n))
    (a_rows, a_n), (b_rows, b_n) = outs
    assert a_n == b_n == 7 and len(a_rows) == len(b_rows) == 12
    for a, b in zip(a_rows, b_rows):
        assert a[:3] == b[:3]
        np.testing.assert_array_equal(a[3], b[3])


def test_random_jitter_and_read_image():
    """``read_image`` through the port's decoder and ``random_jitter`` from
    the same seed: the same pixels and the same crops."""
    paths = [os.path.join(DATA, n) for n in ("crop180.png", "crop120.png")]
    frames = [JFrame.from_array("path", paths),
              TFrame.from_array("path", paths)]
    for df in frames:
        df.read_image("img", "path")
        df.random_jitter("jit", "img", 64, brightness=0.1, contrast=0.2,
                         saturation=0.3, seed=5)
    j, t = frames
    for i in range(2):
        a, b = t.row(i, ["img", "jit"]), j.row(i, ["img", "jit"])
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_allclose(a[1], b[1], rtol=0, atol=0)


def test_iter_prefetch_cpu():
    """``iter`` copies each batch to the device asked for (here the CPU)
    as tensors of the CPU batches' bytes; without device_put it yields
    numpy, as ccv_tpu's."""
    j, t = _frames()
    t.one_hot("yh", "y", 3)
    got = list(t.iter(["x", "yh"], 8, prefetch=2, device="cpu"))
    want = list(t.batch(["x", "yh"], 8))
    assert len(got) == 2
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
            np.testing.assert_array_equal(a.numpy(), b)
    plain = list(t.iter(["x"], 8, device_put=False))
    _same_batches(plain, j.iter(["x"], 8, device_put=False))
    assert isinstance(plain[0][0], np.ndarray)


def test_iter_raises_the_producers_error():
    t = TFrame.from_arrays(x=np.arange(4, dtype=np.float32))
    t.map("bad", lambda v: 1 / 0, ["x"])
    with pytest.raises(ZeroDivisionError):
        list(t.iter(["bad"], 2, device="cpu"))


def test_csvtool(tmp_path, capsys):
    p = _csv(tmp_path, "\n".join(f"{i},{i * 3},w{i}" for i in range(9)))
    assert csvtool.main([p]) == 0
    out = capsys.readouterr().out.splitlines()
    assert "(9 rows x 3 columns)" in out[0] and "(9 rows)" in out[1]
    assert csvtool.main([]) == 2
