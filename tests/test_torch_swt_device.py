"""Port parity: SWT's device letter route (ccv_tpu_torch/detectors/swt.py
``_letters_device``, ``detect_words(letters="device")``) on the CPU.

- the letter rows and counts of a seeded 2 x 48 x 64 stroke map (with
  components of equal size) equal ccv_tpu's ``_letters_device``: as sets
  of rows (the port orders them by first pixel, ccv_tpu by size), every
  integer column exactly (ccv_tpu sums in float32, the port in int64 and
  divides in float64: means within 1e-6 relative, variances within 8
  float32 roundings of E[v^2]);
- the rows give exactly the host route's letter dicts
  (``_letters_from_components`` over the native components), on
  text_test.png and a 2 x 2 tiling of it;
- ``detect_words(letters="device")`` equals the compact route's words on
  text_test.png and on a scale-invariant crop;
- more kept letters than ``_KEPT_CAP`` (the cap lowered for the test)
  counts one overflow and still returns the compact route's words;
- on the card (marked cuda), the rows equal the CPU's exactly.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ccv_tpu.detectors import swt as jswt
from ccv_tpu_torch.core import native
from ccv_tpu_torch.core.io import IO_GRAY, read
from ccv_tpu_torch.detectors import swt

DATA = os.path.join(os.path.dirname(__file__), "data")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def text():
    return read(os.path.join(DATA, "text_test.png"), IO_GRAY,
                device="cpu").tensor


def stroke_map(seed, H=48, W=64):
    rng = np.random.default_rng(seed)
    m = np.zeros((2, H, W), np.uint8)
    for d in range(2):
        for _ in range(14):
            h, w = rng.integers(8, 16), rng.integers(4, 12)
            y, x = rng.integers(0, H - h), rng.integers(0, W - w)
            m[d, y:y + h, x:x + w] = rng.integers(2, 6)
    # two apart components of one size in each polarity: ties in size
    m[:, 1:11, 1:5] = 3
    m[:, 36:46, 58:62] = 3
    return m, rng.integers(0, 256, (H, W), dtype=np.uint8)


def _sorted_rows(rows):
    return rows[np.lexsort((rows[:, 3], rows[:, 2], rows[:, 1]))]


@pytest.mark.parametrize("seed", [3, 11])
def test_rows_equal_ccv_tpu(seed):
    m, g = stroke_map(seed)
    p = swt.SwtParams(min_area=20)
    jrows, jcounts = jswt._letters_device(
        jnp.asarray(m.astype(np.int32)), jnp.asarray(g), P=16384,
        min_height=p.min_height, max_height=p.max_height,
        min_area=p.min_area, aspect_ratio=p.aspect_ratio,
        std_ratio=p.std_ratio)
    jrows = np.asarray(jrows).astype(np.float64)
    rows, counts = swt._letters_device(torch.from_numpy(m),
                                       torch.from_numpy(g), p)
    assert counts == tuple(int(c) for c in np.asarray(jcounts))
    n = counts[1]
    assert 2 < n < swt._LETTER_CAP and counts[2] > 1
    assert not jrows[n:, 0].any() and not rows[n:].any()
    got, want = _sorted_rows(rows[:n]), _sorted_rows(jrows[:n])
    exact = [0, 1, 2, 3, 4, 5, 6, 7, 10, 11, 12]
    np.testing.assert_array_equal(got[:, exact], want[:, exact])
    np.testing.assert_allclose(got[:, 8], want[:, 8], rtol=1e-6)
    # ccv_tpu's variance is E[v^2] - mean^2 in float32: hold the variances
    # to a few float32 roundings of E[v^2]
    var, jvar = got[:, 9] ** 2, want[:, 9] ** 2
    assert np.all(np.abs(var - jvar) <= 8 * 2.0 ** -24
                  * (got[:, 8] ** 2 + var))
    # the port's rows come polarity 0 first, each in first-pixel order
    assert list(rows[:n, 1]) == sorted(rows[:n, 1])


def _both_routes(img):
    p = swt.SwtParams()
    c, dx, dy, gray = swt._frontend(img, 3, 124, 204)
    maps = swt._rays(c, dx, dy)
    rows, counts = swt._letters_device(maps, gray, p)
    m, g = maps.cpu().numpy(), gray.cpu().numpy()
    host = [swt._letters_from_components(g, m[d], native.swt_cc(m[d]), p)
            for d in range(2)]
    return swt._device_letters(rows, p), host, counts, rows


def test_letters_equal_the_host_route(text):
    dev, host, counts, _ = _both_routes(text)
    assert counts[2] <= swt._KEPT_CAP and sum(map(len, host)) > 40
    assert dev == host


def test_letters_equal_the_host_route_tiled(text):
    tiled = torch.from_numpy(np.ascontiguousarray(
        np.tile(text.numpy(), (2, 2))[:600, :900]))
    dev, host, counts, _ = _both_routes(tiled)
    assert dev == host and counts[1] > 100


def test_words_equal_compact(text):
    timings = {}
    want = swt.detect_words(text)
    got = swt.detect_words(text, letters="device", timings=timings)
    assert [(w.x, w.y, w.width, w.height) for w in got] == \
        [(w.x, w.y, w.width, w.height) for w in want] and got
    assert set(timings) == {"frontend", "rays", "device_letters", "letters"}
    fut = swt.detect_words_async(text, letters="device")
    assert swt.detect_words_collect(fut) == got


def test_words_equal_compact_scale_invariant(text):
    crop = text[40:360, 0:320].contiguous()
    p = swt.SwtParams(scale_invariant=True)
    assert swt.detect_words(crop, p, letters="device") == \
        swt.detect_words(crop, p)


def test_kept_cap_overflow_falls_back(text, monkeypatch):
    monkeypatch.setattr(swt, "_KEPT_CAP", 8)
    before = swt.LETTER_OVERFLOWS
    timings = {}
    got = swt.detect_words(text, letters="device", timings=timings)
    assert swt.LETTER_OVERFLOWS == before + 1
    assert timings["letter_overflows"] == 1 and "cc" in timings
    assert got == swt.detect_words(text)


def test_unknown_route_raises(text):
    with pytest.raises(ValueError, match="letters"):
        swt.detect_words(text, letters="host")


@pytest.mark.cuda
def test_card_rows_equal_cpu(text):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, _, counts, rows = _both_routes(text)
    _, _, counts_d, rows_d = _both_routes(text.cuda())
    assert counts_d == counts
    np.testing.assert_array_equal(rows_d, rows)


def test_swtdetect_letters_flag(capsys):
    from ccv_tpu_torch.bin import swtdetect
    path = os.path.join(DATA, "text_test.png")
    out = []
    for route in ("compact", "device"):
        assert swtdetect.main([path, "--device", "cpu", "--letters",
                               route]) == 0
        out.append(capsys.readouterr().out.splitlines())
    assert out[0][:-1] == out[1][:-1] and len(out[0]) > 1
    assert out[1][-1].startswith(f"total : {len(out[0]) - 1} in time ")
