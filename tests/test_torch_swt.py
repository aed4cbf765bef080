"""Port parity: SWT text detection (ccv_tpu_torch/detectors/swt.py) on the
CPU, against ccv_tpu on the same inputs and against the C golden.

- text_test.png's words: against tests/data/text_test.swt.txt by
  tests/test_swt.py's rule (the same count, each golden word matched at
  IoU >= 0.7), and equal to ccv_tpu's words;
- swt_map: equal to ccv_tpu's, both polarities (integer arithmetic);
- the native components (csrc/swt_cc.cpp): the same partition as the
  scipy plain version on seeded maps;
- scale_invariant: equal to ccv_tpu's words on a 320 x 320 crop (two
  pyramid levels).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccv_tpu.core.io import IO_GRAY, read
from ccv_tpu.detectors import swt as jswt
from ccv_tpu.ops import basic as jbasic
from ccv_tpu.ops import classic as jclassic
from ccv_tpu_torch.core import native
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
    return np.array(read(os.path.join(DATA, "text_test.png"), IO_GRAY).array)


def _iou(a, b):
    ix = max(0, min(a[0] + a[2], b[0] + b[2]) - max(a[0], b[0]))
    iy = max(0, min(a[1] + a[3], b[1] + b[3]) - max(a[1], b[1]))
    inter = ix * iy
    union = a[2] * a[3] + b[2] * b[3] - inter
    return inter / union if union else 0.0


def _rects(words):
    return sorted((int(w.x), int(w.y), int(w.width), int(w.height))
                  for w in words)


@pytest.fixture(scope="module")
def words(text):
    timings = {}
    out = swt.detect_words(torch.from_numpy(text), timings=timings)
    return out, timings


def test_words_match_the_c_golden(words):
    with open(os.path.join(DATA, "text_test.swt.txt")) as f:
        ref = [tuple(int(v) for v in line.split()) for line in f]
    mine = _rects(words[0])
    assert len(mine) == len(ref), (mine, ref)
    for r in ref:
        best = max(_iou(r, m) for m in mine)
        assert best >= 0.7, f"golden word {r} unmatched ({best:.2f}): {mine}"


def test_words_equal_ccv_tpu(words, text):
    assert _rects(words[0]) == _rects(jswt.detect_words(text))


def test_timings_cover_the_stages(words):
    assert set(words[1]) == {"frontend", "rays", "fetch", "cc", "letters"}
    assert all(v >= 0 for v in words[1].values())


BAND = (slice(96, 200), slice(32, 544))  # the first line of text


@pytest.fixture(scope="module")
def edges(text):
    """ccv_tpu's front end on the first text line: closed edges, sobels."""
    band = jnp.asarray(text[BAND])
    c = jclassic.close_outline(jclassic.canny(band, 3, 124, 204))
    return c, jbasic.sobel(band, 3, 0), jbasic.sobel(band, 0, 3)


@pytest.fixture(scope="module")
def jax_maps(edges):
    """ccv_tpu's swt_map of both polarities, from one run of the rays
    program it calls."""
    c, dx, dy = edges
    both, _ = jswt._swt_rays_both(c, dx, dy, jswt._ray_lanes(c.size))
    return {1: np.asarray(both[0]).astype(np.int32),
            -1: np.asarray(both[1]).astype(np.int32)}


@pytest.mark.parametrize("direction", [1, -1])
def test_swt_map_equals_ccv_tpu(edges, jax_maps, direction):
    want = jax_maps[direction]
    got = swt.swt_map(*(torch.from_numpy(np.array(v)) for v in edges),
                      direction).numpy()
    assert got.dtype == want.dtype == np.int32
    assert (want > 0).sum() > 2000
    np.testing.assert_array_equal(got, want)


def test_frontend_equals_ccv_tpu(text, edges):
    band = np.ascontiguousarray(text[BAND])
    c, dx, dy, gray = swt._frontend(torch.from_numpy(band), 3, 124, 204)
    for got, want in zip((c, dx, dy), edges):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(gray.numpy(), band)


def test_no_edges_no_strokes():
    flat = torch.full((40, 50), 7, dtype=torch.uint8)
    c, dx, dy, _ = swt._frontend(flat, 3, 124, 204)
    assert int(c.sum()) == 0
    assert int(swt._rays(c, dx, dy).sum()) == 0
    assert swt.detect_words(flat) == []


def _partition(labels):
    """Canonical labels: components numbered by first pixel in scan order."""
    flat = labels.reshape(-1)
    out = np.full_like(flat, -1)
    seen = {}
    for i, v in enumerate(flat.tolist()):
        if v >= 0:
            out[i] = seen.setdefault(v, len(seen))
    return out.reshape(labels.shape)


@pytest.mark.parametrize("seed,ratio", [(0, 3), (1, 3), (2, 2), (3, 1)])
def test_native_components_equal_the_plain_version(seed, ratio):
    rng = np.random.default_rng(seed)
    m = (rng.integers(1, 12, (60, 70)) * (rng.random((60, 70)) < 0.45)
         ).astype(np.uint8)
    got = native.swt_cc(m, ratio)
    want = swt.cc_plain(m, ratio)
    np.testing.assert_array_equal(got < 0, m == 0)
    assert got.max() > 10
    np.testing.assert_array_equal(_partition(got), _partition(want))
    # the native ids already number components in scan order
    np.testing.assert_array_equal(got, _partition(got))


def test_native_components_refuse_bad_arguments():
    with pytest.raises(ValueError):
        native.swt_cc(np.zeros((4, 4), np.uint8), 0)
    with pytest.raises(ValueError):
        native.swt_cc(np.zeros((4, 4, 2), np.uint8))


def test_scale_invariant_equals_ccv_tpu(text):
    crop = np.ascontiguousarray(text[80:400, 40:360])
    params = dict(scale_invariant=True)
    want = jswt.detect_words(crop, jswt.SwtParams(**params))
    got = swt.detect_words(torch.from_numpy(crop), swt.SwtParams(**params))
    assert len(want) > 0
    assert [(w.x, w.y, w.width, w.height, w.neighbors) for w in got] == \
        [(w.x, w.y, w.width, w.height, w.neighbors) for w in want]


def test_async_collect_equals_detect(words, text):
    fut = swt.detect_words_async(torch.from_numpy(text))
    assert _rects(swt.detect_words_collect(fut)) == _rects(words[0])


def test_needs_a_card_unless_asked(text, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device is required"):
        swt.detect_words(text)
