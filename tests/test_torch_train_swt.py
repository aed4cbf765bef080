"""Port parity: the SWT parameter search (ccv_tpu_torch/train/swt.py), on
the CPU (the swtcreate / swtvldtr CLIs: tests/test_torch_train_tools.py).

``evaluate_wolf`` is plain arithmetic in both packages and must give
ccv_tpu's precision and recall exactly, on hand-made cases and on the words
of text_test.png. One ccv_tpu search (one range of ``min_height`` from a
bad start, two iterations, on a crop of text_test.png with one annotated
line) gives the SwtParams the port's ``optimize_params`` must pick, and
the words ccv_tpu's detector found at each step, which the port's must
equal. ccv_tpu's SWT compiles anew at every ``detect_words`` call (seconds
here), so the file makes that one search.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from ccv_tpu.detectors import swt as jswt
from ccv_tpu.train import swt as J
from ccv_tpu_torch.core.io import read
from ccv_tpu_torch.detectors import swt as tswt
from ccv_tpu_torch.train import swt as T

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
CROP = (80, 170, 30, 460)               # rows, then columns, of text_test.png
BAD = 60                                # a min_height that finds nothing

CASES = [
    ([(11, 11, 49, 19)], [(10, 10, 50, 20)]),                 # one to one
    ([(10, 10, 48, 20), (60, 10, 50, 20)], [(10, 10, 100, 20)]),
    ([(200, 200, 10, 10)], [(10, 10, 50, 20)]),               # a miss
    ([(0, 0, 100, 20)], [(0, 0, 45, 20), (50, 0, 50, 20)]),   # one to many
    ([(0, 0, 100, 20)], [(0, 0, 45, 20), (50, 0, 50, 20), (0, 40, 9, 9)]),
    ([(5, 5, 30, 30), (6, 6, 30, 30)], [(5, 5, 30, 30)]),
    ([(0, 0, 10, 10), (30, 0, 10, 10), (60, 0, 10, 10)],
     [(0, 0, 70, 10)]),
    ([], [(0, 0, 1, 1)]), ([(0, 0, 1, 1)], []),
]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this file runs: the port's many small CPU
    ops crawl when the test workers' thread pools contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rects(words):
    return [(w.x, w.y, w.width, w.height) for w in words]


@pytest.mark.parametrize("words,truth", CASES)
def test_evaluate_wolf_equals_ccv_tpu(words, truth):
    got = T.evaluate_wolf(words, truth)
    assert got == J.evaluate_wolf(words, truth)
    assert all(isinstance(v, float) for v in got)


def test_evaluate_wolf_on_text_test():
    img = read(os.path.join(DATA, "text_test.png"), device="cpu").tensor
    with open(os.path.join(DATA, "text_test.swt.txt")) as f:
        truth = [tuple(map(int, line.split())) for line in f if line.strip()]
    words = tswt.detect_words(img, device="cpu")
    assert len(words) >= 2
    got = T.evaluate_wolf(words, truth)
    assert got == J.evaluate_wolf(words, truth) == (2.0, 2.0)
    wide = tswt.detect_words(img, tswt.SwtParams(min_height=4), device="cpu")
    assert T.evaluate_wolf(wide, truth) == J.evaluate_wolf(wide, truth)


def test_range_and_fields_match():
    assert dataclasses.asdict(T.Range(1, 2, 3)) == dataclasses.asdict(
        J.Range(1, 2, 3))
    assert (T.ONE_G, T.ONE_D, T.OM_ONE, T.CENTER_DIFF_THR) == (
        J.ONE_G, J.ONE_D, J.OM_ONE, J.CENTER_DIFF_THR)


def text_crop():
    """(the crop of text_test.png, its one annotated line)."""
    y0, y1, x0, x1 = CROP
    img = read(os.path.join(DATA, "text_test.png"), device="cpu").numpy()
    return (np.ascontiguousarray(img[y0:y1, x0:x1]),
            [(54 - x0, 109 - y0, 385, 37)])


@pytest.fixture(scope="module")
def ref_search():
    """ccv_tpu's optimize_params on the crop from the bad start (the file's
    one ccv_tpu search): the SwtParams it returns and each detect_words
    call's (min_height, words)."""
    crop, truth = text_crop()
    seen = []
    detect = jswt.detect_words

    def spy(img, p=None, *a, **k):
        words = detect(img, p, *a, **k)
        seen.append((p.min_height, rects(words)))
        return words

    mp = pytest.MonkeyPatch()
    mp.setattr(jswt, "detect_words", spy)
    try:
        best = J.optimize_params(
            [crop], [truth], {"min_height": J.Range(8, 26, 34)},
            base=jswt.SwtParams(min_height=BAD), iterations=2,
            integer_fields=("min_height",))
    finally:
        mp.undo()
    return best, seen


def test_optimize_params_picks_as_ccv_tpu(ref_search):
    want, seen = ref_search
    crop, truth = text_crop()
    got = T.optimize_params(
        [crop], [truth], {"min_height": T.Range(8, 26, 34)},
        base=tswt.SwtParams(min_height=BAD), iterations=2,
        integer_fields=("min_height",), device="cpu")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.min_height == 8 and isinstance(got.min_height, int)
    # the searched values in ccv_tpu's order: the start, then two sweeps
    # (the second finds nothing better and ends the search)
    assert [m for m, _ in seen] == [BAD, 8, 34, 8, 34]
    t = torch.from_numpy(crop)
    for m, words in seen:
        assert rects(tswt.detect_words(
            t, tswt.SwtParams(min_height=m))) == words, m
    assert seen[0][1] == [] and seen[1][1] == truth
