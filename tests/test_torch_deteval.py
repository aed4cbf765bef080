"""Port parity: the vldtr scorers (ccv_tpu_torch/utils/deteval.py against
ccv_tpu/utils/deteval.py), on the hand-made cases of tests/test_vldtr.py
and on seeded random rect sets. Plain Python on both sides: the scores
must be equal."""

import math

import numpy as np
import pytest

from ccv_tpu.utils import deteval as jdeteval
from ccv_tpu_torch.utils import deteval as tdeteval


def R(x, y, w, h):
    return dict(x=float(x), y=float(y), width=float(w), height=float(h))


FACE_KEYS = ("left_eye", "right_eye", "nose", "left_mouth", "center_mouth",
             "right_mouth")

# (truth, estimate) pairs of tests/test_vldtr.py
VLDTR_CASES = [
    ({"a": [R(0, 0, 100, 50)]}, {"a": [R(2, 2, 100, 50)]}),
    ({"a": [R(0, 0, 100, 50)]}, {"a": [R(500, 500, 100, 50)]}),
    ({"a": [R(0, 0, 200, 50)]}, {"a": [R(0, 0, 100, 50), R(100, 0, 100, 50)]}),
    ({"a": [R(0, 0, 100, 50), R(100, 0, 100, 50)]}, {"a": [R(0, 0, 200, 50)]}),
    ({"a": [R(0, 0, 100, 100)]},
     {"a": [R(0, 0, 100, 100), R(5, 5, 100, 100), R(500, 0, 10, 10)]}),
]


def _random_sets(seed):
    """Truth and estimates over a few images: estimates jittered from the
    truth (some split in two, some merged, some dropped) plus strays, and
    an image that only one side has."""
    rng = np.random.default_rng(seed)
    truth, est = {}, {}
    for img in range(4):
        name = f"img{img}"
        boxes = [R(*rng.integers(0, 300, 2), *rng.integers(10, 80, 2))
                 for _ in range(int(rng.integers(1, 7)))]
        truth[name] = boxes
        out = []
        for b in boxes:
            kind = rng.integers(0, 4)
            jx, jy = rng.normal(0, 3, 2)
            if kind == 0:
                out.append(R(b["x"] + jx, b["y"] + jy, b["width"], b["height"]))
            elif kind == 1:  # split in two halves
                half = b["width"] / 2
                out += [R(b["x"], b["y"], half, b["height"]),
                        R(b["x"] + half, b["y"], half, b["height"])]
            elif kind == 2:  # a larger box around it
                out.append(R(b["x"] - 5, b["y"] - 5, b["width"] + 10,
                             b["height"] + 10))
        out += [R(*rng.integers(0, 300, 2), *rng.integers(5, 60, 2))
                for _ in range(int(rng.integers(0, 3)))]
        if out:
            est[name] = out
    est["stray"] = [R(1, 2, 30, 40)]
    return truth, est


CASES = VLDTR_CASES + [_random_sets(seed) for seed in range(6)]


@pytest.mark.parametrize("scorer", ["deteval", "pascal_score",
                                    "overlap_score"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_rect_scorers_match_jax(scorer, case):
    truth, est = CASES[case]
    want = getattr(jdeteval, scorer)(truth, est)
    got = getattr(tdeteval, scorer)(truth, est)
    assert got == want
    assert all(math.isfinite(v) for v in got)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_deteval_image_matches_jax(case):
    truth, est = CASES[case]
    for name, rects in truth.items():
        targets = est.get(name, [])
        assert tdeteval.deteval_image(rects, targets) == \
            jdeteval.deteval_image(rects, targets)


def test_pascal_score_threshold_matches_jax():
    truth, est = _random_sets(7)
    for iou in (0.1, 0.3, 0.5, 0.7):
        assert tdeteval.pascal_score(truth, est, iou) == \
            jdeteval.pascal_score(truth, est, iou)


@pytest.mark.parametrize("seed", range(4))
def test_cmu_face_score_matches_jax(seed):
    rng = np.random.default_rng(seed)
    truth, dets = {}, {}
    for img in range(3):
        faces = []
        for _ in range(int(rng.integers(1, 4))):
            cx, cy = rng.uniform(40, 260, 2)
            faces.append({k: dict(x=float(cx + rng.normal(0, 8)),
                                  y=float(cy + rng.normal(0, 8)))
                          for k in FACE_KEYS})
        truth[f"img{img}"] = faces
        dets[f"img{img}"] = [R(f["nose"]["x"] - 20 + rng.normal(0, 10),
                               f["nose"]["y"] - 20 + rng.normal(0, 10),
                               40, 40) for f in faces]
    dets["none"] = [R(0, 0, 10, 10)]
    want = jdeteval.cmu_face_score(truth, dets)
    assert tdeteval.cmu_face_score(truth, dets) == want
    assert want[0] > 0 and want[1] > 0  # both hits and false alarms


def test_topk_miss_matches_jax():
    rng = np.random.default_rng(3)
    truth = [int(t) for t in rng.integers(0, 10, 50)]
    ranks = [[int(r) for r in rng.permutation(10)[:5]] for _ in range(49)]
    ranks.append([])
    assert tdeteval.topk_miss(truth, ranks) == jdeteval.topk_miss(truth,
                                                                   ranks)
    assert tdeteval.topk_miss([3, 7, 9], [[3, 1, 2, 4, 5], [1, 7, 2, 4, 5],
                                          [1, 2, 4, 5, 6]]) == \
        jdeteval.topk_miss([3, 7, 9], [[3, 1, 2, 4, 5], [1, 7, 2, 4, 5],
                                       [1, 2, 4, 5, 6]])


def test_parse_rect_file_matches_jax(tmp_path):
    f = tmp_path / "r.txt"
    f.write_text("img1.png\n1 2 30 40\n5 6 70 80 0.9\n\nimg2.png\n"
                 "-1 -2 3 4\nnot a rect\n7 8 9 10\n")
    want = jdeteval.parse_rect_file(str(f))
    assert tdeteval.parse_rect_file(str(f)) == want
    assert len(want["img1.png"]) == 2 and "not a rect" in want
