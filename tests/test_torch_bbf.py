"""Port parity on the CPU: BBF detection (ccv_tpu_torch/detectors/bbf.py)
against ccv_tpu's, on crop120.png and crop180.png, with a seeded cascade
written by ccv_tpu's ``write_cascade`` and read by both packages. The
reference's trained face cascade is not in the repository.

The cascade: 6 stages of 8-15 features of 1-3 point pairs over the three
levels, thresholds set from the port's stage sums of crop120 so that windows
end at every stage and about 2% pass, each threshold in the middle of a gap
of the alive windows' sums at least 8 x MARGIN wide. Gates: at
``min_neighbors=0`` the windows are the same wherever no stage sum lies
within MARGIN * max(1, |sum|) of its threshold, last-stage sums within
2e-4; at ``min_neighbors=2`` the grouped rects are the same.
"""

import os

import numpy as np
import pytest
import torch

from ccv_tpu.core.io import IO_GRAY, read
from ccv_tpu.detectors import bbf as jbbf
from ccv_tpu.train import bbf as jtrain
from ccv_tpu_torch.detectors import bbf

DATA = os.path.join(os.path.dirname(__file__), "data")
MARGIN = 1e-4
ATOL = 2e-4
STAGES = 6


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def synth_cascade(rng, n_stages=STAGES, per=(8, 16)):
    """A ccv_tpu BbfCascade of random features, thresholds open."""
    cols = {k: [] for k in ("px", "py", "pz", "nx", "ny", "nz")}
    stage_of, alphas = [], []
    for s in range(n_stages):
        for _ in range(int(rng.integers(*per))):
            size = int(rng.integers(1, 4))
            for sign in "pn":
                z = rng.integers(0, 3, 8)
                side = np.array([24, 12, 6])[z]
                x = rng.integers(0, 24, 8) % side
                y = rng.integers(0, 24, 8) % side
                x[size:], y[size:], z[size:] = -1, 0, -1
                for k, v in zip("xyz", (x, y, z)):
                    cols[sign + k].append(v)
            alphas.append(rng.normal(0, 1, 2))
            stage_of.append(s)
    return jbbf.BbfCascade(
        24, 24, np.array(stage_of, np.int32), n_stages,
        np.full(n_stages, -1e9, np.float32), np.array(alphas, np.float32),
        **{k: np.array(v, np.int32) for k, v in cols.items()})


def graded_thresholds(sums, survive):
    """Per-stage thresholds, each in the middle of a gap of the alive
    windows' sums wider than 8 x MARGIN, near the quantile that keeps
    ``survive`` ** (1 / stages) of them."""
    keep = survive ** (1 / sums.shape[1])
    alive = np.ones(len(sums), bool)
    th = np.zeros(sums.shape[1], np.float32)
    for s in range(sums.shape[1]):
        u = np.unique(sums[alive, s])
        mids = (u[1:] + u[:-1]) / 2
        wide = (u[1:] - u[:-1]) > 8 * MARGIN * np.maximum(1, np.abs(mids))
        kill = np.searchsorted(np.sort(sums[alive, s]), mids) / alive.sum()
        i = int(np.argmin(np.where(wide, np.abs(kill - (1 - keep)), np.inf)))
        th[s] = mids[i]
        alive &= sums[:, s] >= th[s]
    return th


@pytest.fixture(scope="module")
def images():
    return {name: np.asarray(read(os.path.join(DATA, name), IO_GRAY).numpy())
            for name in ("crop120.png", "crop180.png")}


@pytest.fixture(scope="module")
def cascade_dir(tmp_path_factory, images):
    casc = synth_cascade(np.random.default_rng(5))
    _, sums = bbf.window_sums(torch.from_numpy(images["crop120.png"]), casc,
                              bbf.BbfParams(interval=1))
    casc.thresholds[:] = graded_thresholds(sums, 0.02)
    alive = np.minimum.accumulate(sums >= casc.thresholds, axis=1)
    ends = [int(v) for v in len(sums) - alive.sum(0)]
    assert all(b > a for a, b in zip([0] + ends, ends)), ends  # every stage
    path = str(tmp_path_factory.mktemp("bbf") / "face")
    jtrain.write_cascade(casc, path)
    return path


CASES = [("crop120.png", dict(interval=1)),
         ("crop180.png", dict(interval=1, accurate=False))]


@pytest.fixture(scope="module")
def ccv_tpu_results(cascade_dir, images):
    """ccv_tpu's raw windows and grouped rects per case."""
    casc = jbbf.load_cascade(cascade_dir)
    out = {}
    for name, kw in CASES:
        raw = jbbf.detect_objects(images[name], casc,
                                  jbbf.BbfParams(min_neighbors=0, **kw))
        grouped = jbbf.detect_objects(images[name], casc, jbbf.BbfParams(**kw))
        out[name] = (raw, grouped)
    return out


def test_cascade_reads_as_ccv_tpu_and_writes_back(cascade_dir, tmp_path):
    want, got = jbbf.load_cascade(cascade_dir), bbf.load_cascade(cascade_dir)
    assert (got.width, got.height, got.n_stages) == (24, 24, STAGES)
    for f in ("stage_of", "thresholds", "alphas", "px", "py", "pz", "nx",
              "ny", "nz"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    bbf.write_cascade(got, str(tmp_path / "back"))
    for name in os.listdir(cascade_dir):
        assert open(os.path.join(cascade_dir, name)).read() == \
            open(tmp_path / "back" / name).read(), name


@pytest.mark.parametrize("name,kw", CASES, ids=[c[0] for c in CASES])
def test_windows_match_outside_the_margin(cascade_dir, images,
                                          ccv_tpu_results, name, kw):
    casc = bbf.load_cascade(cascade_dir)
    img = torch.from_numpy(images[name])
    params = bbf.BbfParams(min_neighbors=0, **kw)
    got = {(c.x, c.y, c.width, c.height): c.confidence
           for c in bbf.detect_objects(img, casc, params)}
    want = {(c.x, c.y, c.width, c.height): c.confidence
            for c in ccv_tpu_results[name][0]}
    assert 20 <= len(want) and len(got) == len(
        bbf.detect_objects(img, casc, params))  # no two windows share a rect
    odd = set(got) ^ set(want)
    if odd:
        rects, sums = bbf.window_sums(img, casc, params)
        near = (np.abs(sums - casc.thresholds)
                <= MARGIN * np.maximum(1, np.abs(sums))).any(1)
        at = {tuple(int(v) for v in r): n for r, n in zip(rects, near)}
        assert all(at[r] for r in odd), odd
    both = set(got) & set(want)
    assert max(abs(got[r] - want[r]) for r in both) <= ATOL


@pytest.mark.parametrize("name,kw", CASES, ids=[c[0] for c in CASES])
def test_grouped_rects_match(cascade_dir, images, ccv_tpu_results, name, kw):
    casc = bbf.load_cascade(cascade_dir)
    got = bbf.detect_objects(torch.from_numpy(images[name]), casc,
                             bbf.BbfParams(**kw))
    want = ccv_tpu_results[name][1]
    assert len(want) > 0
    assert [(c.x, c.y, c.width, c.height, c.neighbors) for c in got] == \
        [(c.x, c.y, c.width, c.height, c.neighbors) for c in want]


def test_rgb_input_is_read_as_gray(cascade_dir, images):
    """An RGB image goes through libjpeg's gray coefficients, as ccv_tpu's
    host conversion does."""
    from ccv_tpu.core.io import rgb_to_gray_u8

    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (72, 96, 3)).astype(np.uint8)
    casc = bbf.load_cascade(cascade_dir)
    params = bbf.BbfParams(min_neighbors=0, interval=1)
    got = bbf.detect_objects(torch.from_numpy(rgb), casc, params)
    gray = bbf.detect_objects(torch.from_numpy(rgb_to_gray_u8(rgb)), casc,
                              params)
    assert [(c.x, c.y, c.confidence) for c in got] == \
        [(c.x, c.y, c.confidence) for c in gray]


def test_gathers_are_chunked_without_changing_the_result(cascade_dir, images,
                                                         monkeypatch):
    casc = bbf.load_cascade(cascade_dir)
    img = torch.from_numpy(images["crop120.png"])
    params = bbf.BbfParams(min_neighbors=0, interval=1)
    whole = bbf.detect_objects(img, casc, params)
    monkeypatch.setattr(bbf, "GATHER_ELEMENTS", 16 * 64 * len(casc.stage_of))
    chunked = bbf.detect_objects(img, casc, params)
    assert [(c.x, c.y, c.width, c.height, c.confidence) for c in whole] == \
        [(c.x, c.y, c.width, c.height, c.confidence) for c in chunked]
