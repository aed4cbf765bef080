"""Port parity: BBF cascade training (ccv_tpu_torch/train/bbf.py), on the
CPU (the bbfcreate / bbfvldtr CLIs: tests/test_torch_train_tools.py).

BBF training draws only from a ``np.random.Generator`` (the population's
point sets and their mutations), and its weights, errors and thresholds
are float64 numpy on the host in both packages, so the port is held to
ccv_tpu exactly: equal pyramids and responses, equal Generator states after
each draw, the same cascade to the bit (features, stage_of, thresholds and
alphas as float32 bits), byte-equal cascade files, equal detections of the
trained cascade in both packages. The patches are tests/test_train_bbf.py's
synthetic task (dark eye and mouth bands against noise) at 24 x 24.
"""

import os

import numpy as np
import pytest
import torch

from ccv_tpu.detectors import bbf as jbbf
from ccv_tpu.train import bbf as J
from ccv_tpu_torch.detectors import bbf as tbbf
from ccv_tpu_torch.train import bbf as T
from test_train_bbf import _patches

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(population=128, generations=3, max_features_per_stage=8,
             n_stages=3, seed=2)
POINTS = ("px", "py", "pz", "nx", "ny", "nz")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this file runs: the port's many small CPU
    ops crawl when the test workers' thread pools contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    return _patches(120, rng, True), _patches(300, rng, False)


@pytest.fixture(scope="module")
def ref(data):
    """ccv_tpu's cascade on the patches (the file's one ccv_tpu training)."""
    return J.train_cascade(*data, J.BbfTrainParams(**SMALL))


@pytest.fixture(scope="module")
def mine(data):
    timings = {}
    return T.train_cascade(*data, T.BbfTrainParams(**SMALL), "cpu",
                           timings=timings), timings


def same_cascade(got, want):
    assert (got.width, got.height, got.n_stages) == (
        want.width, want.height, want.n_stages)
    for k in ("stage_of",) + POINTS:
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                      err_msg=k)
    for k in ("thresholds", "alphas"):
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype == np.float32, k
        assert a.tobytes() == b.tobytes(), k


def in_use(cas):
    """``cas`` with the slots past each feature's points as a loaded
    cascade has them: x and z -1, y 0."""
    out = dict(vars(cas))
    for s in "pn":
        used = getattr(cas, s + "z") >= 0
        out[s + "x"] = np.where(used, getattr(cas, s + "x"), -1)
        out[s + "y"] = np.where(used, getattr(cas, s + "y"), 0)
    return type(cas)(**out)


def test_params_match():
    assert T.BbfTrainParams() == T.BbfTrainParams(**vars(J.BbfTrainParams()))
    assert T.MAX_POINTS == J.MAX_POINTS


def test_flatten_pyramids_equal(data):
    x = np.concatenate(data)
    got = T.flatten_pyramids(x, (24, 24), "cpu")
    want = J.flatten_pyramids(x, (24, 24))
    assert got.dtype == torch.int32 and tuple(got.shape) == (420, 756)
    np.testing.assert_array_equal(got.numpy(), want)
    # a tensor stays on its device; RGB patches read channel 0
    rgb = np.repeat(x[..., None], 3, -1)
    np.testing.assert_array_equal(
        T.flatten_pyramids(torch.from_numpy(rgb), (24, 24)).numpy(), want)


@pytest.mark.parametrize("seed", [0, 5])
def test_random_features_and_mutation_draw_as_ccv_tpu(seed):
    ra, rb = np.random.default_rng(seed), np.random.default_rng(seed)
    fa = T._random_features(64, (24, 24), ra)
    fb = J._random_features(64, (24, 24), rb)
    for a, b in zip(fa, fb):
        np.testing.assert_array_equal(a, b)
    assert ra.bit_generator.state == rb.bit_generator.state
    ma, mb = T._mutate(fa, (24, 24), ra), J._mutate(fb, (24, 24), rb)
    for a, b in zip(ma, mb):
        np.testing.assert_array_equal(a, b)
    assert ra.bit_generator.state == rb.bit_generator.state


def test_feature_responses_equal(data):
    x = np.concatenate(data)
    feats = J._random_features(200, (24, 24), np.random.default_rng(3))
    feats = J._mutate(feats, (24, 24), np.random.default_rng(4))
    flat = J.flatten_pyramids(x, (24, 24))
    want = J.feature_responses(flat, *feats, (24, 24))
    got = T.feature_responses(torch.from_numpy(flat), *feats, (24, 24))
    assert got.dtype == np.bool_ and got.shape == (420, 200)
    np.testing.assert_array_equal(got, want)
    assert 0 < got.mean() < 1


def test_cascade_equals_ccv_tpu(ref, mine):
    got, timings = mine
    same_cascade(got, ref)
    assert len(timings["stage_s"]) == got.n_stages
    assert timings["generations"] >= len(got.stage_of) * SMALL["generations"]


def test_written_files_byte_equal_and_load_in_both(ref, mine, tmp_path):
    got, _ = mine
    a, b = str(tmp_path / "port"), str(tmp_path / "ref")
    T.write_cascade(got, a)
    J.write_cascade(ref, b)
    names = sorted(os.listdir(b))
    assert names == sorted(os.listdir(a))
    assert names == ["cascade.txt"] + [f"stage-{s}.txt"
                                       for s in range(ref.n_stages)]
    for n in names:
        with open(os.path.join(a, n), "rb") as fa, \
                open(os.path.join(b, n), "rb") as fb:
            assert fa.read() == fb.read(), n
    # the files keep the points in use: a dropped point's y stays in the
    # trained arrays (the mutation clears only x and z), and reads back 0
    same_cascade(tbbf.load_cascade(b), in_use(ref))
    same_cascade(jbbf.load_cascade(a), in_use(ref))
    same_cascade(tbbf.load_cascade(a), jbbf.load_cascade(b))


def test_trained_cascade_detects_as_ccv_tpu(mine, tmp_path):
    got, _ = mine
    d = str(tmp_path / "face")
    T.write_cascade(got, d)
    rng = np.random.default_rng(5)
    scene = np.clip(rng.normal(140, 18, (72, 96)), 0, 255).astype(np.uint8)
    scene[24:48, 40:64] = _patches(1, np.random.default_rng(8), True)[0]
    params = dict(min_neighbors=0, interval=1)
    mine_r = tbbf.detect_objects(scene, tbbf.load_cascade(d),
                                 tbbf.BbfParams(**params), device="cpu")
    ref_r = jbbf.detect_objects(scene, jbbf.load_cascade(d),
                                jbbf.BbfParams(**params))

    def rects(cs):
        return sorted((c.x, c.y, c.width, c.height) for c in cs)

    assert mine_r and rects(mine_r) == rects(ref_r)
    np.testing.assert_allclose(
        sorted(c.confidence for c in mine_r),
        sorted(c.confidence for c in ref_r), rtol=1e-6)
    # the planted pattern is found
    assert any(abs(c.x - 40) <= 4 and abs(c.y - 24) <= 4 for c in mine_r)
