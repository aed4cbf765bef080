"""Port parity: SIFT keypoints, descriptors and matching
(ccv_tpu_torch/detectors/sift.py) against ccv_tpu on the CPU, on two small
crops of the repository's images (an object inside a scene; the reference
samples book.png and scene.png are not in the repository).

Keypoints differ where a float DoG compare or an orientation peak lands the
other way, so the gate is a fraction, as tests/test_sift.py's against C:
at least 97% of ccv_tpu's keypoints have a port keypoint within 0.5 px,
5% of the scale and 0.05 rad of the angle, and the same the other way;
their descriptors (unit norm) within 1e-3. match and the matching inside
match_pair give ccv_tpu's indices on the same descriptors.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccv_tpu.core.io import IO_GRAY, read
from ccv_tpu.detectors import sift as jsift
from ccv_tpu_torch.detectors import sift

DATA = os.path.join(os.path.dirname(__file__), "data")
FRACTION = 0.97


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def images():
    """(object, scene): a 72 x 96 piece of a 128 x 128 scene cut from
    text_test.png's first line."""
    text = np.array(read(os.path.join(DATA, "text_test.png"), IO_GRAY).array)
    scene = np.ascontiguousarray(text[96:224, 32:160])
    return np.ascontiguousarray(scene[20:92, 16:112]), scene


@pytest.fixture(scope="module")
def results(images):
    """ccv_tpu's and the port's (keypoints, descriptors) of both images:
    ccv_tpu's in one program for the pair."""
    want = jsift.sift_many(list(images))
    got = [sift.sift(torch.from_numpy(im)) for im in images]
    return want, got


def _pairs(ka, kb):
    """Indices (i, j): kb[j] within 0.5 px, 5% of the scale and 0.05 rad
    of ka[i], the nearest such."""
    B = np.array([[k["x"], k["y"], k["scale"], k["angle"]] for k in kb])
    out = []
    for i, k in enumerate(ka):
        d = np.hypot(B[:, 0] - k["x"], B[:, 1] - k["y"])
        da = np.abs((B[:, 3] - k["angle"] + np.pi) % (2 * np.pi) - np.pi)
        ok = ((np.abs(B[:, 0] - k["x"]) <= 0.5)
              & (np.abs(B[:, 1] - k["y"]) <= 0.5)
              & (np.abs(B[:, 2] - k["scale"]) <= 0.05 * k["scale"])
              & (da <= 0.05))
        if ok.any():
            out.append((i, int(np.argmin(np.where(ok, d + da, np.inf)))))
    return out


@pytest.mark.parametrize("which", [0, 1], ids=["object", "scene"])
def test_keypoints_and_descriptors(results, which):
    (kw, dw), (kg, dg) = results[0][which], results[1][which]
    assert len(kw) > 20
    fwd, back = _pairs(kw, kg), _pairs(kg, kw)
    assert len(fwd) >= FRACTION * len(kw), (len(fwd), len(kw))
    assert len(back) >= FRACTION * len(kg), (len(back), len(kg))
    assert dg.shape == (len(kg), 128) and dg.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(dg, axis=1), 1.0, atol=1e-5)
    i, j = np.array(fwd).T
    assert np.abs(dg[j] - dw[i]).max() <= 1e-3
    for a, b in fwd:
        assert (kg[b]["octave"], kg[b]["level"]) == \
            (kw[a]["octave"], kw[a]["level"])


def test_match_equals_ccv_tpu(results):
    (_, d1), (_, d2) = results[0]
    idx_w, ok_w = jsift.match(d1, d2)
    idx_g, ok_g = sift.match(d1, d2, device="cpu")
    assert ok_w.sum() > 5
    np.testing.assert_array_equal(idx_g, idx_w)
    np.testing.assert_array_equal(ok_g, ok_w)


@pytest.mark.parametrize("ratio", [0.36, 0.8])
def test_match_core_equals_ccv_tpu(results, ratio):
    (_, d1), (_, d2) = results[0]
    v1, v2 = np.ones(len(d1), bool), np.ones(len(d2), bool)
    idx_w, ok_w = jsift._match_core(jnp.asarray(d1), jnp.asarray(v1),
                                    jnp.asarray(d2), jnp.asarray(v2), ratio)
    idx_g, ok_g = sift._match_core(torch.from_numpy(d1),
                                   torch.from_numpy(d2), ratio)
    np.testing.assert_array_equal(idx_g.numpy(), np.asarray(idx_w))
    np.testing.assert_array_equal(ok_g.numpy(), np.asarray(ok_w))


def test_match_one_scene_descriptor(results):
    """With one scene row the second distance is inf: every row matches."""
    (_, d1), _ = results[1]
    idx, ok = sift.match(d1, d1[:1], device="cpu")
    assert (idx == 0).all() and ok.all()


def test_match_pair_equals_sift_then_match(results, images):
    k1, k2, pairs = sift.match_pair(*(torch.from_numpy(im) for im in images))
    (kg1, dg1), (kg2, dg2) = results[1]
    assert k1 == kg1 and k2 == kg2
    idx, ok = sift.match(dg1, dg2, device="cpu")
    assert pairs == [(i, int(j)) for i, (j, m) in enumerate(zip(idx, ok))
                     if m]
    assert len(pairs) > 5


def test_build_octave_equals_ccv_tpu(images):
    """One octave's first level, DoG, orientation and magnitude planes on
    a float image, within 1e-5 of the largest value."""
    g0 = images[0].astype(np.float32)
    want = jsift.build_octave(jnp.asarray(g0), 6)
    got = sift.build_octave(torch.from_numpy(g0), 6)
    for w, g in zip(want, got):
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


def test_no_keypoints_on_a_flat_image():
    flat = torch.full((64, 64), 90, dtype=torch.uint8)
    kps, desc = sift.sift(flat)
    assert kps == [] and desc is None
    assert sift.match_pair(flat, flat)[2] == []


def test_needs_a_card_unless_asked(images, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device is required"):
        sift.sift(images[0])
