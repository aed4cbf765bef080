"""Port parity on the CPU: ``blur(out_float=True)``, ``hog``, the DPM
detector (ccv_tpu_torch/detectors/dpm.py), ``decimal_slice``,
``perspective_transform`` and Lucas-Kanade against ccv_tpu, and the DPM
probes against the C goldens.

Gates: blur 1e-6; HOG 1e-5; ``_corr31`` within 2e-3 of
dpm_filter_probe.txt and 1e-5 of ccv_tpu (times the largest |value| where
it exceeds 1: the probes reach a few hundred, where a float32 ulp is
larger than 1e-5); ``_gsedt`` values within 1e-3 of
dpm_gsedt_probe.txt and >= 99% of its offsets; ``detect`` on a 160x160 crop
at interval 0 with a seeded 1-root, 2-part model written by ccv_tpu's
``write_mixture_model``: the same RootComps (rects within 1 px, confidence
within 1e-3, part rects within 1 px), with a threshold that sits in a gap
of the windows' confidences; decimal_slice on 8U bit for bit; the
perspective warp >= 99.9% of pixels equal, the rest within 1; LK on shifted
text_test.png crops: points within 1e-3 px, status equal.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccv_tpu.core.io import IO_GRAY, IO_RGB_COLOR, read
from ccv_tpu.detectors import dpm as jdpm
from ccv_tpu.ops import basic as jbasic
from ccv_tpu.ops import classic as jclassic
from ccv_tpu.ops import transform as jtransform
from ccv_tpu.train import dpm as jtrain
from ccv_tpu_torch.detectors import dpm
from ccv_tpu_torch.ops import basic, classic, transform

DATA = os.path.join(os.path.dirname(__file__), "data")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def gray():
    return np.asarray(read(os.path.join(DATA, "crop180.png"),
                           IO_GRAY).numpy())


@pytest.fixture(scope="module")
def rgb():
    return np.asarray(read(os.path.join(DATA, "crop180.png"),
                           IO_RGB_COLOR).numpy())


@pytest.mark.parametrize("channels", ["gray", "rgb"])
def test_blur_out_float_matches(gray, rgb, channels):
    img = gray if channels == "gray" else rgb
    want = np.asarray(jbasic.blur(jnp.asarray(img), 1.3, out_float=True))
    got = basic.blur(torch.from_numpy(img), 1.3, out_float=True)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= 1e-6
    # without the flag the 8U path stays bit-exact
    assert np.array_equal(basic.blur(torch.from_numpy(img), 1.3).numpy(),
                          np.asarray(jbasic.blur(jnp.asarray(img), 1.3)))


@pytest.mark.parametrize("channels,size", [("gray", 8), ("rgb", 4)])
def test_hog_matches(gray, rgb, channels, size):
    img = (gray if channels == "gray" else rgb)[:96, :128]
    want = np.asarray(jclassic.hog(img, sbin=9, size=size))
    got = classic.hog(torch.from_numpy(np.ascontiguousarray(img)), 9, size)
    assert got.shape == want.shape == (96 // size, 128 // size, 31)
    assert np.abs(got.numpy() - want).max() <= 1e-5


def test_corr31_matches_probe_and_ccv_tpu():
    toks = open(os.path.join(DATA, "dpm_filter_probe.txt")).read().split()
    pos, n = 1, int(toks[0])
    for _ in range(n):
        ar, ac, br, bc, ch, fr, fc = map(int, toks[pos:pos + 7])
        pos += 7
        golden = np.array(toks[pos:pos + fr * fc], np.float32).reshape(fr, fc)
        pos += fr * fc
        a = (np.sin(np.arange(ar * ac * ch) * 0.37)
             + 0.01 * np.arange(ar * ac * ch)).astype(np.float32).reshape(
                 ar, ac, ch)
        b = np.cos(np.arange(br * bc * ch) * 0.53).astype(np.float32).reshape(
            br, bc, ch)
        got = dpm._corr31(torch.from_numpy(a), b).numpy()
        assert got.shape == golden.shape
        assert np.abs(got - golden).max() < 2e-3, (br, bc, ch)
        want = np.asarray(jdpm._corr31(jnp.asarray(a), b))
        scale = max(1.0, float(np.abs(want).max()))
        assert np.abs(got - want).max() <= 1e-5 * scale, (br, bc, ch)


def test_gsedt_matches_probe():
    rows = open(os.path.join(DATA, "dpm_gsedt_probe.txt")).read().split("\n")
    R, C = map(int, rows[0].split())
    vals = np.array([r.split() for r in rows[1:1 + R * C]], np.float64)
    g = (np.sin(np.arange(R * C) * 0.71) * 3.0).astype(np.float32).reshape(
        R, C)
    out, mx, my = (t.numpy() for t in dpm._gsedt(torch.from_numpy(g), 0.05,
                                                 -0.03, 0.11, 0.09))
    assert np.abs(out - vals[:, 0].reshape(R, C)).max() < 1e-3
    assert (mx == vals[:, 1].astype(int).reshape(R, C)).mean() >= 0.99
    assert (my == vals[:, 2].astype(int).reshape(R, C)).mean() >= 0.99


def seeded_model(seed=3):
    """A ccv_tpu 1-root (8 x 4 cells), 2-part (6 x 6) mixture model."""
    rng = np.random.default_rng(seed)

    def part(x, y):
        return jdpm.DpmPartClassifier(
            x, y, 0, 0.01, 0.02, 0.05, 0.06,
            rng.normal(0, 0.05, 6).astype(np.float32),
            rng.normal(0, 0.05, (6, 6, 31)).astype(np.float32), 0)

    return jdpm.DpmMixtureModel([jdpm.DpmRootClassifier(
        0.0, np.array([0.01, -0.02, 0.03], np.float32),
        rng.normal(0, 0.05, (8, 4, 31)).astype(np.float32),
        [part(1, 2), part(3, 6)])])


@pytest.fixture(scope="module")
def model_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("dpm") / "seeded.m")
    jtrain.write_mixture_model(seeded_model(), path)
    return path


@pytest.fixture(scope="module")
def dpm_case(model_file, rgb):
    """(image, threshold in a gap of the windows' confidences, ccv_tpu's
    raw windows and grouped comps at that threshold)."""
    img = np.ascontiguousarray(rgb[10:170, 10:170])
    jm = jdpm.read_mixture_model(model_file)
    every = jdpm.detect(img, jm, jdpm.DpmParams(interval=0, min_neighbors=0,
                                                threshold=-100.0))
    conf = np.sort([r.confidence for r in every])[::-1]
    gaps = conf[:-1] - conf[1:]
    k = 30 + int(np.argmax(gaps[30:60] > 2e-3))
    threshold = float(conf[k] + conf[k + 1]) / 2
    raw = jdpm.detect(img, jm, jdpm.DpmParams(interval=0, min_neighbors=0,
                                              threshold=threshold))
    grouped = jdpm.detect(img, jm, jdpm.DpmParams(interval=0,
                                                  threshold=threshold))
    return img, threshold, raw, grouped


def test_model_file_reads_as_ccv_tpu_and_writes_back(model_file, tmp_path):
    jm = jdpm.read_mixture_model(model_file)
    tm = dpm.read_mixture_model(model_file)
    for jr, tr in zip(jm.roots, tm.roots):
        assert jr.beta == tr.beta and np.array_equal(jr.w, tr.w)
        assert np.array_equal(jr.alpha, tr.alpha)
        for jp, tp in zip(jr.parts, tr.parts):
            assert (jp.x, jp.y, jp.z, jp.dx, jp.dy, jp.dxx, jp.dyy,
                    jp.counterpart) == (tp.x, tp.y, tp.z, tp.dx, tp.dy,
                                        tp.dxx, tp.dyy, tp.counterpart)
            assert np.array_equal(jp.w, tp.w)
            assert np.array_equal(jp.alpha, tp.alpha)
    out = str(tmp_path / "back.m")
    dpm.write_mixture_model(tm, out)
    assert open(out).read() == open(model_file).read()


def same_comps(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert max(abs(g.x - w.x), abs(g.y - w.y), abs(g.width - w.width),
                   abs(g.height - w.height)) <= 1, (g, w)
        assert abs(g.confidence - w.confidence) <= 1e-3
        assert g.neighbors == w.neighbors
        assert len(g.parts) == len(w.parts)
        for gp, wp in zip(g.parts, w.parts):
            assert max(abs(gp.x - wp.x), abs(gp.y - wp.y),
                       abs(gp.width - wp.width),
                       abs(gp.height - wp.height)) <= 1, (gp, wp)
            assert abs(gp.confidence - wp.confidence) <= 1e-3


@pytest.mark.parametrize("grouped", [False, True], ids=["raw", "grouped"])
def test_dpm_detect_matches(model_file, dpm_case, grouped):
    img, threshold, raw, grouped_want = dpm_case
    tm = dpm.read_mixture_model(model_file)
    params = dpm.DpmParams(interval=0, min_neighbors=1 if grouped else 0,
                           threshold=threshold)
    got = dpm.detect(img, tm, params, device="cpu")
    same_comps(got, grouped_want if grouped else raw)


def test_dpm_needs_a_card_unless_asked(model_file, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device is required"):
        dpm.detect(np.zeros((64, 64, 3), np.uint8),
                   dpm.read_mixture_model(model_file))


@pytest.mark.parametrize("y,x", [(3.3, 4.7), (-2.5, 7.25), (170.2, 170.9),
                                 (np.float32(50.123), np.float32(20.987))])
def test_decimal_slice_matches(gray, y, x):
    want = np.asarray(jtransform.decimal_slice(jnp.asarray(gray), y, x, 10,
                                               12))
    got = transform.decimal_slice(torch.from_numpy(gray), y, x, 10, 12)
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)
    f = gray.astype(np.float32)
    want = np.asarray(jtransform.decimal_slice(jnp.asarray(f), y, x, 10, 12))
    got = transform.decimal_slice(torch.from_numpy(f), y, x, 10, 12)
    assert np.abs(got.numpy() - want).max() <= 1e-4


@pytest.mark.parametrize("m", [
    (0.98, 0.05, 3.0, -0.04, 1.01, -2.0, 0.03, -0.02, 0.99),
    (0.995, 0.096, 0.5, -0.37, 0.929, -0.8, -0.247, -0.302, 0.924)],
    ids=["mild", "strong"])
def test_perspective_transform_matches(gray, rgb, m):
    for img in (gray, rgb):
        want = np.asarray(jtransform.perspective_transform(jnp.asarray(img),
                                                           *m)).astype(int)
        got = transform.perspective_transform(torch.from_numpy(img), *m)
        assert got.dtype == torch.uint8
        d = np.abs(got.numpy().astype(int) - want)
        assert (d == 0).mean() >= 0.999 and d.max() <= 1


def test_lucas_kanade_matches():
    img = np.asarray(read(os.path.join(DATA, "text_test.png"),
                          IO_GRAY).numpy())
    a, b = img[10:250, 20:340], img[13:253, 22:342]
    rng = np.random.default_rng(0)
    pts = np.stack([rng.uniform(20, 300, 80), rng.uniform(20, 220, 80)],
                   1).astype(np.float32)
    want, wstatus = jclassic.optical_flow_lucas_kanade(a, b, pts, (15, 15),
                                                       3, 0.01)
    got, status = classic.optical_flow_lucas_kanade(
        torch.from_numpy(a), torch.from_numpy(b), pts, (15, 15), 3, 0.01)
    assert np.array_equal(status.numpy(), wstatus) and wstatus.sum() >= 8
    assert np.abs(got.numpy() - want).max() <= 1e-3
    # the tracked points moved by the crops' shift, (-2, -3)
    d = np.median(got.numpy()[wstatus] - pts[wstatus], 0)
    assert np.abs(d - [-2, -3]).max() < 0.1, d
