"""Port parity on the CPU: MSER and MSCR (ccv_tpu_torch/detectors/mser.py,
the C++ in ccv_tpu_torch/csrc built on first use) and DAISY
(detectors/daisy.py) against ccv_tpu.

Gates: MSER on a gray text_test.png crop, plain and with msermatch's canny
/ close_outline mask: keypoints and label map identical. MSCR on crop180.png
in RGB with msermatch's params: the four chi maps identical (so the same C++
sees the same bytes) and the keypoints and labels identical. DAISY on a
64x64 crop within 1e-5 in each normalisation.
"""

import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccv_tpu.core.io import IO_GRAY, IO_RGB_COLOR, read
from ccv_tpu.detectors import daisy as jdaisy
from ccv_tpu.detectors import mser as jmser
from ccv_tpu.ops import classic as jclassic
from ccv_tpu_torch import _native_build
from ccv_tpu_torch.detectors import daisy, mser
from ccv_tpu_torch.ops import classic

DATA = os.path.join(os.path.dirname(__file__), "data")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def text():
    return np.asarray(read(os.path.join(DATA, "text_test.png"),
                           IO_GRAY).numpy())[:240, :320].copy()


@pytest.fixture(scope="module")
def rgb():
    return np.asarray(read(os.path.join(DATA, "crop180.png"),
                           IO_RGB_COLOR).numpy())


def rows(kps):
    return [(k.size, *k.keypoint, k.x, k.y, k.width, k.height) for k in kps]


@pytest.mark.parametrize("direction", [mser.DARK_TO_BRIGHT,
                                       mser.BRIGHT_TO_DARK])
def test_mser_matches(text, direction):
    want, wl = jmser.mser(text, params=jmser.MserParams(direction=direction))
    got, gl = mser.mser(torch.from_numpy(text),
                        params=mser.MserParams(direction=direction))
    assert rows(got) == rows(want) and len(want) > 0
    assert np.array_equal(gl, wl)


def test_masked_mser_matches(text):
    """msermatch's pipeline: canny and close_outline on the device make the
    mask (equal to ccv_tpu's), then the masked MSER."""
    g = torch.from_numpy(text)
    outline = classic.close_outline(classic.canny(g, 3, 175, 320))
    want_outline = np.asarray(jclassic.close_outline(
        np.asarray(jclassic.canny(text, 3, 175, 320))))
    assert np.array_equal(outline.numpy(), want_outline)
    kw = dict(min_area=60, max_area=int(text.size * 0.3 + 0.5),
              min_diversity=0.2, delta=5, max_variance=0.25,
              direction=mser.DARK_TO_BRIGHT)
    want, wl = jmser.mser(text, h=want_outline, params=jmser.MserParams(**kw))
    got, gl = mser.mser(g, h=outline, params=mser.MserParams(**kw))
    assert rows(got) == rows(want) and len(want) > 0
    assert np.array_equal(gl, wl)


def mscr_params(mod, img):
    return mod.MserParams(
        min_area=60, max_area=int(img.shape[0] * img.shape[1] * 0.3 + 0.5),
        min_diversity=0.2, area_threshold=1.01, min_margin=0.003,
        max_evolution=200, edge_blur_sigma=math.sqrt(3.0))


def test_chi_maps_match(rgb):
    want = jmser._chi_maps(rgb, math.sqrt(3.0))
    got = mser._chi_maps(torch.from_numpy(rgb), math.sqrt(3.0))
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and np.array_equal(g, w)


def test_mscr_matches(rgb):
    want, wl = jmser.mscr(rgb, mscr_params(jmser, rgb))
    got, gl = mser.mscr(torch.from_numpy(rgb), mscr_params(mser, rgb))
    assert rows(got) == rows(want) and len(want) > 20
    assert np.array_equal(gl, wl)


def test_mser_any_dispatch(text, rgb):
    kg, _ = mser.mser_any(torch.from_numpy(text))
    assert rows(kg) == rows(mser.mser(torch.from_numpy(text))[0])
    kc, _ = mser.mser_any(torch.from_numpy(rgb), params=mscr_params(mser,
                                                                    rgb))
    assert rows(kc) == rows(jmser.mscr(rgb, mscr_params(jmser, rgb))[0])


def test_native_sources_build_into_the_port(text):
    """The MSER and MSCR libraries come from ccv_tpu_torch/csrc into
    ccv_tpu_torch/_build; nothing of ccv_tpu/native is loaded."""
    mser.mser(torch.from_numpy(text))
    mser.mscr(torch.from_numpy(text).float()[:40, :40])
    for name in ("ccv_tpu_mser", "ccv_tpu_mscr"):
        path = _native_build._loaded[name]._name
        assert os.path.dirname(path) == str(_native_build.BUILD_DIR), path
        assert (_native_build.CSRC / f"{name}.cpp").is_file()


def test_chitab3_is_the_closed_form():
    tab = mser._chitab3()
    assert np.array_equal(tab, jmser._chitab3())
    assert tab[0] == 0 and tab[-1] == 133.333


@pytest.mark.parametrize("method", [daisy.NORMAL_PARTIAL, daisy.NORMAL_FULL,
                                    daisy.NORMAL_SIFT])
def test_daisy_matches(text, method):
    crop = np.ascontiguousarray(text[100:164, 40:104])
    want = np.asarray(jdaisy.daisy(jnp.asarray(crop), jdaisy.DaisyParams(
        normalize_method=method)))
    got = daisy.daisy(torch.from_numpy(crop), daisy.DaisyParams(
        normalize_method=method))
    assert got.shape == want.shape == (64, 64, 200)
    assert np.abs(got.numpy() - want).max() <= 1e-5
