"""Port parity: the SCD face-detection main path, its two longest tests
(moved here from tests/test_torch_scd.py so that a run spread over files
can spread them; bodies, parameters and tolerances unchanged).

Goldens (tests/data, made with the C implementation; see tests/test_scd.py):
crop180.scd_i1.txt (every window at interval=1) and crop180.scd_open.txt
(default params), both with face_low.sqlite3, whose stage thresholds are
all -1000.
"""

import os

import numpy as np
import pytest
import torch

from ccv_tpu.core import io as jio
from ccv_tpu_torch.core import io as tio
from ccv_tpu_torch.detectors import scd as tscd

DATA = os.path.join(os.path.dirname(__file__), "data")
CASCADE = os.path.join(DATA, "face_low.sqlite3")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch intra-op thread while this module runs: the suite runs in
    several worker processes, whose thread pools oversubscribe the cores
    (tests/test_torch_scd_staged.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def crop():
    return tio.read(os.path.join(DATA, "crop180.png"), tio.IO_RGB_COLOR,
                    device="cpu")


@pytest.fixture(scope="module")
def cascade():
    return tscd.load_cascade(CASCADE)


def _golden(name):
    ref = {}
    with open(os.path.join(DATA, name)) as f:
        for line in f:
            x, y, w, h, conf = line.split()
            ref[(int(x), int(y), int(w), int(h))] = float(conf)
    return ref


def _by_rect(comps):
    return {(int(c.x), int(c.y), int(c.width), int(c.height)): c.confidence
            for c in comps}


@pytest.mark.parametrize("interval,golden,tol", [
    (1, "crop180.scd_i1.txt", 6e-3), (5, "crop180.scd_open.txt", 2e-2)])
def test_window_parity_with_c_goldens(crop, cascade, interval, golden, tol):
    out = tscd.detect(crop, cascade,
                      tscd.ScdParams(min_neighbors=0, interval=interval))
    mine, ref = _by_rect(out), _golden(golden)
    assert set(mine) == set(ref), (len(mine), len(ref))
    assert max(abs(mine[k] - ref[k]) for k in ref) < tol


def test_detect_accepts_numpy_gray_and_small_images(cascade):
    gray = np.array(jio.read(os.path.join(DATA, "crop120.png"),
                             jio.IO_GRAY).numpy())
    got = tscd.detect(gray, cascade, tscd.ScdParams(min_neighbors=0,
                                                    interval=1),
                      device="cpu")
    want = tscd.detect(torch.from_numpy(gray)[..., None], cascade,
                       tscd.ScdParams(min_neighbors=0, interval=1))
    assert got == want and len(got) > 0
    assert tscd.detect(gray[:40, :40], cascade, device="cpu") == []
    # a cascade wider than params.size scales the image up (INTER_CUBIC):
    # the 48x48 cascade then finds objects down to 24x24
    up = tscd.ScdParams(size=(24, 24), min_neighbors=0, interval=1)
    got = tscd.detect(gray, cascade, up, device="cpu")
    assert got == tscd.detect(torch.from_numpy(gray), cascade, up)
    assert min(c.width for c in got) == min(c.height for c in got) == 24
    assert len(got) > len(want)
