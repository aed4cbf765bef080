"""Port parity on the CPU: random ferns and the TLD tracker
(ccv_tpu_torch/detectors/ferns.py, tld.py) against ccv_tpu.

Ferns: one seed gives identical points; features, posterior updates and
predictions are identical. TLD: 4 frames of 288x216 cut from text_test.png
with crop180.png's face region (60 x 80) pasted as the target at known
shifts (a target on self-similar texture cannot be told apart by any
detector, tests/test_tld.py says why); one seed, default TldParams. Gate:
each frame's box within 1 px of ccv_tpu's, confidence within 1e-3, and the
track within IoU 0.7 of the known box.

The posteriors themselves may differ after training: ccv_tpu warps its
deformed training patches under ``jax.jit``, whose fused arithmetic rounds
the bilinear sums of saturated (255) regions either way at the integer, so
a few fern bits differ from the port's eager warp (which equals ccv_tpu's
``perspective_transform`` called eagerly).
"""

import os

import numpy as np
import pytest
import torch

from ccv_tpu.core.io import IO_GRAY, read
from ccv_tpu.detectors import ferns as jferns
from ccv_tpu.detectors import tld as jtld
from ccv_tpu_torch.detectors import ferns, tld

DATA = os.path.join(os.path.dirname(__file__), "data")
SHIFTS = [(0, 0), (4, 3), (8, 5), (11, 9)]
BOX0 = (80, 50, 60, 80)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def make_frames(h=216, w=288):
    bg = np.asarray(read(os.path.join(DATA, "text_test.png"),
                         IO_GRAY).numpy())
    target = np.asarray(read(os.path.join(DATA, "crop180.png"),
                             IO_GRAY).numpy())[40:120, 50:110]
    frames = []
    for dx, dy in SHIFTS:
        f = bg[100:100 + h, 150:150 + w].copy()
        f[BOX0[1] + dy:BOX0[1] + dy + 80, BOX0[0] + dx:BOX0[0] + dx + 60] = \
            target
        frames.append(f)
    return frames


@pytest.fixture(scope="module")
def frames():
    return make_frames()


@pytest.fixture(scope="module")
def ccv_tpu_track(frames):
    """ccv_tpu's (box, confidence) per tracked frame, and its tracker."""
    t = jtld.Tld(frames[0], BOX0, seed=7)
    out = [t.track_object(frames[i - 1], frames[i], jtld.TldInfo())
           for i in range(1, len(frames))]
    return out, t


def test_ferns_match():
    sizes = [(20, 20), (24, 30)]
    want = jferns.ferns_new(12, 9, sizes, seed=4)
    got = ferns.ferns_new(12, 9, sizes, seed=4)
    assert np.array_equal(got.points, want.points)
    rng = np.random.default_rng(1)
    for k in range(400):
        patch = rng.integers(0, 256, (30, 24)).astype(np.uint8)
        s = k % 2
        f_want = jferns.ferns_feature(want, patch, s)
        f_got = ferns.ferns_feature(got, torch.from_numpy(patch), s)
        assert np.array_equal(f_got, f_want)
        assert ferns.ferns_predict(got, f_got) == \
            jferns.ferns_predict(want, f_want)
        c = int(k % 3 == 0)
        jferns.ferns_correct(want, f_want, c, k % 2)
        ferns.ferns_correct(got, f_got, c, k % 2)
    assert np.array_equal(got.posterior, want.posterior)
    assert np.array_equal(got.rnum, want.rnum)
    assert np.array_equal(got.cnum, want.cnum)


def iou(a, b):
    ix = max(0, min(a[0] + a[2], b[0] + b[2]) - max(a[0], b[0]))
    iy = max(0, min(a[1] + a[3], b[1] + b[3]) - max(a[1], b[1]))
    inter = ix * iy
    return inter / (a[2] * a[3] + b[2] * b[3] - inter)


def test_tld_tracks_as_ccv_tpu(frames, ccv_tpu_track):
    want, jt = ccv_tpu_track
    t = tld.Tld(torch.from_numpy(frames[0]), BOX0, seed=7)
    assert t.device == torch.device("cpu")
    assert t.patch == jt.patch and np.array_equal(t.grid, jt.grid)
    assert t.var_thres == jt.var_thres
    for i in range(1, len(frames)):
        box, conf = t.track_object(frames[i - 1], torch.from_numpy(frames[i]))
        wbox, wconf = want[i - 1]
        assert box is not None and wbox is not None, i
        assert max(abs(a - b) for a, b in zip(box, wbox)) <= 1, (i, box, wbox)
        assert abs(conf - wconf) <= 1e-3, (i, conf, wconf)
        dx, dy = SHIFTS[i]
        assert iou(box, (BOX0[0] + dx, BOX0[1] + dy, 60, 80)) >= 0.7, (i, box)


def test_tld_needs_a_card_unless_asked(frames, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device is required"):
        tld.Tld(frames[0], BOX0)
