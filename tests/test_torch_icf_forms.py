"""Port parity: ICF's fused octave forms (``form="slices"``, ccv_tpu's takes
form, and ``form="matmul"``, its im2col form) against ccv_tpu's with its
module switches set (``ICF_FUSED = "1"``, ``ICF_FORM``), on the CPU, and
against the port's default staged form.

A seeded 400-tree colour cascade (tests/test_torch_icf.py's generator) on a
150 x 120 crop of crop180.png, its thresholds graded over the running sums
at four trees (30, 150, 300, 380) so that windows die in trees 0-63,
64-319 and 320-399 and few enough survive tree 319 that no octave overflows
a capacity (no rerun hides a form). Gate as in tests/test_torch_icf.py: windows whose running sum lies
within 1e-4 * max(1, |sum|) of a threshold may differ, every other window
passes or fails alike, confidences within 2e-4.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from ccv_tpu.core.io import IO_RGB_COLOR, read
from ccv_tpu.detectors import icf as jicf
from ccv_tpu_torch.detectors import icf

import test_torch_icf as base

DATA = os.path.join(os.path.dirname(__file__), "data")
TREES = 400
# (tree, share of the windows alive before it that it keeps)
CUTS = ((30, 0.2), (150, 0.25), (300, 0.35), (380, 0.5))


def cut_thresholds(cs, cuts=CUTS):
    """Thresholds open (-1e9) but at the trees of ``cuts``, each in the
    middle of a gap at least 8 * MARGIN wide between the alive windows'
    running sums there, the one keeping the share nearest the given."""
    th = np.full(cs.shape[1], -1e9, np.float32)
    alive = np.ones(len(cs), bool)
    for t, keep in cuts:
        v = np.sort(cs[alive, t])
        u = np.unique(v)
        mids = (u[1:] + u[:-1]) / 2
        wide = (u[1:] - u[:-1]) > 8 * base.MARGIN * np.maximum(1,
                                                               np.abs(mids))
        share = 1 - np.searchsorted(v, mids) / len(v)
        th[t] = mids[int(np.argmin(np.where(wide, np.abs(share - keep),
                                            np.inf)))]
        alive &= cs[:, t] >= th[t]
    return th


@pytest.fixture(autouse=True, scope="module")
def _one_thread_plain_sat():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    mp = pytest.MonkeyPatch()
    mp.setenv("CCV_TPU_SAT", "sat")
    yield
    mp.undo()
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def graded():
    """(ccv_tpu cascade, the port's, running sums of every window, crop)."""
    crop = np.ascontiguousarray(np.array(read(os.path.join(
        DATA, "crop180.png"), IO_RGB_COLOR).array)[:150, :120])
    params = jicf.IcfParams(min_neighbors=0, interval=1)
    casc = base.synth_cascade(np.random.default_rng(11), TREES, False)
    cs = np.stack(list(base.window_sums(crop, casc, params).values()))
    casc = dataclasses.replace(casc, thresholds=cut_thresholds(cs))
    return (casc, icf.cascade_from_jax(casc),
            base.window_sums(crop, casc, params), crop)


@pytest.fixture(scope="module")
def ccv_tpu_forms(graded):
    """ccv_tpu's detect_objects in each fused form, at min_neighbors 0 (the
    windows) and 2 (the default grouping)."""
    casc, _p, _s, crop = graded
    out = {}
    mp = pytest.MonkeyPatch()
    mp.setattr(jicf, "ICF_FUSED", "1")
    try:
        for form in ("slices", "matmul"):
            mp.setattr(jicf, "ICF_FORM", form)
            for mn in (0, 2):
                out[form, mn] = jicf.detect_objects(
                    crop, casc, jicf.IcfParams(min_neighbors=mn, interval=1))
    finally:
        mp.undo()
    return out


def _detect(graded, form, **kw):
    _c, port, _s, crop = graded
    return icf.detect_objects(torch.from_numpy(crop), port, icf.IcfParams(
        interval=1, **kw), form=form)


@pytest.mark.parametrize("form", ["slices", "matmul"])
def test_fused_form_matches_ccv_tpu(graded, ccv_tpu_forms, form):
    casc, port, sums, crop = graded
    before = icf.RERUNS
    handle = icf.detect_async(torch.from_numpy(crop), port, icf.IcfParams(
        min_neighbors=0, interval=1), form=form)
    got = icf.detect_collect(handle)
    assert icf.RERUNS == before, "an octave overflowed: no fused rows read"
    assert [s[3] for s in handle.specs] == [form] * len(handle.specs)
    # windows die in every block and some pass all the trees
    ok = np.stack([np.minimum.accumulate(s >= casc.thresholds)
                   for s in sums.values()])
    for lo, hi in ((0, 64), (64, 320), (320, TREES)):
        assert (ok[:, lo - 1].sum() if lo else len(ok)) > ok[:, hi - 1].sum()
    n = base.assert_windows_agree(got, ccv_tpu_forms[form, 0],
                                  base.near(sums, casc.thresholds))
    assert n == ok[:, -1].sum() > 10


@pytest.mark.parametrize("form", ["slices", "matmul"])
def test_fused_form_grouped_matches_ccv_tpu(graded, ccv_tpu_forms, form):
    """At the default grouping: the same rects in the same order (the fused
    forms list windows by score, which the grouping's order follows) and
    neighbors, confidences within 2e-4."""
    got = _detect(graded, form)
    want = ccv_tpu_forms[form, 2]
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g.x, g.y, g.width, g.height, g.neighbors) == \
            (w.x, w.y, w.width, w.height, w.neighbors)
        assert abs(g.confidence - w.confidence) <= base.ATOL


@pytest.mark.parametrize("form", ["slices", "matmul"])
def test_fused_form_equals_default_form(graded, form):
    """The fused forms pass the staged form's windows, confidences within
    2e-4 (trees 0-319 are one scan in the fused forms, two in the staged
    one)."""
    _c, _p, sums, _crop = graded
    base.assert_windows_agree(_detect(graded, form, min_neighbors=0),
                              _detect(graded, "staged", min_neighbors=0),
                              base.near(sums, graded[0].thresholds))


def test_forms_checked_and_overflow_reruns(graded, monkeypatch):
    """An unknown form raises; an octave whose survivors overflow the fused
    form's capacity runs again at full capacity and loses no window."""
    with pytest.raises(ValueError, match="form"):
        _detect(graded, "pallas")
    want = _detect(graded, "staged", min_neighbors=0)
    monkeypatch.setattr(icf, "_icf_slice_caps",
                        lambda ntot, n_weak: (ntot, 1))
    before = icf.RERUNS
    got = _detect(graded, "slices", min_neighbors=0)
    assert icf.RERUNS > before
    assert base.as_dict(got) == base.as_dict(want)


def test_sat_auto_takes_sat_on_the_cpu(graded, monkeypatch):
    """The ICF SAT call sites take sat_auto: on a CPU tensor that is
    ``sat`` and records nothing."""
    from ccv_tpu_torch.core import algebra
    from ccv_tpu_torch.nn import autotune
    monkeypatch.delenv("CCV_TPU_SAT", raising=False)
    monkeypatch.setenv("CCV_TPU_AUTOTUNE_CACHE", "/nonexistent/at.json")
    monkeypatch.setattr(autotune, "_MEM", None)
    calls = []
    auto = algebra.sat_auto

    def spy(a, padding=algebra.NO_PADDING):
        calls.append(tuple(a.shape))
        return auto(a, padding)

    monkeypatch.setattr(algebra, "sat_auto", spy)
    got = _detect(graded, "staged", min_neighbors=0)
    assert calls and got
    assert autotune.decisions() == {}
