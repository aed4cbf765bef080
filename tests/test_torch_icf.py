"""Port parity: ICF detection (ccv_tpu_torch/detectors/icf.py) against
ccv_tpu's staged per-level path on the CPU (``ICF_FUSED = "0"``, the SAT
forced to ``sat``), on crop180.png with seeded synthetic cascades.

The cascades hold 400 depth-2 trees over a 32 x 80 window with a margin
(an effective 25 x 76, the size of the trained pedestrian.icf), so phases A
(trees 0-63), B1 (64-319) and B2 (320-399) all run; their thresholds are
set from the port's running sums over the level-0 windows so that windows
die in every phase. The trained pedestrian.icf is not in the repository.

Gate, per the staged SCD parity tests: windows whose running sum at some
tree lies within 1e-4 * max(1, |sum|) of that tree's threshold may pass on
one side only; every other window passes or fails alike, and confidences
where both pass agree within 2e-4. Grouped output at default params: the
same rects in the same order, confidences within 2e-4.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccv_tpu.core.io import IO_RGB_COLOR, read
from ccv_tpu.detectors import icf as jicf
from ccv_tpu.train import icf as jtrain
from ccv_tpu_torch.core import algebra
from ccv_tpu_torch.detectors import icf

DATA = os.path.join(os.path.dirname(__file__), "data")
MARGIN = 1e-4
ATOL = 2e-4
TREES = 400
INTERVAL = 1


@pytest.fixture(autouse=True, scope="module")
def _ccv_tpu_staged_cpu_form():
    """One torch intra-op thread (the suite runs several workers), and
    ccv_tpu's staged per-level form with the plain cumsum SAT."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    mp = pytest.MonkeyPatch()
    mp.setattr(jicf, "ICF_FUSED", "0")
    mp.setenv("CCV_TPU_SAT", "sat")
    yield
    mp.undo()
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def crop():
    return np.array(read(os.path.join(DATA, "crop180.png"),
                         IO_RGB_COLOR).array)


def synth_cascade(rng, n, gray, w=32, h=80, margin=(3, 2, 4, 2)):
    """A ccv_tpu IcfCascade of n random depth-2 trees, thresholds open."""
    nch = 8 if gray else 10
    x0 = rng.integers(0, w - 4, (n, 3, 2))
    y0 = rng.integers(0, h - 4, (n, 3, 2))
    x1 = np.minimum(x0 + rng.integers(1, 12, (n, 3, 2)), w - 1)
    y1 = np.minimum(y0 + rng.integers(1, 24, (n, 3, 2)), h - 1)
    alpha = rng.normal(0, 1, (n, 3, 2)) / ((x1 - x0 + 1) * (y1 - y0 + 1))
    alpha[:, :, 1] *= rng.integers(0, 2, (n, 3))  # one box or two
    return jicf.IcfCascade(
        width=w, height=h, grayscale=int(gray), margin=margin, n_weak=n,
        pass_bits=rng.integers(0, 4, n).astype(np.uint32),
        weigh=rng.normal(0, 1, (n, 2)).astype(np.float32),
        thresholds=np.full(n, -1e9, np.float32),
        channel=rng.integers(0, nch, (n, 3, 2)).astype(np.int32),
        alpha=alpha.astype(np.float32),
        beta=rng.normal(0, 0.5, (n, 3)).astype(np.float32),
        sat0=np.stack([x0, y0], -1).astype(np.int32),
        sat1=np.stack([x1, y1], -1).astype(np.int32))


def window_sums(img, casc, params):
    """{rect: running sums (n_weak,)} of every window of every level, by
    the port's SAT and trees (one scan over all trees)."""
    port = icf.cascade_from_jax(casc)
    a = torch.from_numpy(img)
    pyr, out = [a], {}
    eff_w = port.width - port.margin[0] - port.margin[2]
    eff_h = port.height - port.margin[1] - port.margin[3]
    n_oct = int(np.log2(min(a.shape[0] / eff_h, a.shape[1] / eff_w))) + 1
    from ccv_tpu_torch.ops import resample
    for _ in range(1, n_oct):
        pyr.append(resample.sample_down(pyr[-1]))
    full = icf._tables(port, a.device)["full"]
    step = params.step_through
    for octave, level in enumerate(pyr):
        lvls = icf._octave_levels(level.shape, port, params)
        if not lvls:
            continue
        flat, base, W1, C = icf._octave_windows(level, port, lvls, step)
        sums = algebra.tiled_cumsum(icf._node_votes(
            icf._gather(flat, base, full, W1, C), full), -1).numpy()
        g = 0
        for (_k, scale, _r, _c, ny, nx) in lvls:
            sc = scale * (1 << octave)
            for wy in range(ny):
                for wx in range(nx):
                    rect = (int((wx * step + 0.5) * sc - 0.5),
                            int((wy * step + 0.5) * sc - 0.5),
                            int(eff_w * sc), int(eff_h * sc))
                    out[rect] = sums[g]
                    g += 1
    return out


def graded_thresholds(cs, survive=((64, 0.08), (320, 0.01), (None, 0.003))):
    """Per-tree thresholds over running sums cs (windows, trees): each sits
    in the middle of a gap between two distinct sums of the windows alive
    so far, killing about the share that leaves ``survive`` (survivor
    fractions at the end of phases A, B1 and B2) by geometric attrition."""
    n, T = cs.shape
    alive = np.ones(n, bool)
    th = np.full(T, -1e9, np.float32)
    lo = 0
    for hi, frac in survive:
        hi = T if hi is None else hi
        start = alive.mean()
        kill = 1 - (frac / start) ** (1 / max(1, hi - lo))
        for t in range(lo, hi):
            v = cs[alive, t]
            if len(v) < 30:
                break
            u = np.unique(v)
            mids = (u[1:] + u[:-1]) / 2
            wide = (u[1:] - u[:-1]) > 8 * MARGIN * np.maximum(1, np.abs(mids))
            if not wide.any():
                continue
            share = np.searchsorted(np.sort(v), mids) / len(v)
            cost = np.where(wide, np.abs(share - kill), np.inf)
            i = int(np.argmin(cost))
            if share[i] <= 3 * kill:
                th[t] = mids[i]
                alive &= cs[:, t] >= th[t]
        lo = hi
    return th


def near(sums, th):
    """Rects whose running sum at some tree is within the margin of it."""
    return {r for r, s in sums.items()
            if np.any(np.abs(s - th) <= MARGIN * np.maximum(1, np.abs(s)))}


@pytest.fixture(scope="module")
def graded(crop):
    """Per kind, (ccv_tpu cascade with graded thresholds, running sums of
    every window, the image it runs on)."""
    out = {}
    params = jicf.IcfParams(min_neighbors=0, interval=INTERVAL)
    for kind, seed, gray, img in (
            ("colour", 0, False, crop), ("gray", 1, True, crop),
            ("gray-image", 2, True, np.ascontiguousarray(crop[..., 1]))):
        casc = synth_cascade(np.random.default_rng(seed), TREES, gray)
        img3 = img if img.ndim == 3 else img[..., None]
        base = {r: s for r, s in window_sums(img3, casc, params).items()
                if r[2] == 25}  # level 0
        cs = np.stack(list(base.values()))
        casc = dataclasses.replace(casc, thresholds=graded_thresholds(cs))
        out[kind] = (casc, window_sums(img3, casc, params), img)
    return out


def as_dict(comps):
    d = {}
    for c in comps:
        d.setdefault((int(c.x), int(c.y), int(c.width), int(c.height)),
                     []).append(float(c.confidence))
    return d


def assert_windows_agree(mine, ref, may_differ):
    m, r = as_dict(mine), as_dict(ref)
    odd = set(m) ^ set(r)
    assert odd <= may_differ, sorted(odd - may_differ)[:10]
    both = set(m) & set(r)
    assert both, "no window passed on both sides: the comparison is vacuous"
    for k in both:
        assert len(m[k]) == len(r[k]), k
        for a, b in zip(sorted(m[k]), sorted(r[k])):
            assert abs(a - b) <= ATOL, (k, a, b)
    return len(both)


@pytest.mark.parametrize("kind", ["colour", "gray", "gray-image"])
def test_staged_windows_match_ccv_tpu(graded, kind):
    casc, sums, img = graded[kind]
    th = casc.thresholds
    # windows end in every phase: some die in A, some in B1, some in B2,
    # and some pass all 400 trees
    ok = np.stack([np.minimum.accumulate(s >= th) for s in sums.values()])
    for lo, hi in ((0, 64), (64, 320), (320, TREES)):
        entering = ok[:, lo - 1].sum() if lo else len(ok)
        assert entering > ok[:, hi - 1].sum(), \
            f"no window died in trees {lo}-{hi - 1}"
    assert ok[:, -1].sum() > 0
    params = jicf.IcfParams(min_neighbors=0, interval=INTERVAL)
    want = jicf.detect_objects(img, casc, params)
    got = icf.detect_objects(torch.from_numpy(img),
                             icf.cascade_from_jax(casc),
                             icf.IcfParams(min_neighbors=0,
                                           interval=INTERVAL))
    assert_windows_agree(got, want, near(sums, th))


@pytest.mark.parametrize("gray", [True, False], ids=["gray", "colour"])
def test_open_thresholds_rerun_every_octave(crop, gray):
    """Thresholds open: every window survives phase A, more than K1 holds,
    so each octave runs again at full capacity and loses no window.

    Gray channels are ccv_tpu's to the bit, so every window's confidence
    agrees. Colour's L, U and V differ from ccv_tpu's compiled ones by an
    ulp here and there (XLA's cube root; the port keeps SCD's table), the
    SAT turns that into corner differences of up to an ulp of the SAT
    (1.0 at 1e7), and a tree node within that of 0 votes the other way in
    one of 400 trees x 5,613 windows: at most 1% of the confidences may
    differ there, each by one or more whole votes."""
    casc = synth_cascade(np.random.default_rng(3), TREES, gray)
    params = jicf.IcfParams(min_neighbors=0, interval=INTERVAL)
    want = jicf.detect_objects(crop, casc, params)
    before = icf.RERUNS
    handle = icf.detect_async(torch.from_numpy(crop),
                              icf.cascade_from_jax(casc),
                              icf.IcfParams(min_neighbors=0,
                                            interval=INTERVAL))
    got = icf.detect_collect(handle)
    assert icf.RERUNS - before == len(handle.specs) == 2
    assert len(got) == len(want) == 5613
    m, r = as_dict(got), as_dict(want)
    assert set(m) == set(r)
    bad = [k for k in m if abs(m[k][0] - r[k][0]) > ATOL]
    assert len(bad) <= (0 if gray else 0.01 * len(m)), len(bad)


@pytest.mark.parametrize("gray", [False, True])
def test_cascade_files_round_trip(tmp_path, gray):
    casc = synth_cascade(np.random.default_rng(4), 50, gray)
    casc.thresholds[:] = np.random.default_rng(5).normal(0, 1, 50)
    port = icf.cascade_from_jax(casc)
    icf.write_cascade(port, str(tmp_path / "port.icf"))
    jtrain.write_cascade(casc, str(tmp_path / "jax.icf"))
    assert (tmp_path / "port.icf").read_text() == \
        (tmp_path / "jax.icf").read_text()
    for back in (icf.load_cascade(str(tmp_path / "port.icf")),
                 icf.load_cascade(str(tmp_path / "jax.icf"))):
        ref = jicf.load_cascade(str(tmp_path / "jax.icf"))
        for f in dataclasses.fields(back):
            a, b = getattr(back, f.name), getattr(ref, f.name)
            if isinstance(a, np.ndarray):
                assert a.dtype == np.asarray(b).dtype, f.name
                np.testing.assert_array_equal(a, b, err_msg=f.name)
            else:
                assert tuple(np.atleast_1d(a)) == tuple(np.atleast_1d(b)), \
                    f.name


@pytest.mark.parametrize("kind", ["colour", "gray"])
def test_icf_channels(crop, kind):
    img = crop if kind == "colour" else np.ascontiguousarray(crop[..., 0])
    want = np.asarray(jicf.icf_channels(jnp.asarray(img)))
    got = icf.icf_channels(torch.from_numpy(img)).numpy()
    assert got.shape == want.shape == img.shape[:2] + (
        (10,) if kind == "colour" else (8,))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_async_collect_equals_detect(graded):
    casc, _sums, img = graded["colour"]
    port = icf.cascade_from_jax(casc)
    params = icf.IcfParams(min_neighbors=0, interval=INTERVAL)
    a = torch.from_numpy(img)
    h1, h2 = icf.detect_async(a, port, params), icf.detect_async(a, port,
                                                                 params)
    assert as_dict(icf.detect_collect(h2)) == as_dict(
        icf.detect_collect(h1)) == as_dict(icf.detect_objects(a, port,
                                                              params))


def test_needs_a_card_unless_asked(graded, monkeypatch):
    casc, _sums, img = graded["colour"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device is required"):
        icf.detect_objects(img, icf.cascade_from_jax(casc))
    assert icf.detect_objects(img, icf.cascade_from_jax(casc),
                              device="cpu") is not None
