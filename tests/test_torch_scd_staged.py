"""Port parity: the staged SCD cascade (``form="pallas"``: phases A and B1
through kernel K3's wrapper, phase B2 on the first K2 survivors, the host's
overflow rerun) and ``detect_batch`` in both forms, against
ccv_tpu on the same inputs and against the C goldens.

Per level, survivor sets must agree wherever every stage sum is more than
1e-4 from its threshold; confidences where both pass agree to atol=2e-4,
rtol=1e-5. End to end, detections agree as in tests/test_torch_scd.py:
same boxes in the same order, confidences within 6e-3 (ccv_tpu's CPU path
sums boxes by a matmul).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccv_tpu.core import io as jio
from ccv_tpu.detectors import scd as jscd
from ccv_tpu_torch.core import io as tio
from ccv_tpu_torch.detectors import scd as tscd
from ccv_tpu_torch.ops import resample as tresample
from ccv_tpu_torch.ops.kernels import scd_cascade as tkernel
from ccv_tpu_torch.ops.kernels import scd_phase as tphase

DATA = os.path.join(os.path.dirname(__file__), "data")
CASCADE = os.path.join(DATA, "face_low.sqlite3")
STEP = 4
MARGIN = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch intra-op thread while this module runs. The suite runs in
    several worker processes on the CPU, and torch's OpenMP threads in each
    of them oversubscribe the cores: six workers of eight threads made a
    staged detect of crop180 over 100x slower than one thread each."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _port(jcascade):
    return tscd.cascade_from_numpy(
        {f.name: getattr(jcascade, f.name)
         for f in dataclasses.fields(jcascade)})


def _synth_cascade(rng, feats_per_stage, wh=24):
    F = sum(feats_per_stage)
    sx = rng.integers(0, wh - 6, (F, 4)).astype(np.int32)
    sy = rng.integers(0, wh - 6, (F, 4)).astype(np.int32)
    n_stages = len(feats_per_stage)
    return jscd.ScdClassifierCascade(
        width=wh, height=wh, margin=(0, 0, 0, 0),
        stage_counts=np.asarray(feats_per_stage, np.int32),
        thresholds=np.zeros(n_stages, np.float32), sx=sx, sy=sy,
        dx=(sx + rng.integers(2, 7, (F, 4))).astype(np.int32),
        dy=(sy + rng.integers(2, 7, (F, 4))).astype(np.int32),
        bias=rng.normal(0, 0.5, F).astype(np.float32),
        w=rng.normal(0, 1, (F, 32)).astype(np.float32),
        stage_of=np.repeat(np.arange(n_stages),
                           feats_per_stage).astype(np.int32))


def _by_rect(comps):
    return {(c.x, c.y, c.width, c.height): c.confidence for c in comps}


def _golden(name):
    ref = {}
    with open(os.path.join(DATA, name)) as f:
        for line in f:
            x, y, w, h, conf = line.split()
            ref[(int(x), int(y), int(w), int(h))] = float(conf)
    return ref


def _assert_same_detections(got, want, tol=6e-3):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g.x, g.y, g.width, g.height, g.neighbors) == \
            (w.x, w.y, w.width, w.height, w.neighbors)
        assert abs(g.confidence - w.confidence) < tol


@pytest.fixture(scope="module")
def crop():
    return tio.read(os.path.join(DATA, "crop180.png"), tio.IO_RGB_COLOR,
                    device="cpu")


@pytest.fixture(scope="module")
def face():
    return tscd.load_cascade(CASCADE)


# -- the phase split and the capacities ------------------------------------

SPLITS = {"face_low": (4, 4, 4, 49, 89, 168), "a_only": (2, 3, 4, 5),
          "stage0_over_16": (20, 3, 4), "a_b1": (3, 4, 5, 30),
          "b1_over_64": (5, 70), "b1_b2": (8, 8, 30, 30, 9, 40),
          "one_stage": (7,)}


@pytest.mark.parametrize("counts", list(SPLITS.values()), ids=list(SPLITS))
def test_phase_split_matches_jax(counts):
    jc = _synth_cascade(np.random.default_rng(1), counts)
    want = jscd._cascade_tables(jc)
    got = tscd.staged_tables(_port(jc))
    for name in ("phase_a", "phase_b1", "phase_b2"):
        w, g = want[name], getattr(got, name)
        assert (w is None) == (g is None), name
        if w is None:
            continue
        np.testing.assert_array_equal(g.w, np.asarray(w["w"]), name)
        np.testing.assert_array_equal(g.bias, np.asarray(w["bias"]), name)
        np.testing.assert_array_equal(g.thresholds,
                                      np.asarray(w["thresholds"]), name)
        np.testing.assert_array_equal(
            [f1 - f0 for f0, f1 in g.stage_ranges],
            np.asarray(w["onehot"]).sum(axis=0), name)
    assert got.last_count == want["last_count"]
    if counts == SPLITS["face_low"]:
        assert [t.n_features for t in (got.phase_a, got.phase_b1,
                                       got.phase_b2)] == [12, 49, 257]
        assert [t.n_stages for t in (got.phase_a, got.phase_b1,
                                     got.phase_b2)] == [3, 1, 2]


@pytest.mark.parametrize("nwin", [1, 64, 700, 1089, 4000, 6000, 14520,
                                  120744])
@pytest.mark.parametrize("counts", ["face_low", "a_only", "a_b1"])
def test_capacities_match_jax(nwin, counts, monkeypatch):
    jc = _synth_cascade(np.random.default_rng(1), SPLITS[counts])
    jtabs = jscd._cascade_tables(jc)
    tabs = tscd.staged_tables(_port(jc))
    assert tscd._level_capacity(nwin) == jscd._level_capacity(nwin)
    K2 = tscd._level_capacity2(nwin)
    assert K2 == jscd._level_capacity2(nwin) <= nwin
    # the port runs B1 densely, as ccv_tpu does on the accelerator
    monkeypatch.setattr(jscd.jax, "default_backend", lambda: "tpu")
    assert tscd._out_len(tabs, nwin, K2) == jscd._out_len(jtabs, nwin, K2)


@pytest.mark.parametrize("counts", ["face_low", "a_only", "a_b1", "b1_b2"])
def test_staged_eval_runs_each_dense_phase_through_phase_a(counts):
    """Phases A and B1 both go through the ``phase_a`` callable (K3 on the
    card), in that order, with the same planes (none on the CPU); a cascade
    with no B1 calls it once."""
    cascade = _port(_synth_cascade(np.random.default_rng(3), SPLITS[counts]))
    tabs = tscd.staged_tables(cascade)
    calls = []

    def counting(sat_l, tables, step, dims, planes=None):
        calls.append((tables, planes))
        return tphase.phase_a(sat_l, tables, step, dims, planes=planes)

    dims = np.array([[5, 7]])
    sat = torch.from_numpy(np.random.default_rng(4).normal(
        0, 10, (1, 8, 4 * STEP + 25, 6 * STEP + 25)).astype(np.float32))
    tscd._staged_eval(sat, dims, tabs, STEP, [35], counting)
    want = [t for t in (tabs.phase_a, tabs.phase_b1) if t is not None]
    assert len(calls) == len(want) == (1 if counts == "a_only" else 2)
    assert all(got is w and planes is None
               for (got, planes), w in zip(calls, want))


# -- one level at full capacity against ccv_tpu's level program -------------

def _gap_thresholds(vs, ny, nx, share=0.7):
    """Per stage, a threshold in a gap of at least 4 * MARGIN between the
    level's distinct stage sums, the one whose pass share is nearest
    ``share``."""
    th = []
    for s in range(vs.shape[1]):
        vals = vs[0, s, :ny, :nx].reshape(-1).sort().values
        u = torch.unique(vals)
        mids, gaps = (u[1:] + u[:-1]) / 2, u[1:] - u[:-1]
        frac = 1 - torch.searchsorted(vals, mids, right=True) / vals.numel()
        score = torch.where(gaps > 4 * MARGIN, (frac - share).abs(), 2.0)
        th.append(float(mids[int(score.argmin())]))
    return np.asarray(th, np.float32)


def _level_sums(cascade, src, spec):
    (_o, k, rows, cols, ny, nx, _s) = spec
    sat = tscd._octave_sats(src[None], [(k, rows, cols, ny, nx)],
                            cascade.margin)
    return tkernel.cascade_stage_sums_ref(sat, tscd.cascade_tables(cascade),
                                          STEP, [[ny, nx]])


def _jax_level(jc, src, spec):
    (_o, k, rows, cols, ny, nx, _s) = spec
    tabs = jscd._cascade_tables(jc)
    fn = jscd._get_level_fn(tuple(src.shape), rows, cols, ny, nx, k == 0,
                            jc, STEP, tabs, K2=ny * nx, K1=ny * nx)
    return jax.device_get(fn(src, tabs["last_count"]))


LEVEL_CASES = {
    # (cascade, spec indices into crop180's default-params plan)
    "face_a_b1_b2": ("face", (0, 1, 6)),
    "a_only": ((2, 3, 4, 5), (0,)),
    "a_b1": ((3, 4, 5, 30), (2,)),
}


@pytest.mark.parametrize("which,levels", list(LEVEL_CASES.values()),
                         ids=list(LEVEL_CASES))
def test_staged_level_matches_jax(crop, which, levels):
    """Survivors and conf of single levels, the port's staged level at full
    capacity against ccv_tpu's level program as its overflow rerun runs it
    (K2 = K1 = every window, so its CPU sparse B1 cannot overflow). The
    stage thresholds sit in gaps between the first level's stage sums."""
    if which == "face":
        jc = jscd.load_cascade(CASCADE)
    else:
        jc = _synth_cascade(np.random.default_rng(4), which)
    img = crop.tensor
    specs, _ = tscd._level_specs(180, 180, _port(jc), tscd.ScdParams())
    srcs = [img, tresample.sample_down(img)]
    spec0 = specs[levels[0]]
    vs0 = _level_sums(_port(jc), srcs[spec0[0]], spec0)
    jc.thresholds[:] = _gap_thresholds(vs0, *spec0[4:6])
    cascade = _port(jc)
    n_phases = sum(p is not None for p in dataclasses.astuple(
        tscd.staged_tables(cascade))[:3])
    assert n_phases == {"face": 3, (2, 3, 4, 5): 1,
                        (3, 4, 5, 30): 2}[which]
    for li in levels:
        spec = specs[li]
        src = srcs[spec[0]]
        idx, passed, conf, count2 = tscd.staged_level(
            src, spec, cascade, tscd.ScdParams())
        jidx, jpassed, jconf, jcount2 = _jax_level(
            jc, jnp.asarray(src.numpy()), spec)
        ny, nx = spec[4:6]
        assert len(idx) == ny * nx
        vs = _level_sums(cascade, src, spec)[0, :, :ny, :nx].reshape(
            len(jc.thresholds), -1).numpy()
        near = (np.abs(vs - jc.thresholds[:, None]) <= MARGIN).any(axis=0)
        mine = dict(zip(idx[passed].tolist(), conf[passed].tolist()))
        want = dict(zip(np.asarray(jidx)[jpassed].tolist(),
                        np.asarray(jconf)[jpassed].tolist()))
        assert mine and len(mine) < ny * nx, "a vacuous comparison"
        assert {i for i in set(mine) ^ set(want) if not near[i]} == set()
        both = sorted(set(mine) & set(want))
        np.testing.assert_allclose([mine[i] for i in both],
                                   [want[i] for i in both], atol=2e-4,
                                   rtol=1e-5)
        if not near.any():
            np.testing.assert_array_equal(count2, jcount2)


# -- detect(form="pallas") end to end ---------------------------------------

@pytest.fixture(scope="module")
def jax_detections():
    img = jio.read(os.path.join(DATA, "crop180.png"), jio.IO_RGB_COLOR)
    jc = jscd.load_cascade(CASCADE)
    return {mn: jscd.detect(img.array, jc, jscd.ScdParams(
        min_neighbors=mn, interval=1)) for mn in (0, 1)}


@pytest.mark.parametrize("min_neighbors", [0, 1])
def test_detect_staged_matches_jax(crop, face, jax_detections,
                                   min_neighbors):
    got = tscd.detect(crop, face, tscd.ScdParams(
        min_neighbors=min_neighbors, interval=1), form="pallas")
    _assert_same_detections(got, jax_detections[min_neighbors])


@pytest.mark.parametrize("interval,golden,tol", [
    (1, "crop180.scd_i1.txt", 6e-3), (5, "crop180.scd_open.txt", 2e-2)])
def test_staged_window_parity_with_c_goldens(crop, face, interval, golden,
                                             tol, monkeypatch):
    """face_low's thresholds are all -1000: every window survives, every
    level overflows K2 and is rerun at full capacity."""
    reruns = []
    staged_level = tscd.staged_level

    def counting(*args, **kwargs):
        reruns.append(args[1])
        return staged_level(*args, **kwargs)

    monkeypatch.setattr(tscd, "staged_level", counting)
    params = tscd.ScdParams(min_neighbors=0, interval=interval)
    out = tscd.detect(crop, face, params, form="pallas")
    mine, ref = _by_rect(out), _golden(golden)
    assert set(mine) == set(ref), (len(mine), len(ref))
    assert max(abs(mine[k] - ref[k]) for k in ref) < tol
    specs = tscd._level_specs(180, 180, face, params)[0]
    want = [s for s in specs if s[4] * s[5] > tscd._level_capacity2(
        s[4] * s[5])]
    assert reruns == want and len(want) > 0


def test_forced_overflow_gives_the_same_detections(crop, monkeypatch):
    """Thresholds in gaps between stage sums leave few survivors, so the
    levels fit K2; with K2 patched down to 1 every level with more than one
    survivor is rerun, and the detections do not change."""
    jc = jscd.load_cascade(CASCADE)
    specs, _ = tscd._level_specs(180, 180, _port(jc), tscd.ScdParams())
    jc.thresholds[:] = _gap_thresholds(
        _level_sums(_port(jc), crop.tensor, specs[0]), *specs[0][4:6],
        share=0.4)
    cascade = _port(jc)
    params = tscd.ScdParams(min_neighbors=0, interval=1)
    handle = tscd.detect_async(crop, cascade, params, form="pallas")
    counts = [int(c[1]) for *_r, c in tscd.level_rows(handle)]
    caps = [tscd._level_capacity2(s[4] * s[5]) for s in handle.specs]
    assert 0 < sum(counts) and all(n <= k for n, k in zip(counts, caps))
    want = tscd.detect_collect(handle)
    reruns = []
    staged_level = tscd.staged_level

    def counting(*args, **kwargs):
        reruns.append(args[1])
        return staged_level(*args, **kwargs)

    monkeypatch.setattr(tscd, "staged_level", counting)
    monkeypatch.setattr(tscd, "_level_capacity2", lambda nwin: 1)
    got = tscd.detect(crop, cascade, params, form="pallas")
    assert len(reruns) == sum(n > 1 for n in counts) > 0
    # the rerun sums B2 over more windows at once: conf may move by an ulp
    _assert_same_detections(got, want, tol=1e-5)
    _assert_same_detections(got, tscd.detect(crop, cascade, params),
                            tol=1e-5)  # and K1's answer


def test_staged_detect_launches_no_kernel_on_cpu(crop, face):
    before = (tkernel.LAUNCHES, tphase.LAUNCHES)
    tscd.detect(crop, face, tscd.ScdParams(min_neighbors=0, interval=1),
                form="pallas")
    assert (tkernel.LAUNCHES, tphase.LAUNCHES) == before


def test_forms_and_shapes_are_checked(crop, face):
    with pytest.raises(ValueError, match="form"):
        tscd.detect(crop, face, form="bogus")
    with pytest.raises(ValueError):
        tscd.level_rows(tscd.detect_async(crop, face, tscd.ScdParams(
            interval=0)))
    with pytest.raises(ValueError):
        tscd.detect_batch(np.zeros((2, 3, 60, 60, 1), np.uint8), face,
                          device="cpu")
    with pytest.raises(NotImplementedError):
        tscd.detect_batch(np.zeros((2, 60, 60), np.uint8), face,
                          tscd.ScdParams(size=(24, 24)), device="cpu")


# -- detect_batch ------------------------------------------------------------

@pytest.fixture(scope="module")
def batch_imgs(crop):
    img = crop.numpy()
    return np.stack([img, np.ascontiguousarray(np.flip(img, axis=1))])


@pytest.fixture(scope="module")
def jax_batch(batch_imgs):
    """ccv_tpu's detect_batch on crop180 and its mirror at interval=0, as
    tests/test_scd_batch.py runs it."""
    return jscd.detect_batch(batch_imgs, jscd.load_cascade(CASCADE),
                             jscd.ScdParams(min_neighbors=0, interval=0))


@pytest.mark.parametrize("form", tscd.FORMS)
def test_detect_batch_matches_single_and_jax(batch_imgs, face, jax_batch,
                                             form):
    params = tscd.ScdParams(min_neighbors=0, interval=0)
    got = tscd.detect_batch(batch_imgs, face, params, form=form, device="cpu")
    single = [tscd.detect(torch.from_numpy(im), face, params, form=form)
              for im in batch_imgs]
    assert got == single
    for g, w in zip(got, jax_batch):
        _assert_same_detections(g, w)
    # the mirror finds the mirrored windows
    assert len(got[0]) == len(got[1]) > 0


@pytest.mark.cuda
def test_cuda_staged_detect_launches_k3(face):
    """On the card the staged form runs phases A and B1 through K3, twice
    per octave and twice per overflow rerun, and gives crop180's golden
    windows (run by chip_smoke.py as well, at full sizes and with
    detect_batch)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    crop = tio.read(os.path.join(DATA, "crop180.png"), tio.IO_RGB_COLOR,
                    device="cuda")
    params = tscd.ScdParams(min_neighbors=0, interval=1)
    n_oct = len({s[0] for s in tscd._level_specs(180, 180, face, params)[0]})
    launches, reruns = tphase.LAUNCHES, tscd.RERUNS
    out = tscd.detect(crop, face, params, form="pallas")
    reruns = tscd.RERUNS - reruns
    assert tscd.staged_tables(face).phase_b1 is not None
    assert reruns > 0 and tphase.LAUNCHES - launches == 2 * (n_oct + reruns)
    mine, ref = _by_rect(out), _golden("crop180.scd_i1.txt")
    assert set(mine) == set(ref)
    assert max(abs(mine[k] - ref[k]) for k in ref) < 6e-3
