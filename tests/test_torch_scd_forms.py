"""Port parity: SCD's plain staged forms (``form="slices"``, ``"xla"``,
``"matmul"``) and ``form="auto"``, the measured per-octave choice between
K1's and K3's forms.

The plain forms run level by level against ccv_tpu's
``_make_level_body(..., force_phase_a=<form>)`` on the CPU (ccv_tpu's
sparse phase B1 there, as the port's on a CPU tensor), both at full
capacity, with face_low's stage thresholds moved into gaps between the
first level's stage sums (tests/test_torch_scd_staged.py's gate: windows
may differ only where a stage sum lies within 1e-4 of its threshold, conf
within atol 2e-4, rtol 1e-5), and end to end against ``form="pallas_full"``
on crop180.png with face_low.sqlite3.

``auto`` runs with a patched card check and autotune store: on the card it
asks with ccv_tpu's op name and ``_octave_extra`` key, a batch reuses the
single image's record, and a form that recorded no time raises; on a CPU
tensor it measures nothing and is ``"pallas_full"``.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccv_tpu.detectors import scd as jscd
from ccv_tpu_torch.core import io as tio
from ccv_tpu_torch.detectors import scd as tscd
from ccv_tpu_torch.nn import autotune
from ccv_tpu_torch.ops import resample as tresample
from ccv_tpu_torch.ops.kernels import scd_cascade as tkernel
from ccv_tpu_torch.ops.kernels import scd_phase as tphase

DATA = os.path.join(os.path.dirname(__file__), "data")
CASCADE = os.path.join(DATA, "face_low.sqlite3")
STEP = 4
MARGIN = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _isolated_store(tmp_path, monkeypatch):
    monkeypatch.setenv("CCV_TPU_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    monkeypatch.setattr(autotune, "_MEM", None)


@pytest.fixture(scope="module")
def crop():
    return tio.read(os.path.join(DATA, "crop180.png"), tio.IO_RGB_COLOR,
                    device="cpu")


@pytest.fixture(scope="module")
def face():
    return tscd.load_cascade(CASCADE)


def _port(jc):
    return tscd.cascade_from_numpy({f.name: getattr(jc, f.name)
                                    for f in dataclasses.fields(jc)})


def _level_sums(cascade, src, spec):
    (_o, k, rows, cols, ny, nx, _s) = spec
    sat = tscd._octave_sats(src[None], [(k, rows, cols, ny, nx)],
                            cascade.margin)
    vs = tkernel.cascade_stage_sums_ref(sat, tscd.cascade_tables(cascade),
                                        STEP, [[ny, nx]])
    return vs[0, :, :ny, :nx].reshape(vs.shape[1], -1)


def _gap_thresholds(vs, share=0.7):
    """Per stage, a threshold in a gap at least 4 * MARGIN wide between the
    level's distinct stage sums, keeping the share nearest ``share``."""
    th = []
    for s in range(vs.shape[0]):
        vals = vs[s].sort().values
        u = torch.unique(vals)
        mids, gaps = (u[1:] + u[:-1]) / 2, u[1:] - u[:-1]
        frac = 1 - torch.searchsorted(vals, mids, right=True) / vals.numel()
        score = torch.where(gaps > 4 * MARGIN, (frac - share).abs(), 2.0)
        th.append(float(mids[int(score.argmin())]))
    return np.asarray(th, np.float32)


def _gapped(crop, share):
    """(ccv_tpu cascade, the port's, crop180's default-params plan, the two
    octave sources) with face_low's thresholds in gaps of level 0's sums,
    each stage keeping about ``share`` of level 0's windows."""
    jc = jscd.load_cascade(CASCADE)
    specs, _ = tscd._level_specs(180, 180, _port(jc), tscd.ScdParams())
    srcs = [crop.tensor, tresample.sample_down(crop.tensor)]
    jc.thresholds[:] = _gap_thresholds(_level_sums(_port(jc), srcs[0],
                                                   specs[0]), share)
    return jc, _port(jc), specs, srcs


@pytest.fixture(scope="module")
def gap_cascade(crop):
    return _gapped(crop, 0.7)


@pytest.mark.parametrize("form", tscd.PLAIN_FORMS)
@pytest.mark.parametrize("li", [0, 1, 6])
def test_plain_form_level_matches_jax(gap_cascade, form, li):
    jc, cascade, specs, srcs = gap_cascade
    spec = specs[li]
    (_o, k, rows, cols, ny, nx, _s) = spec
    src = srcs[spec[0]]
    idx, passed, conf, count2 = tscd.form_level(src, spec, cascade,
                                                tscd.ScdParams(), form)
    tabs = jscd._cascade_tables(jc)
    body = jscd._make_level_body(tuple(src.shape), rows, cols, ny, nx,
                                 k == 0, jc, STEP, tabs, K2=ny * nx,
                                 force_phase_a=form, K1=ny * nx)
    jidx, jpassed, jconf, jcount2 = jax.device_get(jax.jit(body)(
        jnp.asarray(src.numpy()), tabs["last_count"]))
    assert len(idx) == len(jidx) == ny * nx
    vs = _level_sums(cascade, src, spec).numpy()
    near = (np.abs(vs - jc.thresholds[:, None]) <= MARGIN).any(axis=0)
    mine = dict(zip(idx[passed].tolist(), conf[passed].tolist()))
    want = dict(zip(np.asarray(jidx)[jpassed].tolist(),
                    np.asarray(jconf)[jpassed].tolist()))
    assert mine and len(mine) < ny * nx, "a vacuous comparison"
    assert {i for i in set(mine) ^ set(want) if not near[i]} == set()
    both = sorted(set(mine) & set(want))
    np.testing.assert_allclose([mine[i] for i in both],
                               [want[i] for i in both], atol=2e-4, rtol=1e-5)
    if not near.any():
        np.testing.assert_array_equal(count2, jcount2)


@pytest.fixture(scope="module")
def full_detections(crop, face):
    params = tscd.ScdParams(min_neighbors=0, interval=1)
    return tscd.detect(crop, face, params)


def _by_rect(comps):
    return {(c.x, c.y, c.width, c.height): c.confidence for c in comps}


@pytest.mark.parametrize("form", tscd.PLAIN_FORMS)
def test_plain_form_detect_equals_pallas_full(crop, face, full_detections,
                                              form):
    """face_low's open thresholds: every window passes, every level
    overflows K1 or K2 and is rerun at full capacity in its form."""
    reruns = tscd.RERUNS
    got = _by_rect(tscd.detect(crop, face, tscd.ScdParams(
        min_neighbors=0, interval=1), form=form))
    want = _by_rect(full_detections)
    assert tscd.RERUNS > reruns
    assert set(got) == set(want) and len(want) > 1000
    assert max(abs(got[r] - want[r]) for r in want) < 2e-4


@pytest.mark.parametrize("form", tscd.PLAIN_FORMS)
def test_plain_forms_without_rerun_equal_pallas(crop, form):
    """With gap thresholds keeping 40% a stage no level overflows K1 or K2:
    the plain forms' compacted rows give the detections of the kernel forms
    (their plain versions on the CPU), grouped and not."""
    _jc, cascade, _specs, _srcs = _gapped(crop, 0.4)
    for mn in (0, 1):
        params = tscd.ScdParams(min_neighbors=mn, interval=1)
        reruns = tscd.RERUNS
        got = tscd.detect(crop, cascade, params, form=form)
        assert tscd.RERUNS == reruns
        want = tscd.detect(crop, cascade, params, form="pallas")
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert (g.x, g.y, g.width, g.height, g.neighbors) == \
                (w.x, w.y, w.width, w.height, w.neighbors)
            assert abs(g.confidence - w.confidence) < 2e-4


def test_plain_forms_launch_no_kernel_and_refuse_evaluate(crop, face):
    before = (tkernel.LAUNCHES, tphase.LAUNCHES)
    tscd.detect(crop, face, tscd.ScdParams(interval=0), form="xla")
    assert (tkernel.LAUNCHES, tphase.LAUNCHES) == before
    with pytest.raises(ValueError, match="evaluate"):
        tscd.detect(crop, face, evaluate=tkernel.cascade_eval_levels_ref,
                    form="slices")
    with pytest.raises(ValueError, match="form"):
        tscd.form_level(crop.tensor, tscd._level_specs(
            180, 180, face, tscd.ScdParams())[0][0], face, tscd.ScdParams(),
            "pallas")


# -- form="auto" -------------------------------------------------------------

def _octaves(face, params, H=180, W=180):
    specs, _ = tscd._level_specs(H, W, face, params)
    by = {}
    for (o, k, r, c, ny, nx, _s) in specs:
        by.setdefault(o, []).append((k, r, c, ny, nx))
    return by


def test_auto_on_cpu_is_pallas_full_and_measures_nothing(crop, face,
                                                         full_detections):
    before = autotune.stats()
    params = tscd.ScdParams(min_neighbors=0, interval=1)
    handle = tscd.detect_async(crop, face, params, form="auto")
    assert {e[0] for e in handle.layout} == {"pallas_full"}
    assert tscd.detect_collect(handle) == full_detections
    assert autotune.stats_delta(before) == {"hits": 0, "measured": 0}
    assert autotune.decisions() == {}


def test_auto_asks_with_ccv_tpu_key(crop, face, monkeypatch):
    """On the card (patched) auto asks autotune per octave with ccv_tpu's op
    and ``_octave_extra``, zeros of the octave source (uint8) and a 0-dim
    float32, default K1's form, and runs the form it gets."""
    asked = []

    def choose(op, variants, args, default=None, extra=""):
        asked.append((op, tuple(variants), args, default, extra))
        return variants["pallas"]

    monkeypatch.setattr(tscd, "_on_card", lambda t: True)
    monkeypatch.setattr(autotune, "choose", choose)
    params = tscd.ScdParams(min_neighbors=0, interval=1)
    handle = tscd.detect_async(crop, face, params, form="auto")
    jc = jscd.load_cascade(CASCADE)
    octs = _octaves(face, params)
    assert len(asked) == len(octs) == 2
    for (op, names, args, default, extra), (o, lspecs), shape in zip(
            asked, sorted(octs.items()), [(180, 180, 3), (90, 90, 3)]):
        assert op == "scd_octave_exact" == tscd.OCTAVE_OP
        assert names == tscd.AUTO_FORMS == ("pallas_full", "pallas")
        assert default == "pallas_full"
        assert extra == jscd._octave_extra(lspecs, jc, STEP, False)
        assert tuple(args[0].shape) == shape and args[0].dtype == torch.uint8
        assert not args[0].any()
        assert args[1].shape == () and args[1].dtype == torch.float32
    assert [e[0] for e in handle.layout] == ["pallas", "pallas"]
    got = tscd.detect_collect(handle)
    want = tscd.detect(crop, face, params, form="pallas")
    assert got == want


def _record(face, params, src_shape, choice, ms):
    """Keep a decision for every octave of an image of ``src_shape``."""
    H, W, C = src_shape
    mem = autotune._load()
    for o, lspecs in _octaves(face, params, H, W).items():
        args = (torch.zeros((H >> o, W >> o, C), dtype=torch.uint8),
                torch.zeros((), dtype=torch.float32))
        mem[autotune._key(tscd.OCTAVE_OP, args, tscd._octave_extra(
            lspecs, face, STEP, False))] = {"choice": choice, "ms": ms}


def test_auto_batch_reuses_the_single_image_record(crop, face, monkeypatch):
    monkeypatch.setattr(tscd, "_on_card", lambda t: True)
    params = tscd.ScdParams(min_neighbors=0, interval=0)
    _record(face, params, (180, 180, 3), "pallas",
            {"pallas_full": 2.0, "pallas": 1.0})
    img = crop.numpy()
    batch = np.stack([img, np.ascontiguousarray(np.flip(img, axis=1))])
    before = autotune.stats()
    got = tscd.detect_batch(batch, face, params, device="cpu", form="auto")
    n_oct = len(_octaves(face, params))
    assert autotune.stats_delta(before) == {"hits": n_oct, "measured": 0}
    assert got == tscd.detect_batch(batch, face, params, device="cpu",
                                    form="pallas")


def test_auto_raises_when_a_form_recorded_no_time(crop, face, monkeypatch):
    """A form that could not run on the card is never quietly swapped for
    the other kernel: auto raises naming it."""
    monkeypatch.setattr(tscd, "_on_card", lambda t: True)
    params = tscd.ScdParams(min_neighbors=0, interval=1)
    _record(face, params, (180, 180, 3), "pallas_full",
            {"pallas_full": 1.0, "pallas": None})
    with pytest.raises(RuntimeError, match="the pallas form"):
        tscd.detect(crop, face, params, form="auto")


def test_auto_measures_both_forms_on_a_miss(face, monkeypatch):
    """A miss measures K1's and K3's octave programs (their plain versions
    here) on zeros, keeps both times and runs the winner; a second call
    hits."""
    monkeypatch.setattr(tscd, "_on_card", lambda t: True)
    img = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (60, 64), dtype=np.uint8))
    params = tscd.ScdParams(min_neighbors=0)
    before = autotune.stats()
    got = tscd.detect(img, face, params, form="auto")
    n_oct = len(_octaves(face, params, 60, 64))
    assert autotune.stats_delta(before) == {"hits": 0, "measured": n_oct}
    recs = list(autotune.decisions().values())
    assert len(recs) == n_oct
    for rec in recs:
        assert rec["choice"] in tscd.AUTO_FORMS
        assert all(v is not None and v > 0 for v in rec["ms"].values())
    again = tscd.detect(img, face, params, form="auto")
    assert autotune.stats_delta(before) == {"hits": n_oct,
                                            "measured": n_oct}
    assert got == again
    want = _by_rect(tscd.detect(img, face, params))
    mine = _by_rect(got)
    assert set(mine) == set(want) and want
    assert max(abs(mine[r] - want[r]) for r in want) < 2e-4
