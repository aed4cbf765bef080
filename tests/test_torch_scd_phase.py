"""Port parity: kernel K3 (phases A and B1 of the staged SCD cascade), its
plain PyTorch version against ccv_tpu's Pallas kernel in TPU interpret mode
and against the XLA formulation of tests/test_scd_pallas.py (ccv_tpu's dense
phase B1 too), its tables, records and shared phase planes.

Survivor sets must agree wherever every stage sum is more than 1e-4 from
its threshold (float noise near a threshold may flip a window); last-stage
sums agree to atol=2e-4, rtol=1e-5 where both pass.
"""

import dataclasses
import functools
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from ccv_tpu.detectors import scd as jscd
from ccv_tpu.ops.pallas import scd_phase as jphase
from ccv_tpu_torch.core import io as tio
from ccv_tpu_torch.detectors import scd as tscd
from ccv_tpu_torch.ops.kernels import scd_cascade as tkernel
from ccv_tpu_torch.ops.kernels import scd_phase as tphase

DATA = os.path.join(os.path.dirname(__file__), "data")
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


def _synth_cascade(rng, feats_per_stage, wh=16):
    F = sum(feats_per_stage)
    sx = rng.integers(0, wh - 4, (F, 4)).astype(np.int32)
    sy = rng.integers(0, wh - 4, (F, 4)).astype(np.int32)
    n_stages = len(feats_per_stage)
    return jscd.ScdClassifierCascade(
        width=wh, height=wh, margin=(0, 0, 0, 0),
        stage_counts=np.asarray(feats_per_stage, np.int32),
        thresholds=np.zeros(n_stages, np.float32), sx=sx, sy=sy,
        dx=(sx + rng.integers(2, 5, (F, 4))).astype(np.int32),
        dy=(sy + rng.integers(2, 5, (F, 4))).astype(np.int32),
        bias=rng.normal(0, 0.5, F).astype(np.float32),
        w=rng.normal(0, 1, (F, 32)).astype(np.float32),
        stage_of=np.repeat(np.arange(n_stages),
                           feats_per_stage).astype(np.int32))


def _port(jcascade):
    return tscd.cascade_from_numpy(
        {f.name: getattr(jcascade, f.name)
         for f in dataclasses.fields(jcascade)})


def _stack(sat_levels):
    H1 = max(s.shape[1] for s in sat_levels)
    W1 = max(s.shape[2] for s in sat_levels)
    out = np.zeros((len(sat_levels), 8, H1, W1), np.float32)
    for i, s in enumerate(sat_levels):
        out[i, :, :s.shape[1], :s.shape[2]] = s
    return torch.from_numpy(out)


def _gap_thresholds(vs, dims):
    """Per stage, a threshold in a gap of at least 4 * MARGIN between
    distinct stage sums over the real windows, the one whose pass share is
    closest to a half: no window lies in the margin."""
    th = []
    for s in range(vs.shape[1]):
        vals = torch.cat([vs[li, s, :ny, :nx].reshape(-1)
                          for li, (ny, nx) in enumerate(dims)]).sort().values
        u = torch.unique(vals)
        mids, gaps = (u[1:] + u[:-1]) / 2, u[1:] - u[:-1]
        frac = 1 - torch.searchsorted(vals, mids, right=True) / vals.numel()
        score = torch.where(gaps > 4 * MARGIN, (frac - 0.5).abs(), 2.0)
        th.append(float(mids[int(score.argmin())]))
    return np.asarray(th, np.float32)


def _jax_phase_a_xla(jcascade, sat, ny, nx, phase="phase_a"):
    """ccv_tpu's XLA formulation of a dense phase (tests/test_scd_pallas.py:
    44-52 for phase A; ccv_tpu's dense B1 slices the planes the same way) on
    one level's (8, H1, W1) SAT: (last-stage sum, passed), (ny, nx)."""
    tabs = jscd._cascade_tables(jcascade)
    phase = tabs[phase]
    sat8 = jnp.asarray(np.ascontiguousarray(sat.transpose(1, 2, 0)))
    planes, _th, _tw = jscd._phase_planes(
        sat8, ny, nx, int(tabs["all_off"][:, 0].max()),
        int(tabs["all_off"][:, 1].max()), STEP)
    D = jscd._grid_corner_slices(planes, phase["offsets"], ny, nx, STEP)
    v, p = jscd._surf_from_D(D, phase)
    return (np.asarray(v[:, -1]).reshape(ny, nx),
            np.asarray(p).reshape(ny, nx))


def _assert_agree(vs, thresholds, conf_a, passed_a, conf_b, passed_b):
    """vs: (S, ny, nx) phase-A stage sums of the plain version."""
    margin_ok = (np.abs(vs - thresholds[:, None, None]) > MARGIN).all(axis=0)
    assert passed_a.any() and not passed_a.all(), "a vacuous comparison"
    np.testing.assert_array_equal(passed_a[margin_ok], passed_b[margin_ok])
    both = passed_a & passed_b
    np.testing.assert_allclose(conf_a[both], conf_b[both], atol=2e-4,
                               rtol=1e-5)


CASES = {
    # 14 features in 4 stages lead; a 6-feature stage follows (phase B1)
    "median": ((2, 3, 4, 5, 6), [[17, 140]]),
    # stage 0 alone has 20 features: phase A holds it past the 16
    "stage0_over_16": ((20, 3, 4), [[11, 21]]),
    "multi_level": ((2, 3, 4, 5, 6), [[13, 140], [9, 100], [5, 60]]),
}


@pytest.mark.parametrize("counts,dims", list(CASES.values()), ids=list(CASES))
def test_plain_phase_a_matches_jax_xla(counts, dims):
    rng = np.random.default_rng(13)
    jcascade = _synth_cascade(rng, counts)
    dims = np.asarray(dims)
    sat_levels = []
    for ny, nx in dims:
        H1 = (ny - 1) * STEP + jcascade.height + 1
        W1 = (nx - 1) * STEP + jcascade.width + 1
        sat_levels.append(rng.normal(0, 10, (8, H1, W1)).astype(np.float32))
    sat_l = _stack(sat_levels)
    split = tscd.phase_split(counts)[0]
    tabs_a = tscd.staged_tables(_port(jcascade)).phase_a
    assert tabs_a.n_stages == split
    assert tabs_a.n_features == sum(counts[:split])
    vs = tkernel.cascade_stage_sums_ref(sat_l, tabs_a, STEP, dims)
    jcascade.thresholds[:split] = [float(vs[:, s].median())
                                   for s in range(split)]
    tabs_a = tscd.staged_tables(_port(jcascade)).phase_a
    conf, passed = tphase.phase_a_ref(sat_l, tabs_a, STEP, dims)
    conf, passed, vs = conf.numpy(), passed.numpy(), vs.numpy()
    for li, (ny, nx) in enumerate(dims):
        want_conf, want_passed = _jax_phase_a_xla(jcascade, sat_levels[li],
                                                  ny, nx)
        _assert_agree(vs[li, :, :ny, :nx], tabs_a.thresholds,
                      conf[li, :ny, :nx], passed[li, :ny, :nx], want_conf,
                      want_passed)
        # conf is the last stage's sum for every window, passed or not
        np.testing.assert_array_equal(conf[li, :ny, :nx],
                                      vs[li, -1, :ny, :nx])
        assert not passed[li, ny:].any() and not passed[li, :, nx:].any()
        assert not conf[li, ny:].any() and not conf[li, :, nx:].any()


@pytest.fixture(scope="module")
def crop180_level0():
    """crop180's level-0 SAT through ccv_tpu, and the face cascade with its
    phase-A thresholds in gaps between that level's stage sums."""
    img = tio.read(os.path.join(DATA, "crop180.png"), tio.IO_RGB_COLOR,
                   device="cpu")
    jc = jscd.load_cascade(os.path.join(DATA, "face_low.sqlite3"))
    (_o, _k, _r, _c, ny, nx, _s) = jscd._level_specs(180, 180, jc,
                                                     jscd.ScdParams())[0][0]
    m = jc.margin
    image = jnp.pad(jnp.asarray(img.numpy()),
                    [(m[1], m[3]), (m[0], m[2]), (0, 0)])
    sat = np.array(jscd._sat_cf8(jscd.scd_map_cf8(image)))
    tabs_a = tscd.staged_tables(_port(jc)).phase_a
    vs = tkernel.cascade_stage_sums_ref(torch.from_numpy(sat)[None], tabs_a,
                                        STEP, [[ny, nx]])
    jc.thresholds[:tabs_a.n_stages] = _gap_thresholds(vs, [[ny, nx]])
    return jc, sat, ny, nx


def test_plain_phase_a_matches_pallas_interpret(crop180_level0, monkeypatch):
    """ccv_tpu's K3 itself, run in Pallas TPU interpret mode: its module's
    ``pl`` is swapped for one whose pallas_call interprets."""
    jc, sat, ny, nx = crop180_level0
    interp = types.SimpleNamespace(**vars(pl))
    interp.pallas_call = functools.partial(
        pl.pallas_call, interpret=pltpu.InterpretParams())
    monkeypatch.setattr(jphase, "pl", interp)
    tabs = jscd._cascade_tables(jc)
    th = int(tabs["all_off"][:, 0].max()) // STEP + 1
    tw = int(tabs["all_off"][:, 1].max()) // STEP + 1
    sat8 = jnp.asarray(sat.transpose(1, 2, 0))
    want_conf, want_passed = (
        np.asarray(x).reshape(ny, nx)
        for x in jphase.phase_a(sat8, tabs["phase_a"], STEP, ny, nx, th, tw))
    tabs_a = tscd.staged_tables(_port(jc)).phase_a
    assert tabs_a.n_features == 12 and tabs_a.n_stages == 3
    conf, passed = tphase.phase_a(torch.from_numpy(sat)[None], tabs_a, STEP,
                                  [[ny, nx]])
    conf, passed = conf[0].numpy(), passed[0].numpy()
    assert passed.shape == (33, 33) and 0 < passed.sum() < passed.size
    np.testing.assert_array_equal(passed, want_passed)
    np.testing.assert_allclose(conf, want_conf, atol=1e-4, rtol=0)


B1_CASES = {
    # stages 0-3 are phase A; stage 4 (6 features) is B1
    "median": ((2, 3, 4, 5, 6), [[17, 140]]),
    # B1 is stages 4 and 5 (6 + 9 features): passed is the AND of both
    "two_stages": ((2, 3, 4, 5, 6, 9), [[13, 140], [9, 100], [5, 60]]),
    # face_low: B1 is stage 3, 49 features
    "face_low": (None, [[9, 12], [6, 8]]),
}


@pytest.mark.parametrize("counts,dims", list(B1_CASES.values()),
                         ids=list(B1_CASES))
def test_plain_phase_b1_matches_jax_xla(counts, dims):
    """The staged cascade runs phase B1 through K3's wrapper: its plain
    version on the B1 tables matches ccv_tpu's dense B1, the XLA corner
    slices of the phase planes (random SATs; thresholds in gaps)."""
    rng = np.random.default_rng(14)
    jcascade = (_synth_cascade(rng, counts) if counts else jscd.load_cascade(
        os.path.join(DATA, "face_low.sqlite3")))
    dims = np.asarray(dims)
    ey, ex = tscd.cascade_tables(_port(jcascade)).extent
    sat_levels = [rng.normal(0, 10, (8, (ny - 1) * STEP + ey + 1,
                                     (nx - 1) * STEP + ex + 1))
                  .astype(np.float32) for ny, nx in dims]
    sat_l = _stack(sat_levels)
    split, split2 = tscd.phase_split(jcascade.stage_counts)
    tabs_b1 = tscd.staged_tables(_port(jcascade)).phase_b1
    assert tabs_b1.n_stages == split2 - split
    vs = tkernel.cascade_stage_sums_ref(sat_l, tabs_b1, STEP, dims)
    jcascade.thresholds[split:split2] = _gap_thresholds(vs, dims)
    tabs_b1 = tscd.staged_tables(_port(jcascade)).phase_b1
    conf, passed = tphase.phase_a_ref(sat_l, tabs_b1, STEP, dims)
    conf, passed, vs = conf.numpy(), passed.numpy(), vs.numpy()
    for li, (ny, nx) in enumerate(dims):
        want_conf, want_passed = _jax_phase_a_xla(
            jcascade, sat_levels[li], ny, nx, "phase_b1")
        _assert_agree(vs[li, :, :ny, :nx], tabs_b1.thresholds,
                      conf[li, :ny, :nx], passed[li, :ny, :nx], want_conf,
                      want_passed)
        np.testing.assert_array_equal(conf[li, :ny, :nx],
                                      vs[li, -1, :ny, :nx])


def test_shared_planes_cover_both_phases():
    """The staged form makes one copy of the phase planes for phase A's and
    B1's launches, as far as the larger of their corner extents reaches;
    phase_a takes them for either phase (the plain version ignores them)
    and refuses planes that do not cover a phase's windows."""
    staged = tscd.staged_tables(tscd.load_cascade(
        os.path.join(DATA, "face_low.sqlite3")))
    a, b1 = staged.phase_a, staged.phase_b1
    assert a.extent == (44, 48) and b1.extent == (48, 48)
    dims = np.array([[5, 7], [3, 4]])
    H1, W1 = 4 * STEP + 48 + 2, 6 * STEP + 48 + 3
    sat = torch.from_numpy(np.random.default_rng(6).normal(
        0, 10, (2, 8, H1, W1)).astype(np.float32))
    planes = tkernel.kernel_planes(sat, a, STEP, dims, b1)
    assert planes.shape == (2, STEP * STEP, 8, 5 + 48 // STEP,
                            7 + 48 // STEP)
    for tables in (a, b1):
        got = tphase.phase_a(sat, tables, STEP, dims, planes=planes)
        want = tphase.phase_a(sat, tables, STEP, dims)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    # phase A's own planes stop a row short of B1's corners
    own = tkernel.kernel_planes(sat, a, STEP, dims)
    assert own.shape[3:] == (5 + 44 // STEP, 7 + 48 // STEP)
    tphase.phase_a(sat, a, STEP, dims, planes=own)
    bad = {"A's planes for B1": own,
           "a column short": tkernel.phase_planes(sat, STEP, 17, 18),
           "one level": planes[:1], "float64": planes.double(),
           "not contiguous": planes.transpose(3, 4)}
    for p in bad.values():
        with pytest.raises(ValueError, match="phase planes"):
            tphase.phase_a(sat, b1, STEP, dims, planes=p)


def test_records_of_a_1100_feature_phase():
    """A phase of 1,100 features (K3 stages its records in runs of 512):
    through ``records``, every box corner of every feature lands on the SAT
    corner it names, at every window of a small grid."""
    rng = np.random.default_rng(10)
    tables = tscd.staged_tables(_port(_synth_cascade(
        rng, (1100, 3, 4)))).phase_a
    assert tables.n_features == 1100 and tables.n_stages == 1
    ey, ex = tables.extent
    dims = np.array([[4, 6]])
    sat = torch.from_numpy(rng.normal(0, 10, (1, 8, 3 * STEP + ey + 1,
                                              5 * STEP + ex + 1))
                           .astype(np.float32))
    planes = tkernel.kernel_planes(sat, tables, STEP, dims)
    _L, _P, _C, hs, ws = planes.shape
    recs = tables.records(STEP, hs, ws)
    assert recs.shape == (1100, 17) and recs.dtype == np.int32
    np.testing.assert_array_equal(recs[:, 0], tables.layout)
    slots = np.array([tkernel.BOX_ORDER] + [tkernel.LAYOUTS[k] for k in
                                            sorted(tkernel.LAYOUTS)])
    off = np.take_along_axis(recs[:, 1:], slots[tables.layout], axis=1)
    oyx = np.take_along_axis(tables.corners, tables.cidx.reshape(
        -1, 16)[..., None], axis=1)                      # (F, 16, 2)
    wy, wx = np.meshgrid(np.arange(4), np.arange(6), indexing="ij")
    at = (wy * ws + wx).reshape(-1)
    chan = np.arange(8)[:, None, None, None] * (hs * ws)
    got = planes.reshape(-1)[torch.from_numpy(
        chan + at[None, :, None, None] + off[None, None])]
    want = sat[0][:, torch.from_numpy(
        wy.reshape(-1)[:, None, None] * STEP + oyx[None, ..., 0]),
        torch.from_numpy(wx.reshape(-1)[:, None, None] * STEP
                         + oyx[None, ..., 1])]
    assert torch.equal(got, want)


def test_dims_live_on_the_device_once():
    """The wrappers take each level grid's device copy from a cache keyed
    by device and value, so a launch makes no host copy."""
    a = tkernel.dims_on(np.array([[33, 33], [28, 28]]), torch.device("cpu"))
    b = tkernel.dims_on(np.array([[33, 33], [28, 28]], np.int64),
                        torch.device("cpu"))
    c = tkernel.dims_on(np.array([[33, 33]]), torch.device("cpu"))
    assert a is b and a.dtype == torch.int32
    assert a.tolist() == [[33, 33], [28, 28]] and c.tolist() == [[33, 33]]


def _tables(counts=(2, 3, 4, 5, 6), seed=5):
    return tscd.staged_tables(_port(_synth_cascade(
        np.random.default_rng(seed), counts))).phase_a


def test_wrapper_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(5)
    tables = _tables()
    dims = np.array([[6, 9], [4, 5]])
    sat_l = torch.from_numpy(rng.normal(0, 10, (2, 8, 40, 52))
                             .astype(np.float32))
    before = tphase.LAUNCHES
    conf, passed = tphase.phase_a(sat_l, tables, STEP, dims)
    ref_conf, ref_passed = tphase.phase_a_ref(sat_l, tables, STEP, dims)
    assert tphase.LAUNCHES == before  # no kernel launched for a CPU tensor
    assert conf.shape == passed.shape == (2, 6, 9)
    assert passed.dtype == torch.bool
    torch.testing.assert_close(conf, ref_conf, rtol=0, atol=0)
    assert torch.equal(passed, ref_passed)


def test_wrapper_rejects_bad_input():
    tables = _tables()
    good = torch.zeros((1, 8, 40, 40))
    with pytest.raises(TypeError):
        tphase.phase_a(good.double(), tables, STEP, [[2, 2]])
    with pytest.raises(ValueError):
        tphase.phase_a(good[:, :7], tables, STEP, [[2, 2]])
    with pytest.raises(ValueError):
        tphase.phase_a(good.transpose(2, 3), tables, STEP, [[2, 2]])
    with pytest.raises(ValueError):  # windows past the SAT
        tphase.phase_a(good, tables, STEP, [[11, 2]])
    with pytest.raises(ValueError):
        tphase.phase_a(good, tables, STEP, [[2, 2], [1, 1]])


def test_phase_tables_require_contiguous_stages():
    c = _synth_cascade(np.random.default_rng(2), (2, 2, 2))
    args = (c.thresholds, c.sx, c.sy, c.dx, c.dy, c.bias, c.w)
    mixed = np.array([0, 1, 0, 1, 2, 2], np.int32)
    with pytest.raises(ValueError, match="contiguous"):  # stage 0 split
        tphase.phase_tables(*args, mixed, 0, 1)
    with pytest.raises(ValueError, match="contiguous"):  # inside the phase
        tphase.phase_tables(*args, mixed, 0, 2)
    with pytest.raises(ValueError):
        tphase.phase_tables(*args, c.stage_of, 2, 4)
    t = tphase.phase_tables(*args, c.stage_of, 1, 3)
    assert t.stage_ranges == ((0, 2), (2, 4))
    np.testing.assert_array_equal(t.thresholds, c.thresholds[1:3])
    np.testing.assert_array_equal(t.w, c.w[2:6])


@pytest.mark.cuda
@pytest.mark.parametrize("counts,dims", list(CASES.values()), ids=list(CASES))
def test_cuda_kernel_matches_plain(counts, dims):
    """K3 against its plain version on the same SAT on the card (run by
    chip_smoke.py as well, at the main path's shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(11)
    jcascade = _synth_cascade(rng, counts)
    dims = np.asarray(dims)
    H1 = (dims[:, 0].max() - 1) * STEP + jcascade.height + 1
    W1 = (dims[:, 1].max() - 1) * STEP + jcascade.width + 1
    sat_l = torch.from_numpy(rng.normal(0, 10, (len(dims), 8, H1, W1))
                             .astype(np.float32)).cuda()
    tables = tscd.staged_tables(_port(jcascade)).phase_a
    vs = tkernel.cascade_stage_sums_ref(sat_l, tables, STEP, dims)
    jcascade.thresholds[:tables.n_stages] = [
        float(vs[:, s].median()) for s in range(tables.n_stages)]
    tables = tscd.staged_tables(_port(jcascade)).phase_a
    ref = tphase.phase_a_ref(sat_l, tables, STEP, dims)
    before = tphase.LAUNCHES
    got = tphase.phase_a(sat_l, tables, STEP, dims)
    torch.cuda.synchronize()
    assert tphase.LAUNCHES == before + 1
    for li, (ny, nx) in enumerate(dims):
        _assert_agree(vs[li, :, :ny, :nx].cpu().numpy(), tables.thresholds,
                      ref[0][li, :ny, :nx].cpu().numpy(),
                      ref[1][li, :ny, :nx].cpu().numpy(),
                      got[0][li, :ny, :nx].cpu().numpy(),
                      got[1][li, :ny, :nx].cpu().numpy())
        assert not got[1][li, ny:].any() and not got[1][li, :, nx:].any()


def _layout_cascade(rng, feats_per_stage, wh=24):
    """A synthetic cascade whose features have the box layouts of SCD's
    feature generator (4 boxes in a column, in a row, or in a 2 x 2 grid,
    in the generator's box order): K3's distinct-corner paths."""
    c = _synth_cascade(rng, feats_per_stage, wh)
    for f in range(len(c.bias)):
        q, a, b = (int(v) for v in rng.integers(1, 4, 3))
        x, y = (int(v) for v in rng.integers(0, wh - 12, 2))
        if f % 3 == 0:    # 1x4
            boxes = [(x, y + i * q, x + a + 1, y + (i + 1) * q)
                     for i in range(4)]
        elif f % 3 == 1:  # 4x1
            boxes = [(x + i * q, y, x + (i + 1) * q, y + a + 1)
                     for i in range(4)]
        else:             # 2x2
            boxes = [(x, y, x + a, y + b), (x, y + b, x + a, y + 2 * b),
                     (x + a, y, x + 2 * a, y + b),
                     (x + a, y + b, x + 2 * a, y + 2 * b)]
        c.sx[f], c.sy[f], c.dx[f], c.dy[f] = (np.array(v) for v in
                                              zip(*boxes))
    return c


# (cascade maker, phase, dims): SCD's box layouts in phases A and B1; a
# phase A of 1,100 features, past a 512-feature run of records (a stage
# straddles two runs); face_low's B1 (49 features)
CUDA_PHASES = {
    "layouts_a": (lambda rng: _layout_cascade(rng, (4, 4, 4, 30)),
                  "phase_a", [[13, 140], [9, 100]]),
    "layouts_b1": (lambda rng: _layout_cascade(rng, (4, 4, 4, 30)),
                   "phase_b1", [[13, 140], [9, 100]]),
    "1100_features": (lambda rng: _synth_cascade(rng, (1100, 3, 4)),
                      "phase_a", [[9, 37], [6, 20]]),
    "face_b1": (lambda rng: jscd.load_cascade(
        os.path.join(DATA, "face_low.sqlite3")), "phase_b1", [[17, 60]]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("make,phase,dims", list(CUDA_PHASES.values()),
                         ids=list(CUDA_PHASES))
def test_cuda_kernel_matches_plain_on_phases(make, phase, dims):
    """K3 against its plain version on the card, on the phases the staged
    form runs through it, off phase planes shared with phase A."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(15)
    jcascade = make(rng)
    dims = np.asarray(dims)
    ey, ex = tscd.cascade_tables(_port(jcascade)).extent
    sat_l = torch.from_numpy(rng.normal(0, 10, (
        len(dims), 8, (dims[:, 0].max() - 1) * STEP + ey + 1,
        (dims[:, 1].max() - 1) * STEP + ex + 1)).astype(np.float32)).cuda()
    split, split2 = tscd.phase_split(jcascade.stage_counts)
    s0, s1 = (0, split) if phase == "phase_a" else (split, split2)
    tables = getattr(tscd.staged_tables(_port(jcascade)), phase)
    vs = tkernel.cascade_stage_sums_ref(sat_l, tables, STEP, dims)
    jcascade.thresholds[s0:s1] = _gap_thresholds(vs, dims)
    staged = tscd.staged_tables(_port(jcascade))
    tables = getattr(staged, phase)
    ref = tphase.phase_a_ref(sat_l, tables, STEP, dims)
    planes = tkernel.kernel_planes(sat_l, staged.phase_a, STEP, dims,
                                   staged.phase_b1 or staged.phase_a)
    before = tphase.LAUNCHES
    got = tphase.phase_a(sat_l, tables, STEP, dims, planes=planes)
    torch.cuda.synchronize()
    assert tphase.LAUNCHES == before + 1
    vs = vs.cpu().numpy()
    for li, (ny, nx) in enumerate(dims):
        _assert_agree(vs[li, :, :ny, :nx], tables.thresholds,
                      ref[0][li, :ny, :nx].cpu().numpy(),
                      ref[1][li, :ny, :nx].cpu().numpy(),
                      got[0][li, :ny, :nx].cpu().numpy(),
                      got[1][li, :ny, :nx].cpu().numpy())
        np.testing.assert_allclose(got[0][li, :ny, :nx].cpu().numpy(),
                                   ref[0][li, :ny, :nx].cpu().numpy(),
                                   atol=2e-4, rtol=1e-5)
        assert not got[1][li, ny:].any() and not got[1][li, :, nx:].any()


def test_phase_a_work_counts_every_feature_at_every_window():
    """K3 has no early exit: its bound counts every phase-A feature at
    every window of every level's grid, whatever the thresholds."""
    rng = np.random.default_rng(12)
    tables = tscd.cascade_tables(_port(_synth_cascade(rng, (2, 3, 4))))
    dims = np.array([[6, 9], [4, 5]])
    sat_l = torch.from_numpy(rng.normal(0, 10, (2, 8, 40, 52))
                             .astype(np.float32))
    flop, nbytes = tphase.phase_a_work(sat_l, tables, STEP, dims)
    assert flop == (6 * 9 + 4 * 5) * 9 * tkernel.FEATURE_FLOP
    assert nbytes == tkernel.io_bytes(sat_l, tables, dims)
