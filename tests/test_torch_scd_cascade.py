"""Port parity: the cascade evaluator (kernel K1's plain PyTorch version)
against ccv_tpu's Pallas kernel run in interpret mode, and the cascade
tables against ccv_tpu's loader.

Survivor sets must agree wherever every stage sum is more than 1e-4 from
its threshold (float noise near a threshold may flip a window); final-stage
confidences of windows both keep agree to atol=2e-4, rtol=1e-5.
"""

import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccv_tpu.detectors import scd as jscd
from ccv_tpu.ops.pallas import scd_cascade as jkernel
from ccv_tpu_torch.detectors import scd as tscd
from ccv_tpu_torch.ops.kernels import scd_cascade as tkernel

DATA = os.path.join(os.path.dirname(__file__), "data")
STEP = 4
MARGIN = 1e-4


def _synth_cascade(rng, feats_per_stage=(2, 3, 4, 5), wh=16):
    F = sum(feats_per_stage)
    sx = rng.integers(0, wh - 4, (F, 4)).astype(np.int32)
    sy = rng.integers(0, wh - 4, (F, 4)).astype(np.int32)
    dx = (sx + rng.integers(2, 5, (F, 4))).astype(np.int32)
    dy = (sy + rng.integers(2, 5, (F, 4))).astype(np.int32)
    n_stages = len(feats_per_stage)
    return jscd.ScdClassifierCascade(
        width=wh, height=wh, margin=(0, 0, 0, 0),
        stage_counts=np.asarray(feats_per_stage, np.int32),
        thresholds=np.zeros(n_stages, np.float32),
        sx=sx, sy=sy, dx=dx, dy=dy,
        bias=rng.normal(0, 0.5, F).astype(np.float32),
        w=rng.normal(0, 1, (F, 32)).astype(np.float32),
        stage_of=np.repeat(np.arange(n_stages),
                           feats_per_stage).astype(np.int32))


def _layout_cascade(rng, feats_per_stage=(3, 4, 5), wh=24):
    """A synthetic cascade whose features have the box layouts of SCD's
    feature generator (ccv_tpu.train.scd.stump_features): 4 boxes in a
    column, in a row, or in a 2 x 2 grid, in the generator's box order."""
    F = sum(feats_per_stage)
    sx, sy, dx, dy = (np.zeros((F, 4), np.int32) for _ in range(4))
    for f in range(F):
        kind = f % 3
        q = int(rng.integers(1, 4))
        if kind == 0:    # 1x4: a column of boxes q high, w wide
            w = int(rng.integers(2, 7))
            x, y = rng.integers(0, wh - w), rng.integers(0, wh - 4 * q)
            boxes = [(x, y + i * q, x + w, y + (i + 1) * q) for i in range(4)]
        elif kind == 1:  # 4x1: a row of boxes q wide, h high
            h = int(rng.integers(2, 7))
            x, y = rng.integers(0, wh - 4 * q), rng.integers(0, wh - h)
            boxes = [(x + i * q, y, x + (i + 1) * q, y + h) for i in range(4)]
        else:            # 2x2
            hw, hh = int(rng.integers(1, 6)), int(rng.integers(1, 6))
            x, y = rng.integers(0, wh - 2 * hw), rng.integers(0, wh - 2 * hh)
            boxes = [(x, y, x + hw, y + hh), (x, y + hh, x + hw, y + 2 * hh),
                     (x + hw, y, x + 2 * hw, y + hh),
                     (x + hw, y + hh, x + 2 * hw, y + 2 * hh)]
        for b, (bx0, by0, bx1, by1) in enumerate(boxes):
            sx[f, b], sy[f, b], dx[f, b], dy[f, b] = bx0, by0, bx1, by1
    c = _synth_cascade(rng, feats_per_stage, wh)
    return dataclasses.replace(c, sx=sx, sy=sy, dx=dx, dy=dy)


def _fields(cascade):
    return {f.name: getattr(cascade, f.name)
            for f in dataclasses.fields(cascade)}


def _tables(cascade):
    return tscd.cascade_tables(tscd.cascade_from_numpy(_fields(cascade)))


def _median_thresholds(jcascade, sat_l, dims):
    """Set every stage threshold at the median of the plain version's stage
    sums, so each stage kills real windows (the early-exit path runs)."""
    vs = tkernel.cascade_stage_sums_ref(sat_l, _tables(jcascade), STEP, dims)
    jcascade.thresholds[:] = [float(vs[:, s].median())
                              for s in range(jcascade.n_stages)]


def _jax_eval(jcascade, sat_levels, dims):
    """ccv_tpu's kernel in interpret mode, as tests/test_scd_kernel.py runs
    it: per level (conf (ny, nx), passed (ny, nx))."""
    tabs = jscd._cascade_tables(jcascade)
    full = jscd._full_phase(tabs, jcascade)
    th = int(tabs["all_off"][:, 0].max()) // STEP + 1
    tw = int(tabs["all_off"][:, 1].max()) // STEP + 1
    gy, gx, hs_pad, ws_pad = jkernel.pad_dims(
        int(dims[:, 0].max()), int(dims[:, 1].max()), th, tw)
    planes = [jscd._planes_cf(jnp.asarray(s), hs_pad, ws_pad, STEP)
              for s in sat_levels]
    if len(planes) == 1:
        ny, nx = (int(v) for v in dims[0])
        conf, passed = jax.device_get(jkernel.cascade_eval(
            planes[0], full, STEP, ny, nx, th, tw, gy, gx))
        return [(conf.reshape(ny, nx), passed.reshape(ny, nx))]
    conf, passed = jax.device_get(jkernel.cascade_eval_levels(
        jnp.stack(planes), full, STEP, dims, th, tw, gy, gx))
    return [(conf[li, :ny, :nx], passed[li, :ny, :nx])
            for li, (ny, nx) in enumerate(dims)]


def _stack(sat_levels):
    H1 = max(s.shape[1] for s in sat_levels)
    W1 = max(s.shape[2] for s in sat_levels)
    out = np.zeros((len(sat_levels), 8, H1, W1), np.float32)
    for i, s in enumerate(sat_levels):
        out[i, :, :s.shape[1], :s.shape[2]] = s
    return torch.from_numpy(out)


def _assert_agree(vs, thresholds, conf_a, passed_a, conf_b, passed_b):
    """Survivors equal outside the margin, confidences close where both
    pass. vs: (S, ny, nx) stage sums of the plain version."""
    margin_ok = (np.abs(vs - thresholds[:, None, None]) > MARGIN).all(axis=0)
    assert passed_a.any(), "no survivors: the comparison is vacuous"
    np.testing.assert_array_equal(passed_a[margin_ok], passed_b[margin_ok])
    both = passed_a & passed_b
    assert both.any()
    np.testing.assert_allclose(conf_a[both], conf_b[both], atol=2e-4,
                               rtol=1e-5)


SHAPES = {"11x21": [[11, 21]], "8x128": [[8, 128]], "17x140": [[17, 140]],
          "multi_level": [[13, 140], [9, 100], [5, 60]]}


@pytest.mark.parametrize("dims", list(SHAPES.values()), ids=list(SHAPES))
def test_plain_cascade_matches_jax_kernel(dims):
    rng = np.random.default_rng(7)
    jcascade = _synth_cascade(rng)
    dims = np.asarray(dims)
    sat_levels = []
    for ny, nx in dims:
        H1 = (ny - 1) * STEP + jcascade.height + 1
        W1 = (nx - 1) * STEP + jcascade.width + 1
        sat_levels.append(rng.normal(0, 10, (8, H1, W1)).astype(np.float32))
    sat_l = _stack(sat_levels)
    _median_thresholds(jcascade, sat_l, dims)

    tables = _tables(jcascade)
    vs = tkernel.cascade_stage_sums_ref(sat_l, tables, STEP, dims).numpy()
    conf, passed = tkernel.cascade_eval_levels_ref(sat_l, tables, STEP, dims)
    conf, passed = conf.numpy(), passed.numpy()
    want = _jax_eval(jcascade, sat_levels, dims)
    for li, (ny, nx) in enumerate(dims):
        _assert_agree(vs[li, :, :ny, :nx], tables.thresholds,
                      conf[li, :ny, :nx], passed[li, :ny, :nx],
                      want[li][0], want[li][1])
        assert not passed[li, ny:].any() and not passed[li, :, nx:].any()


def test_wrapper_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(5)
    jcascade = _synth_cascade(rng)
    dims = np.array([[6, 9], [4, 5]])
    sat_l = torch.from_numpy(rng.normal(0, 10, (2, 8, 40, 52))
                             .astype(np.float32))
    tables = _tables(jcascade)
    before = tkernel.LAUNCHES
    conf, passed = tkernel.cascade_eval_levels(sat_l, tables, STEP, dims)
    ref_conf, ref_passed = tkernel.cascade_eval_levels_ref(sat_l, tables,
                                                           STEP, dims)
    assert tkernel.LAUNCHES == before  # no kernel launched for a CPU tensor
    assert conf.shape == passed.shape == (2, 6, 9)
    assert passed.dtype == torch.bool
    torch.testing.assert_close(conf, ref_conf, rtol=0, atol=0)
    assert torch.equal(passed, ref_passed)


def test_cascade_work_counts_the_stages_each_window_reaches():
    """K1's bound counts, for each window of each level's grid, the
    features of every stage it reaches (the early exit stops after the
    first stage whose plain sum is not above its threshold): a brute-force
    walk over the windows gives the same count."""
    rng = np.random.default_rng(11)
    jcascade = _synth_cascade(rng)
    dims = np.array([[6, 9], [4, 5]])
    sat_l = torch.from_numpy(rng.normal(0, 10, (2, 8, 40, 52))
                             .astype(np.float32))
    _median_thresholds(jcascade, sat_l, dims)
    tables = _tables(jcascade)
    vs = tkernel.cascade_stage_sums_ref(sat_l, tables, STEP, dims).numpy()
    counts = [f1 - f0 for f0, f1 in tables.stage_ranges]
    want = 0
    for li, (ny, nx) in enumerate(dims):
        for y in range(ny):
            for x in range(nx):
                for s, n in enumerate(counts):
                    want += n
                    if not vs[li, s, y, x] > tables.thresholds[s]:
                        break
    windows = int((dims[:, 0] * dims[:, 1]).sum())
    assert counts[0] * windows < want < sum(counts) * windows  # exits ran
    flop, nbytes = tkernel.cascade_work(sat_l, tables, STEP, dims)
    assert flop == want * tkernel.FEATURE_FLOP
    assert nbytes == (sat_l.numel() * 4 + tables.n_features * 4 * 49
                      + tables.n_stages * 8 + 2 * 6 * 9 * 5)
    # the same count from precomputed sums; open thresholds reach all
    assert tkernel.cascade_work(sat_l, tables, STEP, dims,
                                torch.from_numpy(vs))[0] == flop
    tables.thresholds[:] = -1e9
    assert tkernel.cascade_work(sat_l, tables, STEP, dims)[0] == (
        sum(counts) * windows * tkernel.FEATURE_FLOP)


def test_wrapper_rejects_bad_input():
    tables = _tables(_synth_cascade(np.random.default_rng(1)))
    good = torch.zeros((1, 8, 40, 40))
    with pytest.raises(TypeError):
        tkernel.cascade_eval_levels(good.double(), tables, STEP, [[2, 2]])
    with pytest.raises(ValueError):
        tkernel.cascade_eval_levels(good[:, :7], tables, STEP, [[2, 2]])
    with pytest.raises(ValueError):
        tkernel.cascade_eval_levels(good.transpose(2, 3), tables, STEP,
                                    [[2, 2]])
    with pytest.raises(ValueError):  # windows past the SAT
        tkernel.cascade_eval_levels(good, tables, STEP, [[11, 2]])
    with pytest.raises(ValueError):
        tkernel.cascade_eval_levels(good, tables, STEP, [[2, 2], [1, 1]])


def test_build_tables_requires_contiguous_stages():
    c = _synth_cascade(np.random.default_rng(2), feats_per_stage=(2, 2))
    stage_of = np.array([0, 1, 0, 1], np.int32)
    with pytest.raises(ValueError, match="contiguous"):
        tkernel.build_tables(c.thresholds, c.sx, c.sy, c.dx, c.dy, c.bias,
                             c.w, stage_of)
    t = tkernel.build_tables(c.thresholds, c.sx, c.sy, c.dx, c.dy, c.bias,
                             c.w, c.stage_of)
    assert t.stage_ranges == ((0, 2), (2, 4))


def test_load_cascade_matches_jax():
    path = os.path.join(DATA, "face_low.sqlite3")
    want = jscd.load_cascade(path)
    got = tscd.load_cascade(path)
    assert (got.width, got.height, tuple(got.margin)) == (
        want.width, want.height, tuple(want.margin))
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, f.name)
    assert got.n_features == 318
    assert list(got.stage_counts) == [4, 4, 4, 49, 89, 168]
    tables = tscd.cascade_tables(got)
    assert tables.stage_ranges[-1] == (150, 318)
    assert tables.extent == (48, 48)


def test_cascade_from_numpy_matches_jax():
    want = jscd.load_cascade(os.path.join(DATA, "face_low.sqlite3"))
    got = tscd.cascade_from_numpy(_fields(want))
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, f.name)
            assert not np.shares_memory(a, b), f.name
        else:
            assert tuple(np.atleast_1d(a)) == tuple(np.atleast_1d(b)), f.name


PLANE_SHAPES = {  # (L, H1, W1, plane rows, plane cols); None: ceil
    "41x53": (1, 41, 53, None, None), "40x52x2": (2, 40, 52, None, None),
    "37x64x3": (3, 37, 64, None, None), "41x53_crop": (1, 41, 53, 9, 12),
    "37x64x3_crop_pad": (3, 37, 64, 10, 15)}


@pytest.mark.parametrize("shape", list(PLANE_SHAPES.values()),
                         ids=list(PLANE_SHAPES))
def test_phase_planes_match_jax(shape):
    """The kernel's input layout is ccv_tpu's phase planes, level by level,
    zero-padded where H1 or W1 is not a multiple of the step, or cropped
    and padded to the rows and columns asked for."""
    L, H1, W1, rows, cols = shape
    sat = np.random.default_rng(H1).normal(0, 10, (L, 8, H1, W1)).astype(
        np.float32)
    got = tkernel.phase_planes(torch.from_numpy(sat), STEP, rows, cols)
    hs = -(-H1 // STEP) if rows is None else rows
    ws = -(-W1 // STEP) if cols is None else cols
    assert got.shape == (L, STEP * STEP, 8, hs, ws) and got.is_contiguous()
    for li in range(L):
        want = np.asarray(jscd._planes_cf(jnp.asarray(sat[li]), hs, ws, STEP))
        np.testing.assert_array_equal(got[li].numpy(), want)


CORNER_CASCADES = {
    "face": lambda: jscd.load_cascade(os.path.join(DATA, "face_low.sqlite3")),
    "synthetic": lambda: _synth_cascade(np.random.default_rng(3)),
    "scd_layouts": lambda: _layout_cascade(np.random.default_rng(4)),
}


@pytest.mark.parametrize("make", list(CORNER_CASCADES.values()),
                         ids=list(CORNER_CASCADES))
def test_corner_tables_match_jax_phase_tables(make):
    """Each feature's distinct corners are the corners ccv_tpu's
    _phase_tables gives its boxes, and each box's 4 indices pick the corners
    (sy,sx), (sy,dx), (dy,sx), (dy,dx) that ccv_tpu's do."""
    jcascade = make()
    tables = _tables(jcascade)
    F = tables.n_features
    phase = jscd._phase_tables(jcascade, np.arange(F))
    offsets = np.asarray(phase["offsets"])
    want = offsets[np.asarray(phase["cidx"]).reshape(F, 4, 4)]  # (F,4,4,2)
    for f in range(F):
        n = tables.n_corners[f]
        got = tables.corners[f, :n]
        assert len({tuple(c) for c in got.tolist()}) == n  # distinct
        assert ({tuple(c) for c in got.tolist()}
                == {tuple(c) for c in want[f].reshape(-1, 2).tolist()})
        np.testing.assert_array_equal(got[tables.cidx[f]], want[f])
        assert (tables.corners[f, n:] == 0).all()
        slots = tuple(tables.cidx[f].reshape(-1).tolist())
        assert tables.layout[f] == {v: k for k, v in
                                    tkernel.LAYOUTS.items()}.get(slots, 0)


def test_corner_layouts_of_the_cascades():
    """Every feature of the face cascade, and of a cascade of SCD's
    generator layouts, has one of the kernel's three layouts (9 or 10
    distinct corners); random boxes mostly have none."""
    face = _tables(jscd.load_cascade(os.path.join(DATA, "face_low.sqlite3")))
    assert sorted(np.bincount(face.layout).tolist()) == [0, 76, 106, 136]
    assert set(face.n_corners.tolist()) == {9, 10}
    lay = _tables(_layout_cascade(np.random.default_rng(4)))
    np.testing.assert_array_equal(lay.layout,
                                  [1, 2, 3] * (lay.n_features // 3))
    rand = _tables(_synth_cascade(np.random.default_rng(3)))
    assert (rand.layout == 0).mean() > 0.5


def test_layouts_match_the_kernel_source():
    """LAYOUTS is the table compiled into csrc/scd_cascade.cu: the build's
    SCD_LAYOUT_SLOTS flag holds layouts 1.. in order, 16 slots of 4 bits
    each, slot 0 lowest (the kernel prepends layout 0, the box order), and
    no comma, at which nvcc would split it."""
    (flag,) = tkernel.layout_flags()
    name, value = flag.split("=")
    assert name == "-DSCD_LAYOUT_SLOTS" and "," not in value
    codes = [int(c, 16) for c in re.findall(r"SCD_SLOT\((0x[0-9a-f]+)ull\)",
                                            value)]
    assert value == "".join(f"SCD_SLOT({c:#018x}ull)" for c in codes)
    assert len(codes) == len(tkernel.LAYOUTS)
    for key, code in enumerate(codes, start=1):
        assert tuple((code >> (4 * i)) & 15 for i in range(16)) == (
            tkernel.LAYOUTS[key])
    assert sum(s << (4 * i) for i, s in enumerate(tkernel.BOX_ORDER)) == (
        0xfedcba9876543210)


@pytest.mark.parametrize("make", [CORNER_CASCADES["face"],
                                  CORNER_CASCADES["scd_layouts"],
                                  CORNER_CASCADES["synthetic"]],
                         ids=["face", "scd_layouts", "synthetic"])
def test_box_corners_through_the_planes(make):
    """The kernel's addressing: every box corner read through the phase
    planes, as planes[l, p, c, wy + oy//4, wx + ox//4] and as the flat
    offsets of ``records`` (the layout's box slots into the distinct
    corners; layout 0: the 16 corners in box order), is
    sat[l, c, wy*4 + oy, wx*4 + ox], at every window of a small grid."""
    tables = _tables(make())
    ey, ex = tables.extent
    dims = np.array([[5, 7], [3, 4]])
    H1, W1 = 4 * 4 + ey + 2, 6 * 4 + ex + 3
    sat = torch.from_numpy(np.random.default_rng(9).normal(
        0, 10, (2, 8, H1, W1)).astype(np.float32))
    tkernel._check(sat, tables, STEP, dims)
    # the rows and columns the wrapper asks for: those the windows read
    planes = tkernel.kernel_planes(sat, tables, STEP, dims)
    assert planes.shape[3:] == (5 + ey // STEP, 7 + ex // STEP)
    _L, n_planes, _C, hs, ws = planes.shape
    cp = tables.corner_planes(STEP)
    recs = tables.records(STEP, hs, ws)
    np.testing.assert_array_equal(recs[:, 0], tables.layout)
    flat = planes.reshape(2, -1)
    chan = hs * ws
    for f in range(tables.n_features):
        lay = int(tables.layout[f])
        for j in range(16):
            k = int(tables.cidx[f].reshape(-1)[j])
            oy, ox = (int(v) for v in tables.corners[f, k])
            p, ry, rx = (int(v) for v in cp[f, k])
            rec = recs[f, 1 + (tkernel.LAYOUTS[lay][j] if lay else j)]
            for li, (ny, nx) in enumerate(dims):
                want = sat[li, :, oy:oy + 4 * ny:4, ox:ox + 4 * nx:4]
                got = planes[li, p, :, ry:ry + ny, rx:rx + nx]
                assert torch.equal(got, want)
                at = (torch.arange(ny)[:, None] * ws
                      + torch.arange(nx)[None, :])
                idx = (at[None] + int(rec)
                       + torch.arange(8)[:, None, None] * chan)
                assert torch.equal(flat[li][idx], want)


@pytest.mark.cuda
@pytest.mark.parametrize("dims", list(SHAPES.values()), ids=list(SHAPES))
def test_cuda_kernel_matches_plain_on_scd_layouts(dims):
    """The kernel on a cascade of SCD's three box layouts (its
    distinct-corner paths) at median thresholds, against its plain
    version on the same SAT on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(12)
    jcascade = _layout_cascade(rng)
    dims = np.asarray(dims)
    H1 = (dims[:, 0].max() - 1) * STEP + jcascade.height + 1
    W1 = (dims[:, 1].max() - 1) * STEP + jcascade.width + 1
    sat_l = torch.from_numpy(rng.normal(0, 10, (len(dims), 8, H1, W1))
                             .astype(np.float32)).cuda()
    _median_thresholds(jcascade, sat_l, dims)
    tables = _tables(jcascade)
    vs = tkernel.cascade_stage_sums_ref(sat_l, tables, STEP, dims)
    ref = tkernel.cascade_eval_levels_ref(sat_l, tables, STEP, dims)
    before = tkernel.LAUNCHES
    got = tkernel.cascade_eval_levels(sat_l, tables, STEP, dims)
    torch.cuda.synchronize()
    assert tkernel.LAUNCHES == before + 1
    for li, (ny, nx) in enumerate(dims):
        _assert_agree(vs[li, :, :ny, :nx].cpu().numpy(), tables.thresholds,
                      ref[0][li, :ny, :nx].cpu().numpy(),
                      ref[1][li, :ny, :nx].cpu().numpy(),
                      got[0][li, :ny, :nx].cpu().numpy(),
                      got[1][li, :ny, :nx].cpu().numpy())
        assert not got[1][li, ny:].any() and not got[1][li, :, nx:].any()


# (dims, features per stage): the last has 1,100 features, more than the
# 512 whose records a block holds at once, so the kernel stages them in
# runs (one stage across a run's end)
CUDA_CASES = {**{k: (v, (2, 3, 4, 5)) for k, v in SHAPES.items()},
              "1100_features": ([[9, 37], [6, 20]], (100, 700, 300))}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CUDA_CASES.values()),
                         ids=list(CUDA_CASES))
def test_cuda_kernel_matches_plain(case):
    """The hand-written kernel against its plain version on the same SAT on
    the card (run by chip_smoke.py as well, at the main path's shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dims, counts = case
    rng = np.random.default_rng(11)
    jcascade = _synth_cascade(rng, counts)
    dims = np.asarray(dims)
    H1 = (dims[:, 0].max() - 1) * STEP + jcascade.height + 1
    W1 = (dims[:, 1].max() - 1) * STEP + jcascade.width + 1
    sat_l = torch.from_numpy(rng.normal(0, 10, (len(dims), 8, H1, W1))
                             .astype(np.float32)).cuda()
    _median_thresholds(jcascade, sat_l, dims)
    tables = _tables(jcascade)
    vs = tkernel.cascade_stage_sums_ref(sat_l, tables, STEP, dims)
    ref = tkernel.cascade_eval_levels_ref(sat_l, tables, STEP, dims)
    before = tkernel.LAUNCHES
    got = tkernel.cascade_eval_levels(sat_l, tables, STEP, dims)
    torch.cuda.synchronize()
    assert tkernel.LAUNCHES == before + 1
    for li, (ny, nx) in enumerate(dims):
        _assert_agree(vs[li, :, :ny, :nx].cpu().numpy(), tables.thresholds,
                      ref[0][li, :ny, :nx].cpu().numpy(),
                      ref[1][li, :ny, :nx].cpu().numpy(),
                      got[0][li, :ny, :nx].cpu().numpy(),
                      got[1][li, :ny, :nx].cpu().numpy())
