"""Port parity: the cascade evaluator (kernel K1's plain PyTorch version)
against ccv_tpu's Pallas kernel run in interpret mode, and the cascade
tables against ccv_tpu's loader.

Survivor sets must agree wherever every stage sum is more than 1e-4 from
its threshold (float noise near a threshold may flip a window); final-stage
confidences of windows both keep agree to atol=2e-4, rtol=1e-5.
"""

import dataclasses
import os

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


@pytest.mark.cuda
@pytest.mark.parametrize("dims", list(SHAPES.values()), ids=list(SHAPES))
def test_cuda_kernel_matches_plain(dims):
    """The hand-written kernel against its plain version on the same SAT on
    the card (run by chip_smoke.py as well, at the main path's shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(11)
    jcascade = _synth_cascade(rng)
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
