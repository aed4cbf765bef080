"""Port parity: core/algebra's small algebra, core/util (matrix utilities,
the sparse twin and its torch COO bridge) and core/numeric (FFT filter,
distance transform, kmeans1d, CG minimize, invert / solve / eigen), on
the CPU, against ccv_tpu on the same seeded inputs.

Tolerances: integer results and the distance transform's values and both
offset planes exactly; float32 algebra within 1e-6 relative; the FFT
filter within 1e-5 of the input's largest value; minimize at the known
optima (ccv_tpu's minimize does not reach them: the port follows the
reference's minimize.m, see test_minimize_rosenbrock); linear algebra by
residuals (1e-4) and eigenvectors up to sign (1e-4).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ccv_tpu.core import algebra as jalg
from ccv_tpu.core import numeric as jnum
from ccv_tpu.core import util as jutil
from ccv_tpu_torch.core import algebra, numeric, util
from ccv_tpu_torch.core.util import (SPARSE_COL_MAJOR, SparseMatrix,
                                     bcoo_to_sparse, sparse_to_bcoo)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def rng_mats():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((6, 5)).astype(np.float32),
            rng.standard_normal((5, 4)).astype(np.float32),
            rng.standard_normal((6, 4)).astype(np.float32))


@pytest.mark.parametrize("transpose", [0, 1, 2, 3, 7])
def test_gemm_equals_ccv_tpu(rng_mats, transpose):
    a, b, c = rng_mats
    if transpose & algebra.CCV_A_TRANSPOSE:
        a = np.ascontiguousarray(a.T)
    if transpose & algebra.CCV_B_TRANSPOSE:
        b = np.ascontiguousarray(b.T)
    if transpose & algebra.CCV_C_TRANSPOSE:
        c = np.ascontiguousarray(c.T)
    want = np.asarray(jalg.gemm(a, b, 0.5, transpose, c, 2.0))
    got = algebra.gemm(_t(a), _t(b), 0.5, transpose, _t(c), 2.0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_algebra_rest_equals_ccv_tpu(rng_mats):
    a, _, _ = rng_mats
    cc = np.random.default_rng(9).standard_normal(a.shape).astype(np.float32)
    ta, tc = _t(a), _t(cc)
    for flag in (1, 2):
        np.testing.assert_allclose(algebra.normalize(ta, flag=flag).numpy(),
                                   np.asarray(jalg.normalize(a, flag=flag)),
                                   rtol=1e-6)
    assert abs(float(algebra.dot(ta, tc)) - float(jalg.dot(a, cc))) < 1e-5
    assert abs(float(algebra.sum_(ta)) - float(jalg.sum_(a))) < 1e-5
    assert abs(float(algebra.variance(ta)) - float(jalg.variance(a))) < 1e-6
    u8 = np.arange(30, dtype=np.uint8).reshape(6, 5)
    assert int(algebra.sum_(_t(u8))) == int(jalg.sum_(u8))
    for name in ("multiply", "add", "subtract"):
        np.testing.assert_array_equal(
            getattr(algebra, name)(ta, tc).numpy(),
            np.asarray(getattr(jalg, name)(a, cc)))
    np.testing.assert_array_equal(algebra.scale(ta, 0.25).numpy(),
                                  np.asarray(jalg.scale(a, 0.25)))


@pytest.mark.parametrize("y,x,rows,cols", [(2, 3, 4, 5), (-3, -2, 6, 7),
                                           (5, 6, 8, 9), (20, 0, 3, 3)])
def test_slice_equals_ccv_tpu(y, x, rows, cols):
    a = np.arange(7 * 8 * 3, dtype=np.int32).reshape(7, 8, 3)
    np.testing.assert_array_equal(util.slice_(_t(a), y, x, rows, cols).numpy(),
                                  np.asarray(jutil.slice_(a, y, x, rows, cols)))


def test_util_ops_equal_ccv_tpu():
    rng = np.random.default_rng(1)
    a = rng.integers(0, 256, (5, 7, 3), dtype=np.uint8)
    np.testing.assert_array_equal(util.border(_t(a), (1, 2, 3, 4)).numpy(),
                                  np.asarray(jutil.border(a, (1, 2, 3, 4))))
    for s in (3, 0, -2):
        np.testing.assert_array_equal(util.shift(_t(a), s).numpy(),
                                      np.asarray(jutil.shift(a, s)))
    np.testing.assert_array_equal(util.flatten(_t(a)).numpy(),
                                  np.asarray(jutil.flatten(a)))
    np.testing.assert_array_equal(util.flatten(_t(a[..., 0])).numpy(),
                                  np.asarray(jutil.flatten(a[..., 0])))
    f = rng.standard_normal((6, 9)).astype(np.float32) * 40
    np.testing.assert_array_equal(util.visualize(_t(f)).numpy(),
                                  np.asarray(jutil.visualize(f)))
    assert not util.any_nan(_t(f))
    f[2, 3] = np.nan
    assert util.any_nan(_t(f)) and jutil.any_nan(f)
    z = util.zero((2, 3), torch.int32, device="cpu")
    assert z.dtype == torch.int32 and int(z.abs().sum()) == 0


def test_sparse_csr_round_trips():
    """tests/test_sparse.py's CSR and CSC cases on the port's twin."""
    mat = SparseMatrix(3, 3, dtype=np.float32)
    for (i, j), v in (((0, 0), 1.0), ((0, 2), 2.0), ((1, 2), 3.0),
                      ((2, 0), 4.0), ((2, 1), 5.0), ((2, 2), 6.0)):
        mat.set(i, j, v)
    csm = mat.compress()
    jm = jutil.SparseMatrix(3, 3, dtype=np.float32)
    for (i, j), v in mat.data.items():
        jm.set(i, j, v)
    jcsm = jm.compress()
    for field in ("index", "offset", "data"):
        np.testing.assert_array_equal(getattr(csm, field),
                                      getattr(jcsm, field))
    assert csm.nnz == 6
    np.testing.assert_array_equal(csm.decompress().to_dense(),
                                  mat.to_dense())
    col = SparseMatrix(4, 3, major=SPARSE_COL_MAJOR)
    col.set(0, 1, 1.0)
    col.set(2, 1, 2.0)
    col.set(3, 0, 3.0)
    assert col.vector(1) == {0: 1.0, 2: 2.0}
    assert list(col.vector_foreach(0)) == [(3, 3.0)]
    ccs = col.compress()
    np.testing.assert_array_equal(ccs.offset, [0, 1, 3, 3])
    np.testing.assert_array_equal(ccs.index, [3, 0, 2])
    np.testing.assert_array_equal(ccs.decompress().to_dense(), col.to_dense())
    multi = SparseMatrix(5, 5, channels=3)
    multi.set(1, 2, [1.0, 2.0, 3.0])
    back = SparseMatrix.from_dense(multi.to_dense())
    np.testing.assert_array_equal(back.get(1, 2), [1, 2, 3])
    np.testing.assert_array_equal(
        multi.compress().decompress().get(1, 2), [1, 2, 3])
    sym = util.compress_symmetric(mat)
    assert set(sym.data) == {(0, 0), (2, 0), (2, 1), (2, 2)}
    with pytest.raises(IndexError):
        mat.set(3, 0, 1.0)


def test_coo_bridge():
    rng = np.random.default_rng(2)
    dense = np.where(rng.random((12, 9)) < 0.2,
                     rng.standard_normal((12, 9)), 0).astype(np.float32)
    sp = SparseMatrix.from_dense(dense)
    coo = sparse_to_bcoo(sp, device="cpu")
    assert coo.is_sparse and coo.device.type == "cpu"
    assert coo._nnz() == int((dense != 0).sum())
    rhs = rng.standard_normal((9, 4)).astype(np.float32)
    np.testing.assert_allclose(torch.sparse.mm(coo, _t(rhs)).numpy(),
                               dense @ rhs, rtol=1e-5, atol=1e-5)
    jb = jutil.sparse_to_bcoo(sp)
    np.testing.assert_array_equal(coo.to_dense().numpy(),
                                  np.asarray(jb.todense()))
    np.testing.assert_array_equal(bcoo_to_sparse(coo).to_dense(), dense)
    assert sparse_to_bcoo(SparseMatrix(3, 4), device="cpu").shape == (3, 4)


def test_filter_equals_ccv_tpu():
    rng = np.random.default_rng(3)
    a = rng.uniform(0, 255, (37, 45)).astype(np.float32)
    k = rng.standard_normal((7, 5)).astype(np.float32)
    got = numeric.filter(_t(a), _t(k)).numpy()
    want = np.asarray(jnum.filter(a, k))
    assert got.shape == want.shape == a.shape
    assert float(np.abs(got - want).max()) <= 1e-5 * float(np.abs(a).max())


@pytest.mark.parametrize("args", [(), (0.5, -0.3, 2.0, 0.7)])
def test_distance_transform_equals_ccv_tpu(args, monkeypatch):
    rng = np.random.default_rng(4)
    a = rng.uniform(0, 60, (23, 31)).astype(np.float32)
    a[::5, ::4] = 0.0  # equal minima: argmin ties
    monkeypatch.setattr(numeric, "DT_CHUNK_BYTES", 4 * 31 * 31 * 3)
    got = [t.numpy() for t in numeric.distance_transform(_t(a), *args)]
    want = [np.asarray(t) for t in jnum.distance_transform(a, *args)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_kmeans1d_equals_ccv_tpu():
    rng = np.random.default_rng(5)
    v = np.concatenate([rng.normal(m, 0.3, 20) for m in (0, 3, 7)])
    got = numeric.kmeans1d(v, 3)
    want = jnum.kmeans1d(v, 3)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def _quadratic(np_mod):
    rng = np.random.default_rng(6)
    m = rng.standard_normal((6, 6)).astype(np.float32)
    A = (m @ m.T + 6 * np.eye(6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)

    def fn(x):
        Ax = np_mod.matmul(A if np_mod is jnp else torch.from_numpy(A), x)
        bb = b if np_mod is jnp else torch.from_numpy(b)
        return 0.5 * (x * Ax).sum() - (bb * x).sum(), Ax - bb
    return fn, np.linalg.solve(A, b)


def _rosenbrock(x):
    f = (1 - x[0]) ** 2 + 100 * (x[1] - x[0] ** 2) ** 2
    g0 = -2 * (1 - x[0]) - 400 * x[0] * (x[1] - x[0] ** 2)
    g1 = 200 * (x[1] - x[0] ** 2)
    if isinstance(x, torch.Tensor):
        return f, torch.stack([g0, g1])
    return f, jnp.stack([g0, g1])


def test_minimize_quadratic():
    """The exact optimum of a seeded 6-D convex quadratic, at least as low
    as ccv_tpu's minimize gets (which stops short: see the next test)."""
    fn_t, opt = _quadratic(torch)
    fn_j, _ = _quadratic(jnp)
    x, f = numeric.minimize(fn_t, torch.zeros(6), max_iter=50)
    _, fj = jnum.minimize(fn_j, np.zeros(6, np.float32), max_iter=50)
    np.testing.assert_allclose(x.numpy(), opt, atol=1e-4)
    assert f <= float(fj) + 1e-6


def test_minimize_rosenbrock():
    """Rosenbrock from (-1.2, 1) to (1, 1). ccv_tpu's minimize never
    returns here (it skips minimize.m's interpolation and does not
    re-evaluate between extrapolations), so the port is held to the
    optimum and to the reference's iteration budget."""
    x0 = np.array([-1.2, 1.0], np.float32)
    x, f = numeric.minimize(_rosenbrock, _t(x0), max_iter=100)
    np.testing.assert_allclose(x.numpy(), [1.0, 1.0], atol=1e-3)
    assert f < 1e-6


def test_linear_algebra_equals_ccv_tpu():
    rng = np.random.default_rng(7)
    m = rng.standard_normal((8, 8)).astype(np.float32)
    a = (m @ m.T + 8 * np.eye(8)).astype(np.float32)
    inv = numeric.invert(_t(a)).numpy()
    np.testing.assert_allclose(inv @ a, np.eye(8), atol=1e-4)
    np.testing.assert_allclose(inv, np.asarray(jnum.invert(a)), atol=1e-4)
    rect = rng.standard_normal((6, 4)).astype(np.float32)
    pinv = numeric.invert(_t(rect)).numpy()
    np.testing.assert_allclose(pinv @ rect, np.eye(4), atol=1e-4)
    b = rng.standard_normal((8, 2)).astype(np.float32)
    x = numeric.solve(_t(a), _t(b)).numpy()
    np.testing.assert_allclose(a @ x, b, atol=1e-4)
    np.testing.assert_allclose(x, np.asarray(jnum.solve(a, b)), atol=1e-4)
    over = rng.standard_normal((9, 3)).astype(np.float32)
    rhs = rng.standard_normal((9, 1)).astype(np.float32)
    xo = numeric.solve(_t(over), _t(rhs)).numpy()
    xj = np.asarray(jnum.solve(over, rhs))
    assert np.linalg.norm(over @ xo - rhs) <= np.linalg.norm(
        over @ xj - rhs) + 1e-4
    vec, lam = (t.numpy() for t in numeric.eigen(_t(a)))
    jvec, jlam = (np.asarray(t) for t in jnum.eigen(a))
    np.testing.assert_allclose(lam, jlam, rtol=1e-5)
    assert np.all(np.diff(lam) <= 0)
    for v, w in zip(vec, jvec):
        sign = np.sign(np.dot(v, w))
        np.testing.assert_allclose(v, sign * w, atol=1e-4)
    np.testing.assert_allclose(vec @ a @ vec.T, np.diag(lam), atol=1e-3)
