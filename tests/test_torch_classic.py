"""Port parity: the image primitives ICF, SWT and SIFT stand on
(ccv_tpu_torch/ops/basic.py's sobel windows and gradient,
ccv_tpu_torch/core/algebra.py's sat and scans, ccv_tpu_torch/ops/classic.py)
against ccv_tpu on the same seeded numpy inputs, on the CPU.

Integer outputs must be equal. Float outputs within 1e-5 relative (atol 0),
except the SAT and the scans: the port adds in ccv_tpu's order (XLA's
16-element tiles for cumsum, JAX's associative scan), so those must be
equal to the bit, which is what keeps the card's ICF features equal to the
CPU's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccv_tpu.core import algebra as jalgebra
from ccv_tpu.core.io import IO_GRAY, read
from ccv_tpu.ops import basic as jbasic
from ccv_tpu.ops import classic as jclassic
from ccv_tpu_torch.core import algebra
from ccv_tpu_torch.ops import basic, classic

DATA = os.path.join(os.path.dirname(__file__), "data")
RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _images():
    rng = np.random.default_rng(10)
    return {
        "gray": rng.integers(0, 256, (37, 53)).astype(np.uint8),
        "rgb": rng.integers(0, 256, (29, 41, 3)).astype(np.uint8),
        "float": (rng.normal(0, 40, (31, 27)) + 100).astype(np.float32),
    }


IMAGES = _images()
WINDOWS = [(3, 0), (0, 3), (1, 0), (0, 1), (5, 0), (0, 7), (1, 1), (-1, 1)]


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (
        got.shape, want.shape, got.dtype, want.dtype)
    if np.issubdtype(want.dtype, np.integer) or want.dtype == bool:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("window", WINDOWS, ids=str)
@pytest.mark.parametrize("name", sorted(IMAGES))
@pytest.mark.parametrize("out_float", [False, True])
def test_sobel_windows(window, name, out_float):
    a = IMAGES[name]
    want = jbasic.sobel(jnp.asarray(a), *window, out_float=out_float)
    got = basic.sobel(torch.from_numpy(a), *window, out_float=out_float)
    _close(got.numpy(), want)


def test_sobel_even_window_raises():
    with pytest.raises(ValueError, match="odd"):
        basic.sobel(torch.from_numpy(IMAGES["gray"]), 4, 0)


@pytest.mark.parametrize("name", sorted(IMAGES))
def test_gradient(name):
    a = IMAGES[name]
    t_want, m_want = jbasic.gradient(jnp.asarray(a))
    t_got, m_got = basic.gradient(torch.from_numpy(a))
    _close(t_got.numpy(), t_want)
    _close(m_got.numpy(), m_want)


def test_sqrt32_is_correctly_rounded():
    x = torch.from_numpy(np.random.default_rng(3).integers(
        0, 1 << 22, 50000).astype(np.float32))
    want = np.sqrt(x.numpy().astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(basic.sqrt32(x).numpy(), want)


SAT_SHAPES = [(37, 50), (181, 243, 10), (5, 17, 33, 3), (16, 16), (17, 1)]


@pytest.mark.parametrize("shape", SAT_SHAPES, ids=str)
@pytest.mark.parametrize("padding", [algebra.NO_PADDING,
                                     algebra.PADDING_ZERO])
@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_sat(shape, padding, dtype):
    rng = np.random.default_rng(sum(shape) + padding)
    x = (rng.normal(0, 100, shape).astype(np.float32) if dtype == "float32"
         else rng.integers(0, 256, shape).astype(np.uint8))
    want = np.asarray(jalgebra.sat(jnp.asarray(x), padding))
    got = algebra.sat(torch.from_numpy(x), padding).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)  # the same adds, in order


@pytest.mark.parametrize("n", [1, 2, 15, 16, 17, 64, 257, 1681])
def test_scans_add_in_ccv_tpus_order(n):
    x = np.random.default_rng(n).normal(0, 1, (9, n)).astype(np.float32)
    np.testing.assert_array_equal(
        algebra.tiled_cumsum(torch.from_numpy(x), -1).numpy(),
        np.asarray(jnp.cumsum(jnp.asarray(x), axis=-1)))
    np.testing.assert_array_equal(
        algebra.associative_scan_add(torch.from_numpy(x), -1).numpy(),
        np.asarray(jax.lax.associative_scan(jnp.add, jnp.asarray(x),
                                            axis=-1)))


@pytest.fixture(scope="module")
def text_band():
    """text_test.png's text band: real strokes and edges."""
    return np.array(read(os.path.join(DATA, "text_test.png"),
                         IO_GRAY).array)[96:304, 32:544]


@pytest.mark.parametrize("low,high", [(124, 204), (36, 108), (60, 60)])
def test_canny(text_band, low, high):
    want = np.asarray(jclassic.canny(jnp.asarray(text_band), 3, low, high))
    got = classic.canny(torch.from_numpy(text_band), 3, low, high).numpy()
    assert want.sum() > 100
    _close(got, want)


def test_canny_long_hysteresis_chain():
    """A weak ramp seeded at one end only: the fixpoint takes many more
    dilations than one test's SWEEPS."""
    img = np.zeros((12, 200), np.uint8)
    img[6:, :] = np.linspace(40, 60, 200).astype(np.uint8)[None, :]
    img[6:, :4] = 250
    want = np.asarray(jclassic.canny(jnp.asarray(img), 3, 36, 108))
    got = classic.canny(torch.from_numpy(img), 3, 36, 108).numpy()
    assert want.sum() > 4 * classic.SWEEPS
    _close(got, want)


def test_canny_needs_one_channel():
    with pytest.raises(ValueError, match="single-channel"):
        classic.canny(torch.from_numpy(IMAGES["rgb"]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_close_outline(seed):
    a = (np.random.default_rng(seed).random((40, 45)) < 0.2).astype(np.uint8)
    _close(classic.close_outline(torch.from_numpy(a)).numpy(),
           jclassic.close_outline(jnp.asarray(a)))


@pytest.mark.parametrize("shape,hi,range_", [
    ((120, 130), 200, 256), ((50, 60), 40, 64), ((7, 9), 256, 256)])
def test_otsu(shape, hi, range_):
    a = np.random.default_rng(hi).integers(0, hi, shape).astype(np.uint8)
    t_want, v_want = jclassic.otsu(jnp.asarray(a), range_)
    t_got, v_got = classic.otsu(torch.from_numpy(a), range_)
    assert int(t_got) == int(t_want)
    np.testing.assert_allclose(float(v_got), float(v_want), rtol=RTOL)
