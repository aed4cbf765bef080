"""Port parity: image I/O and the image ops of the SCD path.

The same inputs go through ``ccv_tpu`` (JAX on the CPU) and
``ccv_tpu_torch`` (PyTorch on the CPU). Integer paths must agree bit for
bit; float32-input paths agree to 1e-6 relative (two float32 matmuls
summed in another order).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccv_tpu.core import io as jio
from ccv_tpu.detectors import scd as jscd
from ccv_tpu.ops import basic as jbasic
from ccv_tpu.ops import resample as jresample
from ccv_tpu_torch.core import io as tio
from ccv_tpu_torch.ops import basic as tbasic
from ccv_tpu_torch.ops import resample as tresample

DATA = os.path.join(os.path.dirname(__file__), "data")
IMAGES = ("crop180.png", "crop120.png", "text_test.png")
FLAGS = (0, jio.IO_RGB_COLOR, jio.IO_GRAY)


def _jax_image(name, flags):
    return np.array(jio.read(os.path.join(DATA, name), flags).numpy())


@pytest.fixture(scope="module", params=[(n, f) for n in IMAGES
                                        for f in (jio.IO_RGB_COLOR, 0)],
                ids=lambda p: f"{p[0]}-{p[1]:#x}")
def image(request):
    return _jax_image(*request.param)


def _level_scales(shape):
    cascade = jscd.ScdClassifierCascade(
        width=48, height=48, margin=(0, 0, 0, 0),
        stage_counts=np.ones(1, np.int32), thresholds=np.zeros(1, np.float32),
        sx=None, sy=None, dx=None, dy=None, bias=np.zeros(1, np.float32),
        w=None, stage_of=None)
    specs, _ = jscd._level_specs(shape[0], shape[1], cascade,
                                 jscd.ScdParams())
    return [(rows, cols) for (o, k, rows, cols, _ny, _nx, _s) in specs
            if o == 0 and k > 0]


@pytest.mark.parametrize("name", IMAGES)
@pytest.mark.parametrize("flags", FLAGS)
def test_read_matches_jax(name, flags):
    want = _jax_image(name, flags)
    got = tio.read(os.path.join(DATA, name), flags, device="cpu")
    assert got.tensor.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.rows, got.cols) == want.shape[:2]


def test_read_ccv_binary_matches_jax():
    path = os.path.join(DATA, "crop180.scdmap.bin")
    want = jio.read(path).numpy()
    got = tio.read(path, device="cpu").numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("libpng", [False, True])
def test_rgb_to_gray_u8_matches_jax(libpng):
    rgb = np.random.default_rng(0).integers(0, 256, (37, 53, 3), np.uint8)
    np.testing.assert_array_equal(tio.rgb_to_gray_u8(rgb, libpng),
                                  jio.rgb_to_gray_u8(rgb, libpng))


@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("color,channels", [(0, 1), (2, 3), (6, 4)])
def test_decode_png_every_filter(filter_type, color, channels):
    """A PNG written here with one filter type on every row decodes to the
    pixels it was made from."""
    import struct
    import zlib

    rng = np.random.default_rng(filter_type * 7 + color)
    h, w = 9, 13
    img = rng.integers(0, 256, (h, w * channels), np.int64)
    rows, prior = [], np.zeros(w * channels, np.int64)
    for y in range(h):
        cur = img[y]
        left = np.concatenate([np.zeros(channels, np.int64), cur[:-channels]])
        upleft = np.concatenate([np.zeros(channels, np.int64),
                                 prior[:-channels]])
        if filter_type == 0:
            pred = np.zeros_like(cur)
        elif filter_type == 1:
            pred = left
        elif filter_type == 2:
            pred = prior
        elif filter_type == 3:
            pred = (left + prior) >> 1
        else:
            p = left + prior - upleft
            pa, pb, pc = abs(p - left), abs(p - prior), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prior, upleft))
        rows.append(bytes([filter_type]) + bytes(((cur - pred) & 0xFF)
                                                 .astype(np.uint8)))
        prior = cur

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    data = (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))
    got = tio.decode_png(data)
    want = img.astype(np.uint8).reshape(h, w, channels)
    np.testing.assert_array_equal(got, want[..., 0] if channels == 1 else want)


def test_blur_matches_jax(image):
    want = np.asarray(jbasic.blur(jnp.asarray(image), sigma=0.5))
    got = tbasic.blur(torch.from_numpy(image), sigma=0.5)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dx,dy", [(1, 0), (0, 1), (1, 1), (-1, 1),
                                   (-1, -1), (1, -1)])
def test_sobel_matches_jax(image, dx, dy):
    # crop to a non-square image so row and column rules cannot swap
    a = image[: image.shape[0] - 17]
    want = np.asarray(jbasic.sobel(jnp.asarray(a), dx, dy))
    got = tbasic.sobel(torch.from_numpy(a), dx, dy)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_resample_area_8u_matches_jax(image):
    H, W = image.shape[:2]
    scales = _level_scales(image.shape)
    assert scales
    for rows, cols in scales:
        want = np.asarray(jresample.resample(
            jnp.asarray(image), rows=rows, cols=cols, rows_scale=rows / H,
            cols_scale=cols / W, interp=jresample.INTER_AREA))
        got = tresample.resample(
            torch.from_numpy(image), rows=rows, cols=cols,
            rows_scale=rows / H, cols_scale=cols / W,
            interp=tresample.INTER_AREA)
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), want, f"{rows}x{cols}")


def test_resample_area_float_weights_matches_jax(image):
    """A uint8 image shrunk 16x or more takes the unquantized float path,
    rounded with floor(v + 0.5). Where the exact value v is a .5 tie (a
    chessboard averages to 127.5), float32 rounding in either summation
    order can fall on either side: there the two may differ by 1; the port
    sums in float64 and rounds the tie up. Everywhere else: bit-exact."""
    H, W = image.shape[:2]
    rows, cols = H // 17, W // 19
    want = np.asarray(jresample.resample(jnp.asarray(image), rows=rows,
                                         cols=cols)).astype(np.int64)
    got = tresample.resample(torch.from_numpy(image), rows=rows, cols=cols)
    got = got.numpy().astype(np.int64)
    wy = jresample.area_weights(rows, H, rows / H, quantize=False)
    wx = jresample.area_weights(cols, W, cols / W, quantize=False)
    exact = np.einsum("jx,ixc->ijc", wx, np.einsum(
        "iy,yxc->ixc", wy, image.reshape(H, W, -1).astype(np.float64)))
    exact = exact.reshape(got.shape)
    tie = np.abs(exact - np.floor(exact) - 0.5) < 1e-3
    np.testing.assert_array_equal(got[~tie], want[~tie])
    assert np.abs(got - want)[tie].max(initial=0) <= 1
    np.testing.assert_array_equal(got[tie], np.floor(exact[tie] + 0.5))


def test_resample_area_float32_matches_jax(image):
    x = image.astype(np.float32)
    H, W = image.shape[:2]
    for rows, cols in _level_scales(image.shape)[:2]:
        want = np.asarray(jresample.resample(jnp.asarray(x), rows=rows,
                                             cols=cols))
        got = tresample.resample(torch.from_numpy(x), rows=rows, cols=cols)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-4)


def test_sample_down_matches_jax(image):
    a = image
    for _ in range(3):  # the octave chain, including odd sizes
        want = np.array(jresample.sample_down(jnp.asarray(a)))
        got = tresample.sample_down(torch.from_numpy(a)).numpy()
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
        a = want[:-1] if a.shape[0] % 2 == 0 else want


def test_sample_down_float_matches_jax():
    x = np.random.default_rng(1).normal(0, 50, (23, 30, 2)).astype(np.float32)
    want = np.asarray(jresample.sample_down(jnp.asarray(x)))
    got = tresample.sample_down(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_unported_windows_raise():
    """Every odd window is ported now (the 3x3 and Gaussian-derivative
    windows are held to ccv_tpu in tests/test_torch_classic.py); an even
    window, which ccv_sobel does not define, still raises."""
    a = torch.zeros((8, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="odd"):
        tbasic.sobel(a, 4, 0)
