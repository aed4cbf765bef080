"""Port parity: image I/O beyond 8-bit PNG and libjpeg (core/io.py).

ccv_tpu_torch.core.io decodes in ccv_tpu's order, the native decoders first
(its own PNG decoder, libjpeg), then PIL; ``DECODED`` counts the routes.
Each file here is written into ``tmp_path`` from seeded numpy pixels and
read by both packages with the same flags; the arrays must be equal.
16-bit and interlaced PNGs, which PIL does not write, are encoded here;
ccv_tpu reads PNG through libpng (strip_16, interlace handling), so the
port's own decoder is held to libpng. JPEG is read with the native
decoders off on both sides (no libjpeg), so both take PIL's decode.
"""

import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from ccv_tpu.core import io as jio
from ccv_tpu.core import native as jnative
from ccv_tpu_torch.core import io as tio

FLAGS = {"as-is": 0, "gray": tio.IO_GRAY, "rgb": tio.IO_RGB_COLOR}
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _rows(samples, depth, filt):
    """Scanlines of an (h, w, c) sample block at ``depth`` bits, each with
    filter byte ``filt`` (0 none, 2 up: the encoder subtracts the row
    above)."""
    h, w, c = samples.shape
    if depth == 16:
        raw = samples.astype(">u2").reshape(h, w * c).view(np.uint8)
    elif depth == 8:
        raw = samples.astype(np.uint8).reshape(h, w * c)
    else:
        bits = ((samples[..., 0, None] >> np.arange(depth - 1, -1, -1))
                & 1).astype(np.uint8).reshape(h, w * depth)
        raw = np.packbits(bits, axis=1)
    out = b""
    prior = np.zeros(raw.shape[1], np.uint8)
    for row in raw:
        out += bytes([filt]) + (row - prior if filt == 2 else row).tobytes()
        prior = row
    return out


def encode_png(samples, depth, color, interlace=0, filt=2, palette=None):
    """A PNG of (h, w, c) samples (values below 2^depth)."""
    h, w = samples.shape[:2]
    if interlace:
        raw = b"".join(_rows(samples[y0::dy, x0::dx], depth, filt)
                       for x0, y0, dx, dy in ADAM7
                       if w > x0 and h > y0)
    else:
        raw = _rows(samples, depth, filt)
    chunks = [_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color,
                                          0, 0, interlace))]
    if palette is not None:
        chunks.append(_chunk(b"PLTE", palette.tobytes()))
    return (b"\x89PNG\r\n\x1a\n" + b"".join(chunks)
            + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b""))


def _pngs(rng):
    h, w = 13, 11   # odd sizes: every Adam7 pass ragged
    rgb16 = rng.integers(0, 1 << 16, (h, w, 3))
    gray16 = rng.integers(0, 1 << 16, (h, w, 1))
    rgba = rng.integers(0, 256, (h, w, 4))
    pal = rng.integers(0, 256, (16, 3)).astype(np.uint8)
    return {
        "rgb16.png": encode_png(rgb16, 16, 2),
        "gray16.png": encode_png(gray16, 16, 0),
        "rgba16-interlaced.png": encode_png(
            rng.integers(0, 1 << 16, (h, w, 4)), 16, 6, 1),
        "rgb-interlaced.png": encode_png(rgb16 >> 8, 8, 2, 1),
        "rgba-interlaced.png": encode_png(rgba, 8, 6, 1, filt=0),
        "gray2-interlaced.png": encode_png(
            rng.integers(0, 4, (h, w, 1)), 2, 0, 1),
        "gray1.png": encode_png(rng.integers(0, 2, (h, w, 1)), 1, 0),
        "gray4.png": encode_png(rng.integers(0, 16, (h, w, 1)), 4, 0),
        "palette4-interlaced.png": encode_png(
            rng.integers(0, 16, (h, w, 1)), 4, 3, 1, palette=pal),
    }


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Name -> path of every image both packages read."""
    d = tmp_path_factory.mktemp("io_pil")
    rng = np.random.default_rng(16)
    out = {}
    for name, data in _pngs(rng).items():
        (d / name).write_bytes(data)
        out[name] = str(d / name)
    rgb = rng.integers(0, 256, (17, 23, 3), np.uint8)
    gray = rng.integers(0, 256, (17, 23), np.uint8)
    for name, arr, kw in (("rgb.bmp", rgb, {}), ("gray.bmp", gray, {}),
                          ("rgb.gif", rgb, {}), ("rgb.tiff", rgb, {}),
                          ("rgba.tiff", rng.integers(0, 256, (9, 7, 4),
                                                     np.uint8), {}),
                          ("rgb.jpg", rgb, {"quality": 90}),
                          ("gray.jpg", gray, {"quality": 90})):
        Image.fromarray(arr).save(str(d / name), **kw)
        out[name] = str(d / name)
    return out


@pytest.fixture
def no_libjpeg(monkeypatch):
    """Both packages without a native JPEG decoder: ccv_tpu's native
    decode finds nothing, the port's cannot be built."""
    def refused(data):
        raise RuntimeError("JPEG decoding needs libjpeg's header jpeglib.h")
    monkeypatch.setattr(jnative, "decode_image", lambda path: None)
    monkeypatch.setattr(tio.native, "decode_jpeg", refused)


NATIVE = ["rgb16.png", "gray16.png", "rgba16-interlaced.png",
          "rgb-interlaced.png", "rgba-interlaced.png",
          "gray2-interlaced.png", "gray1.png", "gray4.png",
          "palette4-interlaced.png"]
PIL = ["rgb.bmp", "gray.bmp", "rgb.gif", "rgb.tiff", "rgba.tiff"]


@pytest.mark.parametrize("flag", list(FLAGS.values()), ids=list(FLAGS))
@pytest.mark.parametrize("name", NATIVE + PIL)
def test_read_equals_ccv_tpu(files, name, flag, monkeypatch):
    monkeypatch.setattr(tio, "DECODED", {"native": 0, "pil": 0})
    mine = tio.read(files[name], flag, device="cpu").numpy()
    theirs = jio.read(files[name], flag).numpy()
    assert mine.dtype == theirs.dtype and mine.shape == theirs.shape
    np.testing.assert_array_equal(mine, theirs)
    route = "native" if name in NATIVE else "pil"
    assert tio.DECODED == {"native": int(route == "native"),
                           "pil": int(route == "pil")}


@pytest.mark.parametrize("flag", list(FLAGS.values()), ids=list(FLAGS))
@pytest.mark.parametrize("name", ["rgb.jpg", "gray.jpg"])
def test_jpeg_without_libjpeg_equals_ccv_tpu(files, name, flag, no_libjpeg,
                                             monkeypatch):
    monkeypatch.setattr(tio, "DECODED", {"native": 0, "pil": 0})
    mine = tio.read(files[name], flag, device="cpu").numpy()
    np.testing.assert_array_equal(mine, jio.read(files[name], flag).numpy())
    with open(files[name], "rb") as f:
        np.testing.assert_array_equal(tio.decode(f.read(), flag), mine)
    assert tio.DECODED == {"native": 0, "pil": 2}


def test_png_samples_are_libpng_s(files):
    """The 16-bit PNG keeps each sample's high byte; 1-bit gray scales to
    0 / 255 (libpng's expand_gray_1_2_4_to_8)."""
    with Image.open(files["gray16.png"]) as im:
        want = (np.asarray(im).astype(np.uint32) >> 8).astype(np.uint8)
    np.testing.assert_array_equal(
        tio.read(files["gray16.png"], device="cpu").numpy(), want)
    one = tio.read(files["gray1.png"], device="cpu").numpy()
    assert set(np.unique(one)) <= {0, 255}


def test_damaged_data_raises_value_error(files, no_libjpeg):
    """Unknown bytes and a truncated JPEG on PIL's route raise ValueError
    (the server answers 400), as a damaged PNG does natively."""
    with open(files["rgb.jpg"], "rb") as f:
        jpeg = f.read()
    for data in (b"not an image at all", jpeg[:len(jpeg) // 2]):
        with pytest.raises(ValueError):
            tio.decode(data)
    with open(files["rgb16.png"], "rb") as f:
        png = f.read()
    with pytest.raises((ValueError, zlib.error)):
        tio.decode(png[:len(png) // 2])


@pytest.mark.parametrize("ext", ["jpg", "bmp", "gif", "tiff"])
@pytest.mark.parametrize("shape", [(9, 7), (9, 7, 1), (9, 7, 3)])
def test_write_equals_ccv_tpu(tmp_path, ext, shape):
    """``write`` saves other formats by PIL: the same bytes as ccv_tpu's,
    uint8 and float (rounded and clamped) alike."""
    rng = np.random.default_rng(len(shape) + len(ext))
    for arr in (rng.integers(0, 256, shape, np.uint8),
                rng.uniform(-20, 300, shape).astype(np.float32)):
        mine, theirs = tmp_path / f"a.{ext}", tmp_path / f"b.{ext}"
        tio.write(arr, str(mine))
        jio.write(arr, str(theirs))
        assert mine.read_bytes() == theirs.read_bytes()


def test_flags_match():
    assert (tio.IO_GRAY, tio.IO_RGB_COLOR, tio.IO_ANY_FILE) == (
        jio.IO_GRAY, jio.IO_RGB_COLOR, jio.IO_ANY_FILE)
