"""Image / matrix I/O (counterpart of ccv_tpu/core/io.py).

Decoding follows ``ccv_tpu``'s order: the native decoders first, then PIL.

- Native: PNG is decoded here with the standard library's zlib, as libpng
  decodes it under ``ccv_tpu``'s transforms (palette to RGB, gray of 1, 2
  or 4 bits scaled to 8, 16 bits cut to their high byte, Adam7 interlacing
  undone, alpha dropped: gray + alpha reads as gray, as libpng's
  ``png_set_strip_alpha`` leaves it). JPEG (``\xff\xd8``) goes through
  libjpeg in the port's native decoder (``core/native.py``), from memory.
  The reference's ``CCVBINDM`` binary matrices are read and written as in
  ``ccv_tpu``.
- PIL: any other format (BMP, GIF, TIFF, ...), and JPEG where libjpeg's
  header is missing (any other failure to build the decoder raises), with
  ``ccv_tpu``'s mode conversions (palette, RGBA, CMYK and gray + alpha to
  RGB).

``DECODED`` counts the decodes each route made. Damaged data that a native
decoder takes raises ValueError, as PIL's refusals do.

``write`` writes PNG itself (signature, IHDR, unfiltered rows in one zlib
IDAT, IEND) and CCVBINDM for ``.bin``; any other extension (JPEG, BMP,
...) is saved by PIL, as ``ccv_tpu`` saves it.

Grayscale conversion matches the reference bit-exactly: libpng's
``png_set_rgb_to_gray`` for PNG, ``(r*6969 + g*23434 + b*2365) >> 15`` for
the jpeg/bmp path (lib/io/_ccv_io_libjpeg.inc:232).
"""

from __future__ import annotations

import io as _bytes_io
import struct
import zlib
from typing import Optional

import numpy as np

from ccv_tpu_torch import device as _device
from ccv_tpu_torch.core import native
from ccv_tpu_torch.core.dense_matrix import (
    _DTYPE_TO_CCV,
    DenseMatrix,
    ccv_type_channels,
    ccv_type_to_dtype,
    from_numpy,
    to_numpy,
)

# io flags (lib/ccv.h:500-540)
IO_GRAY = 0x100
IO_RGB_COLOR = 0x300
IO_ANY_FILE = 0x022

# decodes by route: "native" (the port's PNG and libjpeg decoders,
# CCVBINDM) and "pil"
DECODED = {"native": 0, "pil": 0}

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_JPEG_MAGIC = b"\xff\xd8"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_PNG_COLOR = {1: 0, 2: 4, 3: 2, 4: 6}  # channels -> colour type
# Adam7's passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
# libpng's png_set_expand_gray_1_2_4_to_8: the factor of a gray sample
_GRAY_SCALE = {1: 255, 2: 85, 4: 17, 8: 1}


def rgb_to_gray_u8(rgb: np.ndarray, libpng: bool = False) -> np.ndarray:
    """Bit-exact twin of the reference's fixed-point RGB->gray.

    The jpeg/bmp path truncates with 6969/23434/2365; the png path uses
    png_set_rgb_to_gray's Rec.709 coefficients 6968/23434/2366, rounded.
    """
    r = rgb[..., 0].astype(np.int32)
    g = rgb[..., 1].astype(np.int32)
    b = rgb[..., 2].astype(np.int32)
    if libpng:
        return ((r * 6968 + g * 23434 + b * 2366 + 16384) >> 15).astype(np.uint8)
    return ((r * 6969 + g * 23434 + b * 2365) >> 15).astype(np.uint8)


def _decode_ccv_binary(data: bytes) -> np.ndarray:
    if data[:8] != b"CCVBINDM":
        raise ValueError("not a CCVBINDM blob")
    type_tag, rows, cols = struct.unpack("<iii", data[8:20])
    dt = ccv_type_to_dtype(type_tag)
    ch = ccv_type_channels(type_tag)
    # rows are stored with a 4-byte aligned row stride
    step = (cols * ch * dt.itemsize + 3) & ~3
    raw = data[20:20 + step * rows]
    buf = np.frombuffer(raw, dtype=np.uint8).reshape(rows, step)
    row_bytes = cols * ch * dt.itemsize
    arr = buf[:, :row_bytes].copy().view(dt).reshape(rows, cols, ch)
    return arr[..., 0] if ch == 1 else arr


def _unfilter_seq(kind: int, line: bytearray, prior: bytes, bpp: int):
    """In-place Average (3) / Paeth (4) reconstruction of one scanline."""
    for i in range(len(line)):
        a = line[i - bpp] if i >= bpp else 0
        b = prior[i]
        if kind == 3:
            pred = (a + b) >> 1
        else:
            c = prior[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        line[i] = (line[i] + pred) & 0xFF


def _unfilter(raw: bytes, off: int, rows: int, stride: int, bpp: int):
    """Rows ``rows`` of ``stride`` bytes from filtered scanlines at ``off``
    of the inflated stream (``bpp`` bytes a pixel, at least 1): the
    (rows, stride) uint8 image and the offset after it."""
    if len(raw) < off + rows * (stride + 1):
        raise ValueError("truncated PNG image data")
    out = np.empty((rows, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(rows):
        at = off + y * (stride + 1)
        kind = raw[at]
        line = np.frombuffer(raw, np.uint8, stride, at + 1)
        if kind == 0:
            rec = line.copy()
        elif kind == 1:
            n = stride // bpp
            rec = (np.cumsum(line[:n * bpp].reshape(n, bpp), axis=0,
                             dtype=np.int64) & 0xFF).astype(np.uint8)
            rec = rec.reshape(n * bpp)
        elif kind == 2:
            rec = line + prior  # uint8 arithmetic wraps mod 256
        elif kind in (3, 4):
            buf = bytearray(line.tobytes())
            _unfilter_seq(kind, buf, prior.tobytes(), bpp)
            rec = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {kind}")
        out[y] = rec
        prior = out[y]
    return out, off + rows * (stride + 1)


def _samples(rows: np.ndarray, width: int, depth: int,
             channels: int) -> np.ndarray:
    """(H, stride) unfiltered bytes -> (H, width, channels) samples: 8-bit
    as they are, 16-bit cut to their high byte (libpng's strip_16), 1, 2 or
    4 bits unpacked (MSB first) to one value a byte."""
    h = rows.shape[0]
    if depth == 8:
        return rows[:, :width * channels].reshape(h, width, channels)
    if depth == 16:
        return rows[:, :width * channels * 2:2].reshape(h, width, channels)
    bits = np.unpackbits(rows, axis=1)[:, :width * depth]
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    vals = (bits.reshape(h, width, depth) * weights).sum(-1, dtype=np.uint8)
    return vals[..., None]


def decode_png(data: bytes) -> np.ndarray:
    """PNG -> uint8 (H, W) gray or (H, W, 3|4), as libpng gives it under
    ``ccv_tpu``'s transforms: any bit depth (1-16) and either interlace."""
    if data[:8] != _PNG_MAGIC:
        raise ValueError("not a PNG file")
    pos, idat, palette, ihdr = 8, [], None, None
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if ihdr is None:
        raise ValueError("PNG without IHDR")
    width, height, depth, color, _comp, _filt, interlace = ihdr
    if (color not in _PNG_CHANNELS or depth not in (1, 2, 4, 8, 16)
            or interlace not in (0, 1)
            or (depth < 8 and color not in (0, 3))
            or (depth == 16 and color == 3)):
        raise ValueError(f"PNG bit depth {depth}, color type {color}, "
                         f"interlace {interlace}: not a valid combination")
    ch = _PNG_CHANNELS[color]
    bpp = max(1, ch * depth // 8)
    raw = zlib.decompress(b"".join(idat))
    if interlace == 0:
        rows, _ = _unfilter(raw, 0, height, (width * ch * depth + 7) // 8,
                            bpp)
        img = _samples(rows, width, depth, ch)
    else:
        img = np.zeros((height, width, ch), np.uint8)
        off = 0
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = -(-(width - x0) // dx), -(-(height - y0) // dy)
            if pw <= 0 or ph <= 0:
                continue
            rows, off = _unfilter(raw, off, ph, (pw * ch * depth + 7) // 8,
                                  bpp)
            img[y0::dy, x0::dx] = _samples(rows, pw, depth, ch)
    if color == 0:
        return img[..., 0] * np.uint8(_GRAY_SCALE[min(depth, 8)])
    if color == 3:
        if palette is None:
            raise ValueError("palette PNG without PLTE")
        return palette[img[..., 0]]
    if color == 4:  # gray + alpha: png_set_strip_alpha keeps the gray
        return img[..., 0]
    return img


def _pil_decode(data: bytes) -> np.ndarray:
    """PIL's decode as ``ccv_tpu.core.io.read`` takes it: palette, RGBA,
    CMYK and gray + alpha converted to RGB. PIL's refusal of damaged or
    unknown data raises ValueError."""
    from PIL import Image

    try:
        img = Image.open(_bytes_io.BytesIO(data))
        if img.mode in ("P", "RGBA", "CMYK", "LA"):
            img = img.convert("RGB")
        arr = np.array(img)   # a writable copy: tensors are made from it
    except (OSError, SyntaxError) as e:   # UnidentifiedImageError is OSError
        raise ValueError(f"undecodable image (PIL): {e}") from None
    DECODED["pil"] += 1
    return arr


def _native_decode(data: bytes) -> Optional[np.ndarray]:
    """The native decoders' array, or None where they take no such data
    (not PNG or JPEG) or libjpeg's header is missing. Any other failure to
    build the JPEG decoder raises."""
    if data[:8] == _PNG_MAGIC:
        arr = decode_png(data)
    elif data[:2] == _JPEG_MAGIC:
        try:
            arr = native.decode_jpeg(data)
        except RuntimeError as e:
            if native.JPEG_HEADER not in str(e):
                raise
            return None
    else:
        return None
    DECODED["native"] += 1
    return arr


def decode(data: bytes, flags: int = 0) -> np.ndarray:
    """ccv_read of an image held in memory into a host array: a CCVBINDM
    blob, then the native PNG and JPEG decoders, then PIL; raises
    ValueError (or zlib.error, struct.error) for damaged or unknown data.

    ``IO_RGB_COLOR`` stacks a one-channel image to RGB; ``IO_GRAY`` turns an
    RGB image to gray with libpng's coefficients for a PNG and libjpeg's
    reader's (6969/23434/2365, truncating) otherwise, as ``ccv_tpu`` does."""
    if data[:8] == b"CCVBINDM":
        DECODED["native"] += 1
        return _decode_ccv_binary(data)
    arr = _native_decode(data)
    if arr is None:
        arr = _pil_decode(data)
    png = data[:8] == _PNG_MAGIC
    want_gray = ((flags & IO_GRAY) == IO_GRAY
                 and (flags & IO_RGB_COLOR) != IO_RGB_COLOR)
    want_rgb = (flags & IO_RGB_COLOR) == IO_RGB_COLOR
    if arr.ndim == 3 and arr.shape[2] >= 3:
        arr = arr[..., :3]
        if want_gray:
            arr = rgb_to_gray_u8(arr, libpng=png)
    elif arr.ndim == 2 and want_rgb:
        arr = np.stack([arr] * 3, axis=-1)
    return arr


def read(path: str, flags: int = 0,
         device: _device.DeviceLike = None) -> DenseMatrix:
    """ccv_read twin: decode an image file (or CCVBINDM blob) into a
    DenseMatrix on ``device`` (default: the card; raises without one, so
    pass ``device="cpu"`` to keep the image on the host)."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        arr = decode(data, flags)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
    return from_numpy(arr, device=device)


def write_ccv_binary(m, path: str) -> None:
    """A CCVBINDM file of ``m`` (DenseMatrix, tensor or array): the type
    tag, rows and cols, then each row padded to a 4-byte step."""
    arr = to_numpy(m)
    if arr.ndim == 2:
        arr = arr[..., None]
    rows, cols, ch = arr.shape
    type_tag = _DTYPE_TO_CCV[arr.dtype.name] | ch
    row_bytes = cols * ch * arr.dtype.itemsize
    step = (row_bytes + 3) & ~3
    buf = np.zeros((rows, step), np.uint8)
    buf[:, :row_bytes] = np.ascontiguousarray(arr).view(np.uint8).reshape(
        rows, row_bytes)
    with open(path, "wb") as f:
        f.write(b"CCVBINDM")
        f.write(struct.pack("<iii", type_tag, rows, cols))
        f.write(buf.tobytes())


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(arr: np.ndarray) -> bytes:
    """uint8 (H, W) or (H, W, C) with C 1-4 -> PNG bytes: 8-bit gray, gray
    + alpha, RGB or RGBA, every row with filter 0, one IDAT."""
    if arr.ndim == 2:
        arr = arr[..., None]
    if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] not in _PNG_COLOR:
        raise ValueError(f"PNG needs uint8 (H, W) or (H, W, 1-4), got "
                         f"{arr.dtype} {arr.shape}")
    h, w, ch = arr.shape
    raw = np.zeros((h, 1 + w * ch), np.uint8)   # column 0: filter type 0
    raw[:, 1:] = arr.reshape(h, w * ch)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _PNG_COLOR[ch], 0, 0, 0)
    return (_PNG_MAGIC + _png_chunk(b"IHDR", ihdr)
            + _png_chunk(b"IDAT", zlib.compress(raw.tobytes()))
            + _png_chunk(b"IEND", b""))


def write(m, path: str, format: Optional[str] = None) -> None:
    """ccv_write twin: CCVBINDM for a path (or ``format``) ending in
    ``.bin`` / ``binary``, PNG by the port's encoder for ``.png``, any
    other format by PIL from the extension (JPEG, BMP, ...; PIL raises
    ValueError for one it does not know), as ``ccv_tpu`` does. Pixels that
    are not uint8 are rounded and clamped to 0-255, as ``ccv_tpu`` does;
    one channel of three dimensions is written as gray."""
    name = (format or path).lower()
    if name.endswith((".bin", "binary")):
        write_ccv_binary(m, path)
        return
    arr = to_numpy(m)
    if arr.dtype != np.uint8:
        arr = np.clip(np.round(arr), 0, 255).astype(np.uint8)
    if name.endswith("png"):
        with open(path, "wb") as f:
            f.write(encode_png(arr))
        return
    from PIL import Image

    if arr.ndim == 3 and arr.shape[2] == 1:
        arr = arr[..., 0]
    Image.fromarray(arr).save(path)
