"""Image / matrix I/O (counterpart of ccv_tpu/core/io.py).

PNG is decoded here with the standard library's zlib and a small filter
reconstruction, so the port needs neither PIL nor libpng: 8-bit,
non-interlaced gray, gray+alpha, RGB, RGBA and palette images. JPEG (files
and bytes that start with ``\xff\xd8``) goes through libjpeg in the port's
native decoder (``core/native.py``), from memory. The reference's
``CCVBINDM`` binary matrices are read and written as in ``ccv_tpu``.

``write`` writes PNG itself (signature, IHDR, unfiltered rows in one zlib
IDAT, IEND) where ``ccv_tpu`` calls PIL, and CCVBINDM for ``.bin``. The
port has no JPEG encoder: a ``.jpg`` / ``.jpeg`` path raises.

Grayscale conversion matches the reference bit-exactly: libpng's
``png_set_rgb_to_gray`` for PNG, ``(r*6969 + g*23434 + b*2365) >> 15`` for
the jpeg/bmp path (lib/io/_ccv_io_libjpeg.inc:232).
"""

from __future__ import annotations

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

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_JPEG_MAGIC = b"\xff\xd8"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_PNG_COLOR = {1: 0, 2: 4, 3: 2, 4: 6}  # channels -> colour type


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


def decode_png(data: bytes) -> np.ndarray:
    """8-bit, non-interlaced PNG -> uint8 (H, W) gray or (H, W, 3|4)."""
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
    if depth != 8 or interlace != 0 or color not in _PNG_CHANNELS:
        raise NotImplementedError(
            f"PNG bit depth {depth}, color type {color}, interlace "
            f"{interlace}: only 8-bit non-interlaced images are decoded")
    bpp = _PNG_CHANNELS[color]
    stride = width * bpp
    raw = zlib.decompress(b"".join(idat))
    if len(raw) < height * (stride + 1):
        raise ValueError("truncated PNG image data")
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        off = y * (stride + 1)
        kind = raw[off]
        line = np.frombuffer(raw, np.uint8, stride, off + 1)
        if kind == 0:
            rec = line.copy()
        elif kind == 1:
            rec = (np.cumsum(line.reshape(width, bpp), axis=0, dtype=np.int64)
                   & 0xFF).astype(np.uint8).reshape(stride)
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
    img = out.reshape(height, width, bpp)
    if color == 0:
        return img[..., 0]
    if color == 3:
        if palette is None:
            raise ValueError("palette PNG without PLTE")
        return palette[img[..., 0]]
    if color == 4:  # gray + alpha: gray replicated, alpha dropped
        return np.repeat(img[..., :1], 3, axis=-1)
    return img


def decode(data: bytes, flags: int = 0) -> np.ndarray:
    """ccv_read of an image held in memory (PNG, JPEG or a CCVBINDM blob)
    into a host array; raises NotImplementedError for other formats and
    ValueError (or zlib.error, struct.error) for a damaged one.

    ``IO_RGB_COLOR`` stacks a one-channel image to RGB; ``IO_GRAY`` turns an
    RGB image to gray with libpng's coefficients for a PNG and libjpeg's
    reader's (6969/23434/2365, truncating) for a JPEG, as ``ccv_tpu`` does."""
    if data[:8] == b"CCVBINDM":
        return _decode_ccv_binary(data)
    if data[:8] == _PNG_MAGIC:
        arr, png = decode_png(data), True
    elif data[:2] == _JPEG_MAGIC:
        arr, png = native.decode_jpeg(data), False
    else:
        raise NotImplementedError(
            "only PNG, JPEG and CCVBINDM are decoded by the port so far")
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
    """ccv_read twin: decode a PNG or JPEG (or CCVBINDM blob) into a
    DenseMatrix on ``device`` (default: the card; raises without one, so
    pass ``device="cpu"`` to keep the image on the host)."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        arr = decode(data, flags)
    except NotImplementedError as e:
        raise NotImplementedError(f"{path}: {e}") from None
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
    ``.bin`` / ``binary``, else PNG. Pixels that are not uint8 are rounded
    and clamped to 0-255, as ``ccv_tpu`` does before PIL. JPEG raises
    NotImplementedError: the port has no JPEG encoder."""
    name = (format or path).lower()
    if name.endswith((".bin", "binary")):
        write_ccv_binary(m, path)
        return
    if name.endswith((".jpg", ".jpeg", "jpeg", "jpg")):
        raise NotImplementedError(
            f"{path}: the port has no JPEG encoder; write PNG (.png) or "
            f"CCVBINDM (.bin)")
    if not name.endswith("png"):
        raise ValueError(f"{path}: the port writes PNG (.png) and CCVBINDM "
                         f"(.bin) only")
    arr = to_numpy(m)
    if arr.dtype != np.uint8:
        arr = np.clip(np.round(arr), 0, 255).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(encode_png(arr))
