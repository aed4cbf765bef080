"""ctypes binding of the port's native image decoder (csrc/image_decode.cpp).

Counterpart of the decoder half of ccv_tpu/core/native.py: JPEG through
libjpeg, here from a memory buffer. The library is built with g++ and
``-ljpeg`` into ``ccv_tpu_torch/_build`` at the first JPEG decode, never at
import. Without libjpeg's header the decode raises an error that names it,
and so does every later decode in the process, with no second build;
nothing falls back to another decoder. siphash and the LRU blob cache are
not ported yet.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ccv_tpu_torch import _native_build

JPEG_HEADER = "jpeglib.h"
_MSG_LEN = 256


def _lib() -> ctypes.CDLL:
    try:
        lib = _native_build.load_host_library(
            "image_decode", ["image_decode.cpp"], ["-ljpeg"])
    except RuntimeError as e:
        if JPEG_HEADER in str(e):
            raise RuntimeError(
                f"JPEG decoding needs libjpeg's header {JPEG_HEADER}, which "
                f"the C++ compiler did not find (install libjpeg's "
                f"development files)") from e
        raise
    if not hasattr(lib, "_bound"):
        fn = lib.ccv_torch_decode_jpeg
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                       ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
                       ctypes.POINTER(ctypes.c_int),
                       ctypes.POINTER(ctypes.c_int),
                       ctypes.POINTER(ctypes.c_int),
                       ctypes.c_char_p, ctypes.c_int]
        lib.ccv_torch_free.argtypes = [ctypes.c_void_p]
        lib._bound = True
    return lib


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> uint8 (H, W) for one channel, else (H, W, C) as libjpeg
    outputs it (RGB for colour). Raises ValueError for damaged or truncated
    data."""
    lib = _lib()
    out = ctypes.POINTER(ctypes.c_uint8)()
    rows, cols, ch = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    msg = ctypes.create_string_buffer(_MSG_LEN)
    if lib.ccv_torch_decode_jpeg(data, len(data), ctypes.byref(out),
                                 ctypes.byref(rows), ctypes.byref(cols),
                                 ctypes.byref(ch), msg, _MSG_LEN) != 0:
        raise ValueError(f"damaged or truncated JPEG: "
                         f"{msg.value.decode(errors='replace')}")
    try:
        n = rows.value * cols.value * ch.value
        arr = np.ctypeslib.as_array(out, shape=(n,)).copy()
    finally:
        lib.ccv_torch_free(out)
    if ch.value == 1:
        return arr.reshape(rows.value, cols.value)
    return arr.reshape(rows.value, cols.value, ch.value)
