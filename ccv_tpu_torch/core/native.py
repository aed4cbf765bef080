"""ctypes bindings of the port's host C++ (counterpart of
ccv_tpu/core/native.py).

- ``decode_jpeg`` (csrc/image_decode.cpp): JPEG through libjpeg, from a
  memory buffer. The library is built with g++ and ``-ljpeg`` into
  ``ccv_tpu_torch/_build`` at the first JPEG decode, never at import.
  Without libjpeg's header the decode raises an error that names it, and so
  does every later decode in the process, with no second build; nothing
  falls back to another decoder.
- ``swt_cc`` (csrc/swt_cc.cpp): SWT's width-ratio-gated 8-connected
  components, built with g++ at the first call. A failed build raises with
  the compiler's message; nothing falls back.

siphash and the LRU blob cache are not ported yet.
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


def _swt_lib() -> ctypes.CDLL:
    lib = _native_build.load_host_library("swt_cc", ["swt_cc.cpp"])
    if not hasattr(lib, "_bound"):
        fn = lib.ccv_torch_swt_cc
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
                       ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_int32)]
        lib._bound = True
    return lib


def swt_cc(swt: np.ndarray, ratio: int = 3) -> np.ndarray:
    """(H, W) int32 component labels of a uint8 stroke-width map (-1 off
    the strokes): 8-connected neighbours join when each width is within
    ``ratio`` x of the other; ids number components in scan order."""
    lib = _swt_lib()
    s8 = np.ascontiguousarray(swt, np.uint8)
    if s8.ndim != 2 or ratio <= 0:
        raise ValueError(f"swt_cc needs an (H, W) map and ratio > 0, got "
                         f"{s8.shape} and {ratio}")
    labels = np.empty(s8.shape, np.int32)
    n = lib.ccv_torch_swt_cc(
        s8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), s8.shape[0],
        s8.shape[1], ratio,
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if n < 0:
        raise ValueError(f"swt_cc refused a {s8.shape} map")
    return labels
