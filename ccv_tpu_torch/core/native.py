"""ctypes bindings of the port's host C++ (counterpart of
ccv_tpu/core/native.py).

- ``decode_jpeg`` (csrc/image_decode.cpp): JPEG through libjpeg, from a
  memory buffer. The library is built with g++ and ``-ljpeg`` into
  ``ccv_tpu_torch/_build`` at the first JPEG decode, never at import.
  Without libjpeg's header the decode raises an error that names it, and so
  does every later decode in the process, with no second build;
  ``core.io.decode`` then takes PIL's decode (``core.io.DECODED`` counts
  it). Any other build failure raises with the compiler's message.
- ``swt_cc`` (csrc/swt_cc.cpp): SWT's width-ratio-gated 8-connected
  components, built with g++ at the first call. A failed build raises with
  the compiler's message; nothing falls back.
- ``siphash24`` and ``NativeLru`` (csrc/ccv_tpu_native.cpp): the 64-bit
  content signatures of ``core.cache`` and a byte-bounded LRU of blobs
  (ccv_tpu's native runtime, lib/ccv_cache.c's twin), built with g++ at
  the first call. A failed build raises with the compiler's message.
"""

from __future__ import annotations

import ctypes
from typing import Optional

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


_SIP_KEY = b"ccv_tpu_sipkey00"  # 16 bytes, ccv_tpu's key


def _runtime_lib() -> ctypes.CDLL:
    lib = _native_build.load_host_library("ccv_tpu_native",
                                          ["ccv_tpu_native.cpp"])
    if not hasattr(lib, "_bound"):
        lib.ccv_tpu_siphash24.restype = ctypes.c_uint64
        lib.ccv_tpu_siphash24.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                          ctypes.c_char_p]
        lib.ccv_tpu_cache_new.restype = ctypes.c_void_p
        lib.ccv_tpu_cache_new.argtypes = [ctypes.c_size_t]
        lib.ccv_tpu_cache_put.restype = ctypes.c_int
        lib.ccv_tpu_cache_put.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                          ctypes.c_char_p, ctypes.c_size_t]
        lib.ccv_tpu_cache_get.restype = ctypes.c_size_t
        lib.ccv_tpu_cache_get.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                          ctypes.c_void_p, ctypes.c_size_t]
        lib.ccv_tpu_cache_delete.restype = ctypes.c_int
        lib.ccv_tpu_cache_delete.argtypes = [ctypes.c_void_p,
                                             ctypes.c_uint64]
        lib.ccv_tpu_cache_drain.argtypes = [ctypes.c_void_p]
        lib.ccv_tpu_cache_size.restype = ctypes.c_size_t
        lib.ccv_tpu_cache_size.argtypes = [ctypes.c_void_p]
        lib.ccv_tpu_cache_free.argtypes = [ctypes.c_void_p]
        lib._bound = True
    return lib


def siphash24(data: bytes, key: bytes = _SIP_KEY) -> int:
    """SipHash-2-4 of ``data`` under a 16-byte ``key``, as an unsigned
    64-bit int."""
    if len(key) != 16:
        raise ValueError(f"siphash24 needs a 16-byte key, got {len(key)}")
    return int(_runtime_lib().ccv_tpu_siphash24(data, len(data), key))


class NativeLru:
    """Byte-bounded LRU of blobs keyed by 64-bit signature: ``put`` copies
    the bytes in (refused when larger than the budget) and evicts the
    least recently used until the rest fits; ``get`` refreshes."""

    def __init__(self, budget: int):
        self._lib = _runtime_lib()
        self._handle = self._lib.ccv_tpu_cache_new(budget)

    def put(self, sig: int, data: bytes) -> bool:
        return self._lib.ccv_tpu_cache_put(self._handle, sig, data,
                                           len(data)) == 0

    def get(self, sig: int) -> Optional[bytes]:
        size = self._lib.ccv_tpu_cache_get(self._handle, sig, None, 0)
        if size == 0:
            return None
        buf = ctypes.create_string_buffer(size)
        self._lib.ccv_tpu_cache_get(self._handle, sig, buf, size)
        return buf.raw

    def delete(self, sig: int) -> bool:
        return self._lib.ccv_tpu_cache_delete(self._handle, sig) == 0

    def drain(self) -> None:
        self._lib.ccv_tpu_cache_drain(self._handle)

    @property
    def used_bytes(self) -> int:
        return int(self._lib.ccv_tpu_cache_size(self._handle))

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.ccv_tpu_cache_free(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
