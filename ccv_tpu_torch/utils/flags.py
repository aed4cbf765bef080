"""Runtime flags (counterpart of ccv_tpu/utils/flags.py; reference:
ccv_nnc_enable_flag / disable_flag / ccv_nnc_flags, lib/nnc/ccv_nnc.h:30-48).

The same five bits and names as ``ccv_tpu``. They start from the
``CCV_TPU_FLAGS`` environment variable (comma-separated names), read once
when this module is imported; that variable is the one the port reads.

Of the five, the port reads two. ``DISABLE_NATIVE_RUNTIME``: with it
set, ``core.cache.generate_signature`` hashes with blake2b instead of the
native siphash-2-4 (``core/native.py``), as ``ccv_tpu`` does without its
native library; the flag does not reach the port's other host C++ (the
MSER / MSCR trees, SWT's components, the JPEG decoder), which have no
pure-Python twin. ``DISABLE_MEMORY_COMPRESSION``: training ignores
``set_memory_compression`` (``nn.model.Trainable``). The other three bits
are kept for the API and select nothing in the port.
"""

from __future__ import annotations

import os

DISABLE_PALLAS_FLASH_ATTENTION = 0x1
DISABLE_STAGED_CASCADE = 0x2
DISABLE_NATIVE_RUNTIME = 0x4           # signatures: blake2b, not siphash
DISABLE_PERSISTENT_COMPILE_CACHE = 0x8
DISABLE_MEMORY_COMPRESSION = 0x10

_NAMES = {
    "disable_pallas_flash_attention": DISABLE_PALLAS_FLASH_ATTENTION,
    "disable_staged_cascade": DISABLE_STAGED_CASCADE,
    "disable_native_runtime": DISABLE_NATIVE_RUNTIME,
    "disable_persistent_compile_cache": DISABLE_PERSISTENT_COMPILE_CACHE,
    "disable_memory_compression": DISABLE_MEMORY_COMPRESSION,
}


def parse(spec: str) -> int:
    """The bits of a comma-separated list of flag names (case and spaces
    ignored, unknown names skipped)."""
    bits = 0
    for name in spec.split(","):
        bits |= _NAMES.get(name.strip().lower(), 0)
    return bits


_flags = parse(os.environ.get("CCV_TPU_FLAGS", ""))


def enable_flag(flag: int) -> None:
    """ccv_nnc_enable_flag twin."""
    global _flags
    _flags |= flag


def disable_flag(flag: int) -> None:
    """ccv_nnc_disable_flag twin."""
    global _flags
    _flags &= ~flag


def flags() -> int:
    """ccv_nnc_flags twin."""
    return _flags


def is_set(flag: int) -> bool:
    return bool(_flags & flag)
