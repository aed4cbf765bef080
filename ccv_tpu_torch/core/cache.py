"""Transparent content-addressed memoization cache (counterpart of
ccv_tpu/core/cache.py; reference: lib/ccv_cache.c, lib/ccv_memory.c).

Every cached op derives its output signature from (op name + params, input
signatures) and returns the cached result when present, so a repeated
pipeline runs nothing. Values are tensors where the op left them: a hit on
the card hands back the tensor still in device memory and launches no
kernel. The store is a byte-bounded LRU, like ``ccv_enable_cache(size)``.

Signatures are 64-bit siphash-2-4 (``core/native.py``) with ccv_tpu's key,
over the same bytes, so a matrix has the same signature in both packages.
With the ``DISABLE_NATIVE_RUNTIME`` flag set, they are truncated blake2b,
as ``ccv_tpu``'s are without its native library. A failed build of the
native library raises: the hash never changes silently.

The port has two devices where ``ccv_tpu`` has one: a matrix read onto the
CPU and onto the card carries one signature. The store is keyed by
``(signature, device)``, so a CPU entry never answers a call on the card
and a card entry never answers a call on the CPU.

Tensors are mutable. A result handed out by a cached op may be the very
tensor the cache holds and the one every later hit returns: never write
into it in place (copy it first).
"""

from __future__ import annotations

import functools
import hashlib
import threading
from collections import OrderedDict
from typing import Any, Callable, Optional

import torch

from ccv_tpu_torch.utils import flags as _flags

_lock = threading.RLock()
_enabled = False
_max_bytes = 0
_cur_bytes = 0
_store: "OrderedDict[tuple, Any]" = OrderedDict()
# stats
hits = 0
misses = 0


def generate_signature(data: bytes, *extra) -> int:
    """64-bit content signature (ccv_cache_generate_signature twin):
    siphash-2-4 of ``data`` + ``b"|"`` + ``repr(extra)``; 0 is kept for "no
    signature", so a hash of 0 becomes 1."""
    if extra:
        data = data + b"|" + repr(extra).encode()
    if _flags.is_set(_flags.DISABLE_NATIVE_RUNTIME):
        h = hashlib.blake2b(data, digest_size=8)
        sig = int.from_bytes(h.digest(), "little")
    else:
        from ccv_tpu_torch.core import native

        sig = native.siphash24(data)
    return sig or 1


def derive_signature(op_name: str, params: tuple, input_sigs: tuple) -> int:
    """ccv_declare_derived_signature twin: sig(op, params, input sigs); 0
    when any input has none."""
    if any(s == 0 for s in input_sigs):
        return 0
    return generate_signature(op_name.encode(), params, input_sigs)


def enable(max_bytes: int = 256 << 20) -> None:
    """ccv_enable_cache twin."""
    global _enabled, _max_bytes
    with _lock:
        _enabled = True
        _max_bytes = max_bytes


def disable() -> None:
    """ccv_disable_cache twin: drop everything."""
    global _enabled, _cur_bytes
    with _lock:
        _enabled = False
        _store.clear()
        _cur_bytes = 0


def drain() -> None:
    """ccv_drain_cache twin: drop contents, stay enabled."""
    global _cur_bytes
    with _lock:
        _store.clear()
        _cur_bytes = 0


def is_enabled() -> bool:
    return _enabled


def _tensors(value: Any):
    if isinstance(value, (tuple, list)):
        for v in value:
            yield from _tensors(v)
    else:
        yield value


def _nbytes(value: Any) -> int:
    return sum(t.numel() * t.element_size() if isinstance(t, torch.Tensor)
               else 64 for t in _tensors(value))


def _device_key(value: Any) -> str:
    for t in _tensors(value):
        if isinstance(t, torch.Tensor):
            return str(t.device)
    return "cpu"


def get(sig: int, device) -> Optional[Any]:
    """The value cached under ``sig`` on ``device``, or None."""
    global hits, misses
    if not _enabled or sig == 0:
        return None
    key = (sig, str(torch.device(device)))
    with _lock:
        if key in _store:
            _store.move_to_end(key)
            hits += 1
            return _store[key]
        misses += 1
        return None


def put(sig: int, value: Any) -> None:
    """Cache ``value`` (a tensor or a tuple of them) under ``sig`` on the
    device its tensors are on; evicts the least recently used entries
    past the budget."""
    global _cur_bytes
    if not _enabled or sig == 0:
        return
    key = (sig, _device_key(value))
    with _lock:
        size = _nbytes(value)
        if size > _max_bytes:
            return
        if key in _store:
            _store.move_to_end(key)
            return
        _store[key] = value
        _cur_bytes += size
        while _cur_bytes > _max_bytes and _store:
            _, old = _store.popitem(last=False)
            _cur_bytes -= _nbytes(old)


def cached_op(fmt: str, n_outputs: int = 1) -> Callable:
    """Decorator for DenseMatrix-level ops with ccv memoization semantics.

    ``fmt`` is the op identity string (e.g. ``"ccv_sobel"``). The wrapped
    function takes (tensors..., **params) and returns tensor(s); the
    wrapper unwraps DenseMatrix inputs, derives the output signatures from
    ``fmt``, the keyword params and the input signatures (ccv_tpu's
    arithmetic: pass params by keyword), looks them up on the device of
    the first input and inserts what it computes."""
    from ccv_tpu_torch.core.dense_matrix import DenseMatrix, as_array

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*mats, **params):
            arrays = [as_array(m) for m in mats]
            sigs = tuple(m.sig if isinstance(m, DenseMatrix) else 0
                         for m in mats)
            pkey = tuple(sorted(params.items()))
            out_sigs = tuple(derive_signature(f"{fmt}#{i}", pkey, sigs)
                             for i in range(n_outputs))
            if all(s != 0 for s in out_sigs):
                dev = arrays[0].device
                cached = [get(s, dev) for s in out_sigs]
                if all(c is not None for c in cached):
                    outs = [DenseMatrix(c, sig=s)
                            for c, s in zip(cached, out_sigs)]
                    return outs[0] if n_outputs == 1 else tuple(outs)
            result = fn(*arrays, **params)
            results = (result,) if n_outputs == 1 else tuple(result)
            outs = []
            for r, s in zip(results, out_sigs):
                put(s, r)
                outs.append(DenseMatrix(r, sig=s))
            return outs[0] if n_outputs == 1 else tuple(outs)

        wrapper.raw = fn  # the tensor-level function
        return wrapper

    return deco
