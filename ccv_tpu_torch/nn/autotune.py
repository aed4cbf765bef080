"""Per-shape measured choice between forms of an op (counterpart of
ccv_tpu/nn/autotune.py; reference: ccv_nnc_cmd_autotune,
lib/nnc/ccv_nnc_cmd.c:344-577).

The reference times every backend and algorithm of a command on the real
tensors (twice each, the fastest kept) and returns the winner. Here the
forms are callables computing the same function; each is timed on the
given arguments on their device, and the winner is kept, keyed by

    op | device kind | argument shapes and dtypes | extra static config

in a JSON store that later processes reuse. The key is ``ccv_tpu``'s but
for the device field: ``torch.cuda.get_device_name`` on the card, ``cpu``
otherwise, and ``ccv_tpu``'s signature format (``float32[4096]``), so a
store written by one package loads in the other without collisions.

The store is ``ccv_tpu_torch/autotune.json`` beside the package, or
``$CCV_TPU_AUTOTUNE_CACHE``; ``CCV_TPU_AUTOTUNE=0`` stops new measurements
(a miss then takes the default). Where nothing can be measured now (the
call is being traced by ``torch.compile``: ``ccv_tpu``'s tracer case) a
lookup still works and a miss returns the default without recording.

A trial dispatches a form ``_PIPELINE`` times back to back; on the card it
ends with ``torch.cuda.synchronize`` inside the timed window. A form that
raises is recorded with ``None`` and never wins; its error is kept beside
the timings (``"errors"``).

Usage::

    fn = autotune.choose("sat", {"sat": sat, "sat_mxu": sat_mxu}, (a,),
                         default="sat")
    out = fn(a)
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

__all__ = ["choose", "measure", "recorded", "cache_path", "clear",
           "decisions", "stats", "stats_delta"]

_LOCK = threading.RLock()
_MEM: Optional[Dict[str, Any]] = None  # the loaded JSON store
_TRIALS = 2  # cmd.c:492 measures each backend / algorithm twice
_WARMUP = 1
_PIPELINE = 8  # dispatches per timed trial

# this process's decisions: hits = a recorded winner reused, measured = a
# measurement ran
_STATS = {"hits": 0, "measured": 0}


def stats() -> Dict[str, int]:
    """A copy of this process's decision counters."""
    with _LOCK:
        return dict(_STATS)


def stats_delta(before: Dict[str, int]) -> Dict[str, int]:
    now = stats()
    return {k: now[k] - before.get(k, 0) for k in now}


def cache_path() -> str:
    """Where the decisions are kept (JSON)."""
    env = os.environ.get("CCV_TPU_AUTOTUNE_CACHE")
    if env:
        return env
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "autotune.json")


def _load() -> Dict[str, Any]:
    global _MEM
    with _LOCK:
        if _MEM is None:
            try:
                with open(cache_path()) as f:
                    _MEM = json.load(f)
            except (OSError, ValueError):
                _MEM = {}
        return _MEM


def _save() -> None:
    with _LOCK:
        path = cache_path()
        try:
            # merge on save: another process may have kept decisions for
            # other keys since this one loaded; re-read and lay ours over
            merged: Dict[str, Any] = {}
            try:
                with open(path) as f:
                    merged = json.load(f)
            except (OSError, ValueError):
                pass
            merged.update(_MEM or {})
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            tmp = path + f".tmp{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(merged, f, indent=1, sort_keys=True)
            os.replace(tmp, path)
        except OSError:
            pass  # a read-only directory: keep the decision in memory


def clear() -> None:
    """Drop every decision, in memory and on disk."""
    global _MEM
    with _LOCK:
        _MEM = {}
        try:
            os.remove(cache_path())
        except OSError:
            pass


def decisions() -> Dict[str, Any]:
    """A copy of the decision table (the reference prints it under
    CCV_CLI_INFO, cmd.c:564-571)."""
    return dict(_load())


def _can_measure() -> bool:
    """False while torch.compile traces the caller: the arguments are not
    real tensors then."""
    return not torch.compiler.is_compiling()


def _sig_of(x: Any) -> str:
    shape = getattr(x, "shape", None)
    dtype = getattr(x, "dtype", None)
    if shape is None:
        return repr(x)
    return f"{str(dtype).replace('torch.', '')}{list(shape)}"


def _device_of(args: Sequence[Any]) -> Optional[torch.device]:
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return None


def _kind(device: Optional[torch.device]) -> str:
    if device is not None and device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def _key(op: str, args: Sequence[Any], extra: str) -> str:
    sig = ",".join(_sig_of(a) for a in args)
    return f"{op}|{_kind(_device_of(args))}|{sig}|{extra}"


def _time_variant(fn: Callable, args: Tuple) -> Tuple[float, Optional[str]]:
    """(best seconds a call of ``fn(*args)``, the error it raised or None):
    one warm-up call, then _TRIALS trials of _PIPELINE calls each, the card
    synchronised inside the timed window (ccv_nnc_cmd_mono_time around the
    command, cmd.c:489-497)."""
    dev = _device_of(args)
    cuda = dev is not None and dev.type == "cuda"
    best = float("inf")
    try:
        for i in range(_WARMUP + _TRIALS):
            if cuda:
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            for _ in range(_PIPELINE if i >= _WARMUP else 1):
                fn(*args)
            if cuda:
                torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0
            if i >= _WARMUP:
                best = min(best, dt / _PIPELINE)
    except Exception as e:  # a form that cannot run never wins
        return float("inf"), f"{type(e).__name__}: {e}"
    return best, None


def measure(op: str, variants: Dict[str, Callable], make_args: Callable,
            extra: str = "") -> str:
    """Time every variant on ``make_args()``, keep and return the winner's
    name."""
    args = tuple(make_args())
    timed = {name: _time_variant(fn, args) for name, fn in variants.items()}
    timings = {name: t for name, (t, _e) in timed.items()}
    winner = min(timings, key=timings.get)
    rec: Dict[str, Any] = {
        "choice": winner,
        "ms": {k: (round(v * 1e3, 4) if v != float("inf") else None)
               for k, v in timings.items()}}
    errors = {k: e for k, (_t, e) in timed.items() if e is not None}
    if errors:
        rec["errors"] = errors
    cache = _load()
    with _LOCK:
        _STATS["measured"] += 1
        cache[_key(op, args, extra)] = rec
        _save()
    return winner


def recorded(op: str, args: Sequence[Any], extra: str = "") -> Optional[str]:
    """The kept winner's name for this (op, shapes, extra) key, or None if
    it was never measured: a caller can reuse a decision for a form of the
    same structure (a batch of an already measured image) without
    measuring again."""
    hit = _load().get(_key(op, args, extra))
    return hit.get("choice") if hit else None


def choose(op: str, variants: Dict[str, Callable], args: Sequence[Any],
           default: Optional[str] = None, extra: str = "") -> Callable:
    """The measured-fastest variant for these argument shapes.

    A recorded winner is returned as it is (a hit). On a miss with real
    tensors the variants are measured now and the winner kept; on a miss
    where nothing can be measured (under ``torch.compile``, or with
    ``CCV_TPU_AUTOTUNE=0``) ``default`` (the first variant if unset) is
    returned and nothing is kept, as the reference runs the command it has
    when autotune was never called."""
    if default is None:
        default = next(iter(variants))
    if len(variants) == 1:
        return variants[default]
    hit = _load().get(_key(op, args, extra))
    if hit is not None and hit.get("choice") in variants:
        with _LOCK:
            _STATS["hits"] += 1
        return variants[hit["choice"]]
    if not _can_measure():
        return variants[default]
    if os.environ.get("CCV_TPU_AUTOTUNE", "1") == "0":
        return variants[default]
    winner = measure(op, variants, lambda: args, extra=extra)
    return variants[winner]
