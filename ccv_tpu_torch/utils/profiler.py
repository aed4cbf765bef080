"""Profiling hooks (counterpart of ccv_tpu/utils/profiler.py; reference:
ccv_nnc_set_profiler, lib/nnc/ccv_nnc.h:883; ccv_nnc_cmd_mono_time :735).

``set_profiler(1, trace_dir)`` starts ``torch.profiler`` with CPU
activity, and CUDA activity where torch sees a card; ``set_profiler(0)``
stops it and writes a Chrome trace (``trace_<pid>_<n>.json``, readable in
chrome://tracing or Perfetto) into that directory. ``trace(name)`` marks a
region in the trace.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Optional

import torch
from torch.profiler import ProfilerActivity, profile

_prof = None
_trace_dir: Optional[str] = None
_count = 0


def set_profiler(state: int, trace_dir: Optional[str] = None) -> None:
    """ccv_nnc_set_profiler twin: 1 starts tracing into ``trace_dir``
    (default: ``ccv_tpu_torch_trace`` under the temporary directory), 0
    stops and writes the trace. Starting twice or stopping twice does
    nothing."""
    global _prof, _trace_dir, _count
    if state and _prof is None:
        _trace_dir = trace_dir or os.path.join(tempfile.gettempdir(),
                                               "ccv_tpu_torch_trace")
        os.makedirs(_trace_dir, exist_ok=True)
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        _prof = profile(activities=activities)
        _prof.__enter__()
    elif not state and _prof is not None:
        prof, _prof = _prof, None
        prof.__exit__(None, None, None)
        _count += 1
        prof.export_chrome_trace(os.path.join(
            _trace_dir, f"trace_{os.getpid()}_{_count}.json"))


@contextlib.contextmanager
def trace(name: str):
    """Annotate a region (``torch.profiler.record_function``)."""
    with torch.profiler.record_function(name):
        yield


def mono_time() -> int:
    """ccv_nnc_cmd_mono_time twin: monotonic nanoseconds."""
    return time.monotonic_ns()
