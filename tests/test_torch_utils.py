"""Port parity: flags, log levels and the profiler hooks
(ccv_tpu_torch/utils), against ccv_tpu/utils on the CPU.

- CCV_TPU_FLAGS is read once at import (a fresh process), names and bits
  as ccv_tpu's;
- enable_flag / disable_flag / flags / is_set;
- the CLI output levels, as tests/test_aux.py holds ccv_tpu's;
- set_profiler(1/0, dir) on the CPU writes a Chrome trace there, with a
  ``trace`` region in it;
- mono_time is monotonic nanoseconds.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from ccv_tpu.utils import flags as jflags
from ccv_tpu.utils import log as jlog
from ccv_tpu_torch.utils import flags, log, mono_time, set_profiler, trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("spec,want", [
    ("", 0),
    ("disable_native_runtime", flags.DISABLE_NATIVE_RUNTIME),
    (" Disable_Staged_Cascade , disable_memory_compression,bogus",
     flags.DISABLE_STAGED_CASCADE | flags.DISABLE_MEMORY_COMPRESSION),
])
def test_env_flags_read_at_import(spec, want):
    env = dict(os.environ, CCV_TPU_FLAGS=spec)
    out = subprocess.run(
        [sys.executable, "-c", "from ccv_tpu_torch.utils import flags; "
         "print(flags.flags())"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) == want == flags.parse(spec)


def test_flag_bits_equal_ccv_tpu():
    assert flags._NAMES == jflags._NAMES
    for name in ("DISABLE_PALLAS_FLASH_ATTENTION", "DISABLE_STAGED_CASCADE",
                 "DISABLE_NATIVE_RUNTIME", "DISABLE_PERSISTENT_COMPILE_CACHE",
                 "DISABLE_MEMORY_COMPRESSION"):
        assert getattr(flags, name) == getattr(jflags, name)


def test_enable_disable_is_set():
    before = flags.flags()
    try:
        flags.enable_flag(flags.DISABLE_STAGED_CASCADE)
        assert flags.is_set(flags.DISABLE_STAGED_CASCADE)
        assert flags.flags() & flags.DISABLE_STAGED_CASCADE
        flags.disable_flag(flags.DISABLE_STAGED_CASCADE)
        assert not flags.is_set(flags.DISABLE_STAGED_CASCADE)
    finally:
        flags.disable_flag(0x1F)
        flags.enable_flag(before)
    assert flags.flags() == before


def test_log_levels(capsys):
    before = log.get_output_levels()
    try:
        for lvl in (log.CCV_CLI_ERROR, log.CCV_CLI_INFO, log.CCV_CLI_VERBOSE,
                    log.CCV_CLI_NONE):
            assert log.output_level_and_above(lvl) == \
                jlog.output_level_and_above(lvl)
        log.set_output_levels(log.output_level_and_above(log.CCV_CLI_INFO))
        log.cli_print(log.CCV_CLI_INFO, "info %d", 42)
        log.cli_print(log.CCV_CLI_VERBOSE, "hidden")
        log.cli_print(log.CCV_CLI_ERROR, "bad")
        out = capsys.readouterr()
        assert "info 42" in out.out and "hidden" not in out.out
        assert "bad" in out.err
    finally:
        log.set_output_levels(before)


def test_set_profiler_writes_a_trace(tmp_path):
    set_profiler(1, str(tmp_path))
    set_profiler(1, str(tmp_path / "other"))  # already on: no second start
    with trace("ccv_region"):
        torch.ones(64, 64).matmul(torch.ones(64, 64))
    set_profiler(0)
    set_profiler(0)  # already off
    files = sorted(tmp_path.glob("trace_*.json"))
    assert len(files) == 1 and not (tmp_path / "other").exists()
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "ccv_region" for e in events)


def test_mono_time_is_monotonic():
    ts = [mono_time() for _ in range(1000)]
    assert all(b >= a for a, b in zip(ts, ts[1:]))
    assert isinstance(ts[0], int) and ts[-1] > 0
