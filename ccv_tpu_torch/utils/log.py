"""CLI output levels (counterpart of ccv_tpu/utils/log.py; reference:
lib/ccv_output.c, lib/ccv.h:2480-2492)."""

from __future__ import annotations

import sys

CCV_CLI_ERROR = 1 << 2
CCV_CLI_INFO = 1 << 1
CCV_CLI_VERBOSE = 1
CCV_CLI_NONE = 0

_levels = CCV_CLI_ERROR | CCV_CLI_INFO


def set_output_levels(level: int) -> None:
    global _levels
    _levels = level


def get_output_levels() -> int:
    return _levels


def output_level_and_above(level: int) -> int:
    """ccv_cli_output_level_and_above twin: ERROR implies nothing else;
    VERBOSE implies INFO and ERROR."""
    if level == CCV_CLI_VERBOSE:
        return CCV_CLI_VERBOSE | CCV_CLI_INFO | CCV_CLI_ERROR
    if level == CCV_CLI_INFO:
        return CCV_CLI_INFO | CCV_CLI_ERROR
    return level


def cli_print(level: int, fmt: str, *args) -> None:
    if level & _levels:
        out = sys.stderr if level == CCV_CLI_ERROR else sys.stdout
        print(fmt % args if args else fmt, file=out)
