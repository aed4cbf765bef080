"""Utilities (counterpart of ccv_tpu/utils): CLI output levels, the
profiler hooks, runtime flags (``utils.flags``) and the detection scorers
(``utils.deteval``)."""

from ccv_tpu_torch.utils.log import (
    CCV_CLI_ERROR, CCV_CLI_INFO, CCV_CLI_VERBOSE, CCV_CLI_NONE,
    set_output_levels, get_output_levels, output_level_and_above, cli_print,
)
from ccv_tpu_torch.utils.profiler import set_profiler, trace, mono_time

__all__ = [
    "CCV_CLI_ERROR", "CCV_CLI_INFO", "CCV_CLI_VERBOSE", "CCV_CLI_NONE",
    "set_output_levels", "get_output_levels", "output_level_and_above",
    "cli_print", "set_profiler", "trace", "mono_time",
]
