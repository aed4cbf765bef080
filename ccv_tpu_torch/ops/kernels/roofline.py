"""The least time the card could take for a kernel's work (its bound).

Published peaks of one NVIDIA H100 SXM at its full 700 W power limit
(NVIDIA's data sheet, dense rates): 989 TFLOP/s in bf16 and in float16 on
the tensor cores, 67 TFLOP/s in float32 outside them, 3.35 TB/s of HBM. The bound of a
call is the larger of its operations over the peak rate of their type and
its bytes (each input read once, each output written once) over the memory
rate; ``bound_by`` says which of the two it is.
"""

from __future__ import annotations

from typing import Tuple

PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "f16": 989e12, "f32": 67e12}


def bound_ms(ops: float, nbytes: float, kind: str) -> Tuple[float, str]:
    """(bound in ms, "operations" or "bytes") for ``ops`` operations of
    type ``kind`` ("bf16" or "f16" tensor-core, or "f32" ALU) moving
    ``nbytes``."""
    t_ops = ops / PEAK_OPS_PER_S[kind]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")
