"""Device choice and the float32 numerics policy of the port.

The port runs on the card unless the caller asks for the CPU: with no
device given and no tensor to take one from, the device is the first CUDA
device, and a machine without one raises rather than running on the CPU.
A tensor or ``DenseMatrix`` that is already on the CPU is the caller asking
for the CPU.

TF32 is switched off for matmuls and cuDNN convolutions when the package is
imported. The INTER_AREA resample is a pair of matmuls whose results are
floored back to uint8; TF32 keeps about three decimal digits, which moves
pixel values across the floor and breaks the uint8 bit-exactness the
reference holds. ``ccv_tpu`` pins ``Precision.HIGHEST`` on the TPU for the
same reason (ccv_tpu/ops/resample.py, ccv_tpu/detectors/scd.py).
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DeviceLike = Union[str, torch.device, None]


def default_device() -> torch.device:
    """The first CUDA device; raises when there is none (ask for the CPU
    explicitly with ``device="cpu"``)."""
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA device is required, and torch sees none "
                           "(pass device='cpu' to run on the CPU)")
    return torch.device("cuda:0")


def resolve(device: DeviceLike = None,
            like: Optional[torch.Tensor] = None) -> torch.device:
    """``device`` if given, else the device of ``like``, else the default."""
    if device is not None:
        return torch.device(device)
    if like is not None:
        return like.device
    return default_device()


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``. A CUDA copy goes through pinned memory
    with ``non_blocking``, so it does not wait for the work already queued
    on the stream (a pageable copy synchronises the stream)."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
