"""DenseMatrix: the ccv-compatible image/matrix shell over ``torch.Tensor``.

Counterpart of ccv_tpu/core/dense_matrix.py, cut to what the ported paths
use: the pixel payload is a tensor of shape ``(rows, cols)`` or
``(rows, cols, channels)`` on an explicit device. The reference's content
signature and memoization cache are not ported.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ccv_tpu_torch import device as _device

# ccv data type tags (lib/ccv.h:45-52), kept for the CCVBINDM reader
CCV_8U = 0x01000
CCV_32S = 0x02000
CCV_32F = 0x04000
CCV_64S = 0x08000
CCV_64F = 0x10000
CCV_16F = 0x20000

_CCV_TO_DTYPE = {
    CCV_8U: np.uint8,
    CCV_32S: np.int32,
    CCV_32F: np.float32,
    CCV_64S: np.int64,
    CCV_64F: np.float64,
    CCV_16F: np.float16,
}


def ccv_type_to_dtype(type_tag: int) -> np.dtype:
    """Map a ccv type tag (possibly OR'd with a channel count) to a dtype."""
    data = type_tag & 0xFF000
    for tag, dt in _CCV_TO_DTYPE.items():
        if data & tag:
            return np.dtype(dt)
    raise ValueError(f"unknown ccv type tag {type_tag:#x}")


def ccv_type_channels(type_tag: int) -> int:
    """Channel count lives in the low 12 bits (lib/ccv.h CCV_GET_CHANNEL)."""
    return type_tag & 0xFFF


@dataclasses.dataclass
class DenseMatrix:
    """An image/matrix: ``tensor`` is (rows, cols) or (rows, cols, channels)."""

    tensor: torch.Tensor

    @property
    def rows(self) -> int:
        return self.tensor.shape[0]

    @property
    def cols(self) -> int:
        return self.tensor.shape[1]

    def numpy(self) -> np.ndarray:
        return self.tensor.cpu().numpy()


def from_numpy(arr: np.ndarray, device: _device.DeviceLike = None
               ) -> DenseMatrix:
    """A DenseMatrix of ``arr`` on ``device`` (default: the card; raises
    without one)."""
    return DenseMatrix(torch.from_numpy(np.ascontiguousarray(arr)).to(
        _device.resolve(device)))


def as_array(m, device: _device.DeviceLike = None) -> torch.Tensor:
    """Unwrap DenseMatrix | ndarray | Tensor to a tensor on ``device``
    (default: where a tensor already is, the default device otherwise)."""
    if isinstance(m, DenseMatrix):
        m = m.tensor
    if isinstance(m, torch.Tensor):
        return m if device is None else m.to(device)
    t = torch.from_numpy(np.ascontiguousarray(m))
    return t.to(_device.resolve(device))
