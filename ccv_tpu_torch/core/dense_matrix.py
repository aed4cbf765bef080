"""DenseMatrix: the ccv-compatible image/matrix shell over ``torch.Tensor``.

Counterpart of ccv_tpu/core/dense_matrix.py: the pixel payload is a tensor
of shape ``(rows, cols)`` or ``(rows, cols, channels)`` on an explicit
device, with the 64-bit content signature that drives the op cache
(``core/cache.py``); 0 means "no signature" and is never cached.
``from_numpy`` computes the signature from the host bytes as ``ccv_tpu``
does, so one array has one signature in both packages and on every
device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

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
CCV_16BF = 0x80000

_CCV_TO_DTYPE = {
    CCV_8U: np.uint8,
    CCV_32S: np.int32,
    CCV_32F: np.float32,
    CCV_64S: np.int64,
    CCV_64F: np.float64,
    CCV_16F: np.float16,
}
_DTYPE_TO_CCV = {np.dtype(v).name: k for k, v in _CCV_TO_DTYPE.items()}


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
    sig: int = 0  # 64-bit content signature; 0 = uncacheable

    @property
    def rows(self) -> int:
        return self.tensor.shape[0]

    @property
    def cols(self) -> int:
        return self.tensor.shape[1]

    @property
    def channels(self) -> int:
        return 1 if self.tensor.dim() == 2 else self.tensor.shape[2]

    @property
    def dtype(self) -> torch.dtype:
        return self.tensor.dtype

    def numpy(self) -> np.ndarray:
        return self.tensor.cpu().numpy()

    def astype(self, dtype: torch.dtype) -> "DenseMatrix":
        """A converted copy; its content is new, so it has no signature."""
        return DenseMatrix(self.tensor.to(dtype), sig=0)

    def __repr__(self):
        return (f"DenseMatrix({self.rows}x{self.cols}x{self.channels} "
                f"{self.dtype} {self.tensor.device} sig={self.sig:#x})")


def from_numpy(arr: np.ndarray, signed: bool = True,
               device: _device.DeviceLike = None) -> DenseMatrix:
    """A DenseMatrix of ``arr`` on ``device`` (default: the card; raises
    without one) with ``ccv_tpu``'s content signature of the host bytes
    (``signed=False``: none)."""
    from ccv_tpu_torch.core import cache

    arr = np.ascontiguousarray(arr)
    dev = _device.resolve(device)
    # numpy's shape (a tuple of Python ints) and dtype name, exactly what
    # ccv_tpu hashes: a torch.Size or 'torch.uint8' would change the repr
    # and so every signature
    sig = (cache.generate_signature(arr.tobytes(), arr.shape, str(arr.dtype))
           if signed else 0)
    return DenseMatrix(_device.to_device(arr, dev), sig=sig)


def to_numpy(m) -> np.ndarray:
    """A host array of a DenseMatrix, tensor or array."""
    if isinstance(m, DenseMatrix):
        return m.numpy()
    if isinstance(m, torch.Tensor):
        return m.cpu().numpy()
    return np.asarray(m)


def as_array(m, device: _device.DeviceLike = None) -> torch.Tensor:
    """Unwrap DenseMatrix | ndarray | Tensor to a tensor on ``device``
    (default: where a tensor already is, the default device otherwise)."""
    if isinstance(m, DenseMatrix):
        m = m.tensor
    if isinstance(m, torch.Tensor):
        return m if device is None else m.to(device)
    t = torch.from_numpy(np.ascontiguousarray(m))
    return t.to(_device.resolve(device))


def convert_output(x: torch.Tensor, type_tag: Optional[int]) -> torch.Tensor:
    """ccv output-type semantics (lib/ccv_internal.h ccv_matrix_setter):
    round and saturate into an integer tag's dtype, plain conversion into
    a float one. Rounds half to even, as ``ccv_tpu``'s ``jnp.round``."""
    if type_tag is None:
        return x
    dt = ccv_type_to_dtype(type_tag)
    tdt = torch.from_numpy(np.zeros(0, dt)).dtype
    if np.issubdtype(dt, np.integer):
        info = np.iinfo(dt)
        x = torch.clamp(torch.round(x), info.min, info.max)
    return x.to(tdt)
