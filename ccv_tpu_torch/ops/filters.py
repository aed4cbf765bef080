"""Separable-filter building blocks (counterpart of ccv_tpu/ops/filters.py).

Helpers take tensors shaped ``(..., H, W, C)``. Integer inputs keep the
reference's integer semantics: accumulations run in float32, exact while
below 2^24, and the arithmetic right shift is ``floor(acc * 2^-s)``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def is_int(x: torch.Tensor) -> bool:
    """Integer dtype: the reference's fixed-point semantics apply."""
    return not (x.dtype.is_floating_point or x.dtype.is_complex)


def to_hwc(x: torch.Tensor):
    """Normalize (H, W) -> (H, W, 1); returns (tensor, had_channels)."""
    if x.dim() == 2:
        return x[..., None], False
    return x, True


def from_hwc(x: torch.Tensor, had_channels: bool) -> torch.Tensor:
    return x if had_channels else x[..., 0]


def edge_pad(x: torch.Tensor, before: int, after: int,
             axis: int) -> torch.Tensor:
    """Replicate-pad along one axis (ccv's border handling)."""
    n = x.shape[axis]
    idx = torch.arange(-before, n + after, device=x.device).clamp(0, n - 1)
    return x.index_select(axis, idx)


def correlate1d(x: torch.Tensor, taps: Sequence, axis: int,
                shift: int = 0) -> torch.Tensor:
    """Correlate with an explicit tap list along ``axis``, replicate-padded.

    Centered window of size ``len(taps)`` with center ``len(taps)//2``.
    ``shift``: arithmetic right shift of integer accumulations
    (_ccv_set_32s_value_1, lib/ccv_internal.h:256), as floor(acc * 2^-s).
    """
    taps = list(taps)
    fsz = len(taps)
    hfz = fsz // 2
    xp = edge_pad(x, hfz, fsz - 1 - hfz, axis)
    int_path = is_int(x)
    acc_dtype = torch.float32 if int_path else x.dtype
    n = x.shape[axis]
    acc = None
    for k, t in enumerate(taps):
        term = xp.narrow(axis, k, n).to(acc_dtype) * float(
            np.asarray(t, np.float32))
        acc = term if acc is None else acc + term
    if int_path:
        if shift:
            acc = torch.floor(acc * (2.0 ** -shift))
        acc = acc.to(torch.int32)
    return acc


def gaussian_taps(sigma: float, fsz: int) -> np.ndarray:
    """Unnormalized Gaussian taps, center fsz//2."""
    hfz = fsz // 2
    i = np.arange(fsz, dtype=np.float64)
    return np.exp(-((i - hfz) ** 2) / (2.0 * sigma * sigma))
