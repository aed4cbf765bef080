"""Image primitives on the SCD path (counterpart of ccv_tpu/ops/basic.py).

``blur`` and ``sobel`` on ``(..., H, W, C)`` tensors. Integer inputs
reproduce the reference's fixed-point arithmetic exactly (lib/ccv_basic.c).
Ported so far: the 3-tap (1,0) / (0,1) sobels and the four 3x3 diagonals;
the 3x3 and Gaussian-derivative windows are not.
"""

from __future__ import annotations

import numpy as np
import torch

from ccv_tpu_torch.ops import filters
from ccv_tpu_torch.ops.filters import correlate1d, from_hwc, to_hwc

# axis constants for (..., H, W, C)
ROWS, COLS = -3, -2

_DIAGONALS = ((1, 1), (-1, -1), (1, -1), (-1, 1))


def _double_borders(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Multiply the first/last slice along ``axis`` by 2 (ccv border rule)."""
    n = x.shape[axis]
    scale = torch.ones(n, dtype=x.dtype, device=x.device)
    scale[0] = 2
    scale[n - 1] = 2
    shape = [1] * x.dim()
    shape[axis] = n
    return x * scale.reshape(shape)


def sobel(a: torch.Tensor, dx: int = 1, dy: int = 0) -> torch.Tensor:
    """ccv_sobel twin (lib/ccv_basic.c:11) for the 3-tap windows.

    (1,0)/(0,1): central difference with doubled borders; (1,1), (-1,-1),
    (1,-1), (-1,1): the 3x3 diagonal differences. Integer inputs give int32
    outputs (bit-exact vs the reference), float inputs float32."""
    a, had = to_hwc(a)
    int_path = filters.is_int(a)
    work = a.to(torch.int32 if int_path else torch.float32)
    if (dx, dy) in ((1, 0), (0, 1)):
        axis = COLS if dx == 1 else ROWS
        out = _double_borders(correlate1d(work, [-1, 0, 1], axis), axis)
    elif (dx, dy) in _DIAGONALS:
        out = _sobel_diagonal(work, dx, dy)
    else:
        raise NotImplementedError(
            f"sobel window ({dx}, {dy}) is not ported yet")
    return from_hwc(out, had)


def _sobel_diagonal(work: torch.Tensor, dx: int, dy: int) -> torch.Tensor:
    """3x3 diagonal difference special cases (lib/ccv_basic.c:65-120).

    (1,1): interior out[i,j] = a[i+1,j+1] - a[i-1,j-1]; first row and first
    column use 2*(a[i+1,j+1]-a[i,j]) (clamped), last row / last column use
    2*(a[i,j]-a[i-1,j-1]) (clamped). (1,-1) mirrors the columns."""
    H, W = work.shape[ROWS], work.shape[COLS]
    main_diag = (dx, dy) in ((1, 1), (-1, -1))
    xp = filters.edge_pad(filters.edge_pad(work, 1, 1, ROWS), 1, 1, COLS)

    def shifted(di: int, dj: int) -> torch.Tensor:
        return xp.narrow(ROWS, 1 + di, H).narrow(COLS, 1 + dj, W)

    rows = torch.arange(H, device=work.device)[:, None, None]
    cols = torch.arange(W, device=work.device)[None, :, None]
    first_row, last_row = rows == 0, rows == H - 1
    first_col, last_col = cols == 0, cols == W - 1
    if main_diag:
        fwd, bwd = shifted(1, 1), shifted(-1, -1)
        lead = first_row | first_col   # 2*(fwd - a)
        trail = last_row | last_col    # 2*(a - bwd)
    else:
        fwd, bwd = shifted(1, -1), shifted(-1, 1)
        lead = first_row | last_col
        trail = last_row | first_col
    # row rules win over column rules, as the reference writes row 0 with
    # the lead rule across all columns; the bottom row always takes the
    # trail rule, even at lead columns
    out = torch.where(trail, 2 * (work - bwd), fwd - bwd)
    out = torch.where(lead, 2 * (fwd - work), out)
    return torch.where(last_row, 2 * (work - bwd), out)


def blur_taps(sigma: float, as_int: bool) -> np.ndarray:
    """Gaussian taps with ccv's size rule and quantization (ccv_basic.c:418)."""
    fsz = max(1, int(4.0 * sigma + 1.0 - 1e-8)) * 2 + 1
    taps = filters.gaussian_taps(sigma, fsz)
    if as_int:
        taps = np.floor(taps * (256.0 / taps.sum()) + 0.5).astype(np.int64)
    else:
        taps = taps / taps.sum()
    return taps


def blur(a: torch.Tensor, sigma: float) -> torch.Tensor:
    """ccv_blur twin: separable Gaussian, replicate borders.

    8U path: x256 integer taps, >>8 after each of the two passes, clamp at
    the final store (bit-exact vs the reference)."""
    a, had = to_hwc(a)
    int_path = filters.is_int(a)
    taps = blur_taps(sigma, as_int=int_path)
    work = a.to(torch.int32 if int_path else torch.float32)
    shift = 8 if int_path else 0
    out = correlate1d(work, taps, COLS, shift=shift)
    out = correlate1d(out, taps, ROWS, shift=shift)
    if a.dtype == torch.uint8:
        out = out.clamp(0, 255).to(torch.uint8)
    return from_hwc(out, had)
