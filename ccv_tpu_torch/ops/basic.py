"""Image primitives (counterpart of ccv_tpu/ops/basic.py).

``blur``, ``sobel`` and ``gradient`` on ``(..., H, W, C)`` tensors. Integer
inputs reproduce the reference's fixed-point arithmetic exactly
(lib/ccv_basic.c). ``flip``, ``erode`` and ``dilate`` return new tensors
and never write into their input.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ccv_tpu_torch.ops import filters
from ccv_tpu_torch.ops.filters import correlate1d, from_hwc, to_hwc

# axis constants for (..., H, W, C)
ROWS, COLS = -3, -2

_DIAGONALS = ((1, 1), (-1, -1), (1, -1), (-1, 1))

CCV_PI = 3.141592653589793


def _double_borders(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Multiply the first/last slice along ``axis`` by 2 (ccv border rule)."""
    n = x.shape[axis]
    scale = torch.ones(n, dtype=x.dtype, device=x.device)
    scale[0] = 2
    scale[n - 1] = 2
    shape = [1] * x.dim()
    shape[axis] = n
    return x * scale.reshape(shape)


def _sobel_general_taps(fsz: int, as_int: bool):
    """Gaussian-derivative taps for windows >= 5 (lib/ccv_basic.c:196-225)."""
    hfz = fsz // 2
    sigma = ((fsz - 1) / 2) * 0.47 + 0.38
    sigma2 = 2.0 * sigma * sigma
    psigma3 = 2.5 / math.sqrt(math.sqrt(2 * CCV_PI) * sigma * sigma * sigma)
    i = np.arange(fsz, dtype=np.float64)
    df = (i - hfz) * np.exp(-((i - hfz) ** 2) / sigma2) * psigma3
    gf = np.exp(-((i - hfz) ** 2) / sigma2) * psigma3
    if as_int:
        df = np.round(df * 256.0).astype(np.int64)
        gf = np.floor(gf * 256.0 + 0.5).astype(np.int64)
    return df, gf


def sobel(a: torch.Tensor, dx: int = 1, dy: int = 0,
          out_float: bool = False) -> torch.Tensor:
    """ccv_sobel twin (lib/ccv_basic.c:11).

    (1,0)/(0,1): central difference with doubled borders; (1,1), (-1,-1),
    (1,-1), (-1,1): the 3x3 diagonal differences; (3,0)/(0,3): the classic
    3x3 Sobel (smooth [1,2,1] x difference [-1,0,1]); else the window
    max(dx, dy), odd: the separable Gaussian derivative, fixed-point for integer outputs
    (x256 taps, >> 8 after each pass). Integer inputs give int32 outputs
    (bit-exact vs the reference) unless ``out_float``; float inputs stay
    float32."""
    a, had = to_hwc(a)
    int_path = filters.is_int(a) and not out_float
    work = a.to(torch.int32 if int_path else torch.float32)
    if (dx, dy) in ((1, 0), (0, 1)):
        axis = COLS if dx == 1 else ROWS
        out = _double_borders(correlate1d(work, [-1, 0, 1], axis), axis)
    elif (dx, dy) in _DIAGONALS:
        out = _sobel_diagonal(work, dx, dy)
    elif (dx, dy) in ((3, 0), (0, 3)):
        diff_axis = COLS if dx == 3 else ROWS
        smooth_axis = ROWS if dx == 3 else COLS
        out = correlate1d(correlate1d(work, [1, 2, 1], smooth_axis),
                          [-1, 0, 1], diff_axis)
    else:
        fsz = max(dx, dy)
        if fsz % 2 != 1:
            raise ValueError(f"sobel window ({dx}, {dy}) is not odd")
        df, gf = _sobel_general_taps(fsz, as_int=int_path)
        shift = 8 if int_path else 0
        # the horizontal pass takes the derivative taps when dx >= dy (ccv
        # swaps df and gf when dx < dy, lib/ccv_basic.c:236-241)
        htaps, vtaps = (df, gf) if dx >= dy else (gf, df)
        out = correlate1d(correlate1d(work, htaps, COLS, shift=shift),
                          vtaps, ROWS, shift=shift)
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


def _fast_atan2(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """OpenCV-style fast atan2 in degrees [0, 360) (lib/ccv_basic.c:283-343),
    float32, in ccv_tpu's expression order term for term: every product,
    sum and quotient is its own rounding (one torch op each, so no fused
    multiply-add), which keeps ICF's orientation bins and SIFT's histograms
    on the same side of a bin edge on every device."""
    x2 = x * x
    y2 = y * y
    eps, c = 1e-6, 0.28
    lo_off = torch.where(x < 0, CCV_PI, torch.where(y >= 0, 0.0, 2 * CCV_PI)
                         ).to(torch.float32)
    a_lo = x * y / (x2 + c * y2 + eps) + lo_off
    hi_off = torch.where(y >= 0, CCV_PI * 0.5, CCV_PI * 1.5).to(torch.float32)
    a_hi = hi_off - x * y / (y2 + c * x2 + eps)
    a = torch.where(y2 <= x2, a_lo, a_hi)
    return a * (180.0 / CCV_PI)


def sqrt32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root on every device: torch's
    vectorised float32 sqrt on the CPU can be one ulp off, which the card's
    and XLA's are not; through float64 the second rounding cannot flip."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def gradient(a: torch.Tensor, dx: int = 1, dy: int = 1):
    """ccv_gradient twin: (theta in degrees, magnitude), float32."""
    gx = sobel(a, dx, 0, out_float=True)
    gy = sobel(a, 0, dy, out_float=True)
    return _fast_atan2(gx, gy), sqrt32(gx * gx + gy * gy)


FLIP_X = 0x01  # horizontal mirror
FLIP_Y = 0x02  # vertical mirror


def flip(a: torch.Tensor, ftype: int) -> torch.Tensor:
    """ccv_flip twin: mirror the columns (FLIP_X) and/or the rows
    (FLIP_Y)."""
    a, had = to_hwc(a)
    dims = ([ROWS] if ftype & FLIP_Y else []) + (
        [COLS] if ftype & FLIP_X else [])
    out = torch.flip(a, dims) if dims else a.clone()
    return from_hwc(out, had)


def blur_taps(sigma: float, as_int: bool) -> np.ndarray:
    """Gaussian taps with ccv's size rule and quantization (ccv_basic.c:418)."""
    fsz = max(1, int(4.0 * sigma + 1.0 - 1e-8)) * 2 + 1
    taps = filters.gaussian_taps(sigma, fsz)
    if as_int:
        taps = np.floor(taps * (256.0 / taps.sum()) + 0.5).astype(np.int64)
    else:
        taps = taps / taps.sum()
    return taps


def blur(a: torch.Tensor, sigma: float, out_float: bool = False
         ) -> torch.Tensor:
    """ccv_blur twin: separable Gaussian, replicate borders.

    8U path: x256 integer taps, >>8 after each of the two passes, clamp at
    the final store (bit-exact vs the reference). ``out_float`` takes the
    float path (normalised taps, float32 out) for integer input too."""
    a, had = to_hwc(a)
    int_path = filters.is_int(a) and not out_float
    taps = blur_taps(sigma, as_int=int_path)
    work = a.to(torch.int32 if int_path else torch.float32)
    shift = 8 if int_path else 0
    out = correlate1d(work, taps, COLS, shift=shift)
    out = correlate1d(out, taps, ROWS, shift=shift)
    if int_path and a.dtype == torch.uint8:
        out = out.clamp(0, 255).to(torch.uint8)
    return from_hwc(out, had)


def erode(a: torch.Tensor, fsz: int = 3) -> torch.Tensor:
    """ccv_erode twin: separable running min, replicate borders."""
    a, had = to_hwc(a)
    out = filters.min_filter1d(a, fsz, COLS)
    out = filters.min_filter1d(out, fsz, ROWS)
    return from_hwc(out, had)


def dilate(a: torch.Tensor, fsz: int = 3) -> torch.Tensor:
    """ccv_dilate twin: separable running max, replicate borders."""
    a, had = to_hwc(a)
    out = filters.max_filter1d(a, fsz, COLS)
    out = filters.max_filter1d(out, fsz, ROWS)
    return from_hwc(out, had)
