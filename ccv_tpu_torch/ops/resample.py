"""Resampling on the SCD path (counterpart of ccv_tpu/ops/resample.py).

INTER_AREA is a separable linear map, ``out = Wy @ img @ Wx^T``, with the
weight matrices built on the host from the reference's coefficient rules
(_ccv_resample_area, lib/ccv_resample.c:135), including the 8U fast path's
/256 quantized weights. ``sample_down`` is the exact-2x 5-tap pyramid step
with symmetric borders and integer arithmetic (lib/ccv_resample.c:480).
INTER_CUBIC and ``sample_up`` are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ccv_tpu_torch.device import to_device
from ccv_tpu_torch.ops import filters
from ccv_tpu_torch.ops.filters import from_hwc, to_hwc

INTER_AREA = 0x01
INTER_CUBIC = 0x04


def area_weights(n_out: int, n_in: int, scale: float, quantize: bool,
                 axis: str = "x", normalize: bool = True) -> np.ndarray:
    """(n_out, n_in) interval-overlap weights for one axis.

    Follows the reference's alpha rules (lib/ccv_resample.c:160-186): partial
    cells at interval edges get fractional weight, interior cells weight 1;
    if the interval extends past the image, the last cell absorbs the excess
    (the "residue scale-up", :202-236).

    ``quantize`` reproduces the 8U fast path's /256 fixed point. The X axis
    quantizes each partial alpha independently (the xofs table); the Y axis
    quantizes the *split* at each boundary row so the two shares sum to 256
    (beta / 256 - beta in the streaming loop, :78-118).
    """
    inv = 1.0 / scale  # source cells per output cell
    w = np.zeros((n_out, n_in), dtype=np.float64)
    if quantize and axis == "y":
        dy = 0
        dy_weight_256 = 0
        for sy in range(n_in):
            if dy >= n_out:
                break
            if (dy + 1) * inv <= sy + 1:
                beta = int(max(sy + 1 - (dy + 1) * inv, 0.0) * 256)
                beta1 = 256 - beta
                carry = int(inv * 256) if sy == n_in - 1 else beta
                if beta <= 0:
                    w[dy, sy] += 1.0  # full row, and nothing carries
                else:
                    w[dy, sy] += beta1 / 256.0
                    if dy + 1 < n_out:
                        w[dy + 1, sy] += carry / 256.0
                if sy == n_in - 1 and beta <= 0 and dy + 1 < n_out:
                    # residue rows past the image get the scaled-up carry
                    w[dy + 1, sy] += int(inv * 256) / 256.0
                dy_weight_256 = beta
                dy += 1
            else:
                if sy == n_in - 1:
                    w[dy, sy] += (int(inv * 256) - dy_weight_256) / 256.0
                else:
                    w[dy, sy] += 1.0
                    dy_weight_256 += 256
        return w  # unnormalized: caller divides by inv_scale_256
    for d in range(n_out):
        fs1 = d * inv
        fs2 = fs1 + inv
        s1 = int(fs1 + 1.0 - 1e-6)
        s2 = int(fs2)
        if s1 > fs1:
            a = (s1 - fs1)
            if quantize:
                a = int(a * 256) / 256.0
            w[d, min(s1 - 1, n_in - 1)] += a
        for s in range(s1, s2):
            w[d, min(s, n_in - 1)] += 1.0
        if fs2 - s2 > 1e-3:
            a = fs2 - s2
            if quantize:
                a = int(a * 256) / 256.0
            w[d, min(s2, n_in - 1)] += a
        if fs2 > n_in:  # residue scale-up at the boundary
            w[d, n_in - 1] += fs2 - n_in
    if not normalize:
        return w
    return (w / inv).astype(np.float64)


def _apply_separable(img: torch.Tensor, wy: np.ndarray, wx: np.ndarray,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """out[..., i, j, c] = sum_{y,x} wy[i,y] * wx[j,x] * img[..., y, x, c],
    as two matmuls in ``dtype`` (TF32 is off: see ccv_tpu_torch.device)."""
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    wy_t = to_device(np.asarray(wy, np_dtype), img.device)
    wx_t = to_device(np.asarray(wx, np_dtype), img.device)
    x = img.to(dtype)
    x = torch.einsum("iy,...yxc->...ixc", wy_t, x)
    return torch.einsum("jx,...ixc->...ijc", wx_t, x)


def resample(a: torch.Tensor, rows: int = 0, cols: int = 0,
             rows_scale: float = 0.0, cols_scale: float = 0.0,
             interp: int = INTER_AREA) -> torch.Tensor:
    """ccv_resample twin for INTER_AREA downscaling. Output size =
    round(in * scale) unless given."""
    a, had = to_hwc(a)
    H, W = a.shape[-3], a.shape[-2]
    if not rows:
        rows = int(H * rows_scale + 0.5)
        cols = int(W * cols_scale + 0.5)
    if not rows_scale:
        rows_scale = rows / H
        cols_scale = cols / W
    if rows == H and cols == W:
        return from_hwc(a, had)
    if not (interp & INTER_AREA) or H < rows or W < cols:
        raise NotImplementedError(
            f"interp {interp:#x} from {H}x{W} to {rows}x{cols}: only "
            f"INTER_AREA downscaling is ported")
    is_int = filters.is_int(a)
    if a.dtype == torch.uint8 and (H * W) // (rows * cols) < 0x100:
        # 8U fast path (_ccv_resample_area_8u): quantized weights and a
        # truncating division by inv_scale_256 = int(sx*sy*65536). Every
        # product is a multiple of 1/65536 and the sums stay below 2^37 of
        # them, so float64 sums them exactly in any order: the floor below
        # cannot flip between devices or summation orders.
        inv_scale_256 = int((1.0 / cols_scale) * (1.0 / rows_scale) * 0x10000)
        wy = area_weights(rows, H, rows_scale, quantize=True, axis="y",
                          normalize=False)
        wx = area_weights(cols, W, cols_scale, quantize=True, axis="x",
                          normalize=False)
        out = _apply_separable(a, wy, wx, torch.float64).to(torch.float32)
        out = out * (65536.0 / inv_scale_256)
        out = torch.floor(out).clamp(0, 255).to(a.dtype)
        return from_hwc(out, had)
    wy = area_weights(rows, H, rows_scale, quantize=False)
    wx = area_weights(cols, W, cols_scale, quantize=False)
    # integer images: float64, so the rounding below sees the same value on
    # every device (exact .5 ties, as on a chessboard, would otherwise go
    # either way with the float32 summation order)
    out = _apply_separable(a, wy, wx,
                           torch.float64 if is_int else torch.float32)
    if is_int:
        hi = 255 if a.dtype == torch.uint8 else None
        out = torch.floor(out + 0.5).clamp(0, hi).to(a.dtype)
    return from_hwc(out, had)


def _sym_index(n: int, before: int, after: int,
               device: torch.device) -> torch.Tensor:
    """Indices of numpy's 'symmetric' pad (edge value repeated)."""
    i = torch.arange(-before, n + after, device=device)
    i = torch.where(i < 0, -i - 1, i)
    return torch.where(i >= n, 2 * n - 1 - i, i)


def sample_down(a: torch.Tensor) -> torch.Tensor:
    """ccv_sample_down twin (source offset 0): exact 2x downsample, 5-tap
    [1,4,6,4,1] Gaussian.

    Output (i, j) pulls from source centers (2i, 2j), symmetric borders;
    integer inputs use exact int arithmetic with truncating /256.
    """
    a, had = to_hwc(a)
    H, W = a.shape[-3], a.shape[-2]
    oh, ow = H // 2, W // 2
    is_int = filters.is_int(a)
    work = a.to(torch.int32 if is_int else torch.float32)
    taps = (1, 4, 6, 4, 1)

    def pass1d(x: torch.Tensor, axis: int, n_out: int):
        n = x.shape[axis]
        after = max(0, 2 * (n_out - 1) + 2 - (n - 1))
        xp = x.index_select(axis, _sym_index(n, 2, after, x.device))
        acc = None
        for t, wgt in enumerate(taps):
            idx = torch.arange(t, t + 2 * n_out, 2, device=x.device)
            term = xp.index_select(axis, idx) * wgt
            acc = term if acc is None else acc + term
        return acc

    out = pass1d(work, -2, ow)
    # the reference hard-codes asymmetric first/last-column taps
    # (lib/ccv_resample.c:524-556): first col = 10*a[0] + 5*a[1] + a[2];
    # last col = 10*a[W-1] + 5*a[W-2] + a[W-3].
    out[..., 0, :] = work[..., 0, :] * 10 + work[..., 1, :] * 5 + work[..., 2, :]
    out[..., ow - 1, :] = (work[..., W - 1, :] * 10 + work[..., W - 2, :] * 5
                           + work[..., W - 3, :])
    out = pass1d(out, -3, oh)
    if is_int:
        out = out // 256  # C's truncating division: the values are >= 0
        if a.dtype == torch.uint8:
            out = out.clamp(0, 255)
        out = out.to(a.dtype)
    else:
        out = out / 256.0
    return from_hwc(out, had)
