"""Resampling (counterpart of ccv_tpu/ops/resample.py; reference
lib/ccv_resample.c).

Area and cubic interpolation are separable linear maps, ``out = Wy @ img @
Wx^T``, with the weight matrices built on the host from the reference's
coefficient rules:

- area (_ccv_resample_area, lib/ccv_resample.c:135), including the 8U fast
  path's /256 quantized weights;
- cubic (_ccv_init_cubic_coeffs, lib/ccv_resample.c:280): A = -0.75 taps at
  (i + 0.5) * scale - 0.5, clamped indices; integer images take the x64
  fixed-point taps and the descale by 12 bits. INTER_LINEAR and
  INTER_LANCZOS go through the same cubic weights, as in ccv_tpu.

``sample_down`` / ``sample_up`` (lib/ccv_resample.c:480 / :559) are the
exact-2x 5-tap and 3-tap pyramid steps with symmetric borders, in integer
arithmetic for integer inputs (the /256 and /1024 truncating divisions).
"""

from __future__ import annotations

import numpy as np
import torch

from ccv_tpu_torch.device import to_device
from ccv_tpu_torch.ops import filters
from ccv_tpu_torch.ops.filters import from_hwc, to_hwc

INTER_AREA = 0x01
INTER_LINEAR = 0x02
INTER_CUBIC = 0x04
INTER_LANCZOS = 0x08


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


def cubic_weights(n_out: int, n_in: int, scale: float,
                  quantize: bool) -> np.ndarray:
    """(n_out, n_in) cubic-convolution weights (A=-0.75), clamped indices.
    The source position goes through float32 and truncates toward zero
    (``int``), as ccv_tpu does: the first rows of an up-scale, where it lies
    in (-1, 0), take tap 0 there, not -1."""
    A = -0.75
    inv = 1.0 / scale
    w = np.zeros((n_out, n_in), dtype=np.float64)
    for d in range(n_out):
        s = np.float32((d + 0.5) * inv - 0.5)
        si = int(s)
        x = float(s) - si
        c0 = ((A * (x + 1) - 5 * A) * (x + 1) + 8 * A) * (x + 1) - 4 * A
        c1 = ((A + 2) * x - (A + 3)) * x * x + 1
        c2 = ((A + 2) * (1 - x) - (A + 3)) * (1 - x) * (1 - x) + 1
        if quantize:  # x64 fixed point (_ccv_init_cubic_integer_coeffs)
            q0 = int(c0 * 64 + 0.5)
            q1 = int(c1 * 64 + 0.5)
            q2 = int(c2 * 64 + 0.5)
            coeffs = (q0, q1, q2, 64 - q0 - q1 - q2)
        else:
            coeffs = (c0, c1, c2, 1.0 - c0 - c1 - c2)
        for t, c in enumerate(coeffs):
            w[d, min(max(si - 1 + t, 0), n_in - 1)] += c
    return w


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
    """ccv_resample twin. Output size = round(in * scale) unless given.
    INTER_AREA shrinks; INTER_CUBIC (or LINEAR or LANCZOS, through the same
    weights) scales either way; INTER_AREA alone on an up-scale raises."""
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
    is_int = filters.is_int(a)
    if (interp & INTER_AREA) and H >= rows and W >= cols:
        return from_hwc(_area(a, H, W, rows, cols, rows_scale, cols_scale,
                              is_int), had)
    if not interp & (INTER_CUBIC | INTER_LINEAR | INTER_LANCZOS):
        raise NotImplementedError(
            f"interp {interp:#x} from {H}x{W} to {rows}x{cols}")
    wy = cubic_weights(rows, H, rows_scale, quantize=is_int)
    wx = cubic_weights(cols, W, cols_scale, quantize=is_int)
    if not is_int:
        return from_hwc(_apply_separable(a, wy, wx), had)
    # every term is an integer (x64 taps on both axes times a pixel) whose
    # partial sums stay far below 2^53, so float64 sums them exactly in any
    # order and the card gives the CPU's bytes; then ccv_descale(sum, 12),
    # (sum + 2048) >> 12, as a floor of an exact quotient
    out = _apply_separable(a, wy, wx, torch.float64)
    out = torch.floor((out + 2048.0) / 4096.0)
    hi = 255 if a.dtype == torch.uint8 else None
    return from_hwc(out.clamp(0, hi).to(a.dtype), had)


def _area(a: torch.Tensor, H: int, W: int, rows: int, cols: int,
          rows_scale: float, cols_scale: float, is_int: bool) -> torch.Tensor:
    """INTER_AREA shrink of a (..., H, W, C) tensor."""
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
        return torch.floor(out).clamp(0, 255).to(a.dtype)
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
    return out


def _sym_index(n: int, before: int, after: int,
               device: torch.device) -> torch.Tensor:
    """Indices of numpy's 'symmetric' pad (edge value repeated)."""
    i = torch.arange(-before, n + after, device=device)
    i = torch.where(i < 0, -i - 1, i)
    return torch.where(i >= n, 2 * n - 1 - i, i)


def sample_down(a: torch.Tensor, src_x: int = 0,
                src_y: int = 0) -> torch.Tensor:
    """ccv_sample_down twin: exact 2x downsample, 5-tap [1,4,6,4,1] Gaussian.

    Output (i, j) pulls from source centers (2i + src_y, 2j + src_x),
    symmetric borders; integer inputs use exact int arithmetic with
    truncating /256.
    """
    a, had = to_hwc(a)
    H, W = a.shape[-3], a.shape[-2]
    oh, ow = H // 2, W // 2
    is_int = filters.is_int(a)
    work = a.to(torch.int32 if is_int else torch.float32)
    taps = (1, 4, 6, 4, 1)

    def pass1d(x: torch.Tensor, axis: int, n_out: int, src: int):
        # pad so window centers 2*i + src with +/-2 reach are valid
        n = x.shape[axis]
        after = max(0, 2 * (n_out - 1) + src + 2 - (n - 1))
        xp = x.index_select(axis, _sym_index(n, 2, after, x.device))
        acc = None
        for t, wgt in enumerate(taps):
            idx = torch.arange(src + t, src + t + 2 * n_out, 2,
                               device=x.device)
            term = xp.index_select(axis, idx) * wgt
            acc = term if acc is None else acc + term
        return acc

    out = pass1d(work, -2, ow, src_x)
    # the reference hard-codes asymmetric first/last-column taps
    # (lib/ccv_resample.c:524-556): first col = 10*a[sx] + 5*a[sx+1] +
    # a[sx+2]; last col (src_x == 0 only) = 10*a[W-1] + 5*a[W-2] + a[W-3].
    out[..., 0, :] = (work[..., src_x, :] * 10 + work[..., src_x + 1, :] * 5
                      + work[..., src_x + 2, :])
    if src_x == 0:
        out[..., ow - 1, :] = (work[..., W - 1, :] * 10
                               + work[..., W - 2, :] * 5 + work[..., W - 3, :])
    out = pass1d(out, -3, oh, src_y)
    if is_int:
        out = out // 256  # C's truncating division: the values are >= 0
        if a.dtype == torch.uint8:
            out = out.clamp(0, 255)
        out = out.to(a.dtype)
    else:
        out = out / 256.0
    return from_hwc(out, had)


# sample_up 3-tap weights at distances 0.25 / 0.75 / 1.25 (lib/ccv_resample.c)
_UP_INT = (23, 8, 1)      # G025, G075, G125 quantized; GALL = 1024
_UP_FLT = (0.705385, 0.259496, 0.035119)


def sample_up(a: torch.Tensor, src_x: int = 0,
              src_y: int = 0) -> torch.Tensor:
    """ccv_sample_up twin: exact 2x upsample.

    even out[2i] = G075*a[i-1] + G025*a[i] + G125*a[i+1]
    odd  out[2i+1] = G125*a[i-1] + G025*a[i] + G075*a[i+1]
    with the source window shifted by ``src``; symmetric borders; the
    integer path divides by 1024 truncating.
    """
    a, had = to_hwc(a)
    is_int = filters.is_int(a)
    g025, g075, g125 = _UP_INT if is_int else _UP_FLT
    work = a.to(torch.int32 if is_int else torch.float32)

    def pass1d(x: torch.Tensor, axis: int, src: int):
        n = x.shape[axis]
        # the window of output pair i covers source i+src-1 .. i+src+1; the
        # reference mirrors indices past either end (its tab[])
        xp = x.index_select(axis, _sym_index(n, 1, src + 1, x.device))
        prev, cur, nxt = (xp.narrow(axis, src + t, n) for t in range(3))
        even = prev * g075 + cur * g025 + nxt * g125
        odd = prev * g125 + cur * g025 + nxt * g075
        # interleave along axis: stack right after it, then merge the two
        shape = list(x.shape)
        shape[axis] = 2 * n
        return torch.stack([even, odd], dim=axis).reshape(shape)

    out = pass1d(work, -2, src_x)
    out = pass1d(out, -3, src_y)
    if is_int:
        out = out // 1024  # the values are >= 0 for unsigned images
        if a.dtype == torch.uint8:
            out = out.clamp(0, 255)
        out = out.to(a.dtype)
    return from_hwc(out, had)
