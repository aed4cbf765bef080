"""Geometric transforms (counterpart of ccv_tpu/ops/transform.py;
reference: lib/ccv_transform.c).

``decimal_slice``: a bilinear sub-pixel crop (TLD's patches), with 14-bit
fixed-point weights and a truncating division for integer images.
``perspective_transform``: the FOV-60 3-D warp with bilinear sampling and
zeros outside the source, as one dense gather over the image.
"""

from __future__ import annotations

import torch

from ccv_tpu_torch.ops.filters import from_hwc, is_int, to_hwc


def decimal_slice(a: torch.Tensor, y: float, x: float, rows: int,
                  cols: int) -> torch.Tensor:
    """ccv_decimal_slice twin (lib/ccv_transform.c:4).

    A rows x cols window at the decimal offset (y, x), bilinear; the 8U path
    takes 14-bit fixed-point weights and truncates. Rows and columns off the
    image are zero (the reference zeroes the output first)."""
    a, had = to_hwc(a)
    H, W = a.shape[-3], a.shape[-2]
    int_path = is_int(a)
    iy, ix = int(y), int(x)
    yd, xd = y - iy, x - ix
    w00 = (1 - xd) * (1 - yd)
    w01 = xd * (1 - yd)
    w10 = (1 - xd) * yd
    w11 = xd * yd
    if int_path:
        iw00 = int(w00 * (1 << 14) + 0.5)
        iw01 = int(w01 * (1 << 14) + 0.5)
        iw10 = int(w10 * (1 << 14) + 0.5)
        iw11 = (1 << 14) - iw00 - iw01 - iw10
        weights, den = (iw00, iw01, iw10, iw11), float(1 << 14)
    else:
        weights, den = (w00, w01, w10, w11), 1.0
    dev = a.device
    ry = torch.arange(rows, device=dev) + iy
    rx = torch.arange(cols, device=dev) + ix
    ys, xs = ry.clamp(0, H - 1), rx.clamp(0, W - 1)
    ys1, xs1 = (ys + 1).clamp(0, H - 1), (xs + 1).clamp(0, W - 1)
    af = a.to(torch.float32)

    def gather(yi, xi):
        return af.index_select(-3, yi).index_select(-2, xi)

    out = (gather(ys, xs) * weights[0] + gather(ys, xs1) * weights[1]
           + gather(ys1, xs) * weights[2] + gather(ys1, xs1) * weights[3])
    out = torch.trunc(out / den) if int_path else out / den
    mask = (((ry >= 0) & (ry <= H - 1))[:, None]
            & ((rx >= 0) & (rx <= W - 1))[None, :])
    out = torch.where(mask[..., None], out, torch.zeros_like(out))
    if a.dtype == torch.uint8:
        out = out.clamp(0, 255)
    return from_hwc(out.to(a.dtype), had)


def perspective_transform(a: torch.Tensor, m00, m01, m02, m10, m11, m12,
                          m20, m21, m22) -> torch.Tensor:
    """ccv_perspective_transform twin (lib/ccv_transform.c:120).

    The matrix is scaled by 1 / max(rows, cols) (the FOV-60 convention);
    output pixel (i, j) samples the source bilinearly at its warped
    position, zero outside, the position's integer part by C's truncating
    cast."""
    a, had = to_hwc(a)
    H, W = a.shape[-3], a.shape[-2]
    s = 1.0 / max(H, W)
    m00, m01, m02 = m00 * s, m01 * s, m02 * s
    m10, m11, m12 = m10 * s, m11 * s, m12 * s
    m20, m21 = m20 * s * s, m21 * s * s
    m22 = m22 * s
    dev = a.device
    cy = torch.arange(H, dtype=torch.float32, device=dev) - H * 0.5
    cx = torch.arange(W, dtype=torch.float32, device=dev) - W * 0.5
    cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")
    wz = 1.0 / (cxg * m20 + cyg * m21 + m22)
    wx = W * 0.5 + (cxg * m00 + cyg * m01 + m02) * wz
    wy = H * 0.5 + (cxg * m10 + cyg * m11 + m12) * wz
    iwx = torch.trunc(wx).to(torch.int64)
    iwy = torch.trunc(wy).to(torch.int64)
    fx = wx - iwx
    fy = wy - iwy
    valid = (iwx >= 0) & (iwx < W) & (iwy >= 0) & (iwy < H)
    iwx0, iwy0 = iwx.clamp(0, W - 1), iwy.clamp(0, H - 1)
    iwx1 = torch.clamp(iwx + 1, max=W - 1)
    iwy1 = torch.clamp(iwy + 1, max=H - 1)
    af = a.to(torch.float32)

    def gather(yi, xi):
        return af[..., yi, xi, :]

    out = (gather(iwy0, iwx0) * ((1 - fx) * (1 - fy))[..., None]
           + gather(iwy0, iwx1) * (fx * (1 - fy))[..., None]
           + gather(iwy1, iwx0) * ((1 - fx) * fy)[..., None]
           + gather(iwy1, iwx1) * (fx * fy)[..., None])
    out = torch.where(valid[..., None], out, torch.zeros_like(out))
    if is_int(a):
        out = torch.trunc(out).clamp(
            0, 255 if a.dtype == torch.uint8 else None)
    return from_hwc(out.to(a.dtype), had)
