"""Classic image primitives (counterpart of ccv_tpu/ops/classic.py, the
parts SWT needs; reference: lib/ccv_classic.c).

canny is the reference's integer path: sobel -> |dx| + |dy| ->
direction-binned non-maximum suppression -> hysteresis. The reference thins
its seeds with a sequential suppress flag, but every suppressed strong
pixel is 8-adjacent to an emitted seed, so the edge map after hysteresis is
plain hysteresis from all strong survivors: here a fixpoint of 3x3
dilations through the weak pixels. The fixpoint test reads a flag back
from the device, so several dilations run between tests; the fixpoint is
the same. otsu and close_outline are direct vectorisations.
``hog`` and ``optical_flow_lucas_kanade`` are not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ccv_tpu_torch.core.algebra import tiled_cumsum
from ccv_tpu_torch.ops import basic

_TG22 = int(0.4142135623730950488016887242097 * (1 << 15) + 0.5)

# dilations between two fixpoint tests of the hysteresis
SWEEPS = 8


def _shifted(fp: torch.Tensor, di: int, dj: int, H: int, W: int):
    """fp is zero-padded by one: the (H, W) plane shifted by (di, dj)."""
    return fp[1 + di:1 + di + H, 1 + dj:1 + dj + W]


def canny_nms(dx: torch.Tensor, dy: torch.Tensor, low: int):
    """Direction-binned non-maximum suppression on f = |dx| + |dy| (int32).

    Returns (f, keep) where keep marks survivors with f > low. The
    comparisons are lib/ccv_classic.c:245-295's (strict or not per
    direction); neighbours outside the image compare as 0."""
    f = dx.abs() + dy.abs()
    H, W = f.shape
    fp = F.pad(f, (1, 1, 1, 1))

    def nb(di, dj):
        return _shifted(fp, di, dj, H, W)

    x = dx.abs()
    y = dy.abs() << 15
    tg22x = x * _TG22
    tg67x = tg22x + ((x + x) << 15)
    horiz = y < tg22x
    vert = y > tg67x
    keep_h = (f > nb(0, -1)) & (f >= nb(0, 1))
    keep_v = (f > nb(-1, 0)) & (f >= nb(1, 0))
    # diagonal: f > rows[0][j - s] && f > rows[2][j + s], both strict
    keep_d = torch.where((dx ^ dy) < 0,
                         (f > nb(-1, 1)) & (f > nb(1, -1)),    # s = -1
                         (f > nb(-1, -1)) & (f > nb(1, 1)))    # s = 1
    keep = torch.where(horiz, keep_h, torch.where(vert, keep_v, keep_d))
    return f, keep & (f > low)


def _dilate8(m: torch.Tensor) -> torch.Tensor:
    H, W = m.shape
    mp = F.pad(m, (1, 1, 1, 1))
    out = m
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            if di or dj:
                out = out | _shifted(mp, di, dj, H, W)
    return out


def _hysteresis(strong: torch.Tensor, weak: torch.Tensor) -> torch.Tensor:
    """Strong pixels grown through 8-connected weak pixels to the fixpoint,
    SWEEPS dilations per test of whether anything changed."""
    cur = strong
    while True:
        before = cur
        for _ in range(SWEEPS):
            cur = (_dilate8(cur) & weak) | cur
        if torch.equal(cur, before):
            return cur


def canny(a: torch.Tensor, size: int = 3, low_thresh: float = 36,
          high_thresh: float = 36 * 3) -> torch.Tensor:
    """ccv_canny twin (lib/ccv_classic.c:196): a uint8 0/1 edge map."""
    if a.dim() != 2:
        raise ValueError(f"canny expects a single-channel (H, W) image, got "
                         f"{tuple(a.shape)}")
    low = int(low_thresh + 0.5)
    high = int(high_thresh + 0.5)
    dx = basic.sobel(a, size, 0).to(torch.int32)
    dy = basic.sobel(a, 0, size).to(torch.int32)
    f, keep = canny_nms(dx, dy, low)
    return _hysteresis(keep & (f > high), keep).to(torch.uint8)


def close_outline(a: torch.Tensor) -> torch.Tensor:
    """ccv_close_outline twin (lib/ccv_classic.c:345).

    Fills the 4-connected gaps of diagonally adjacent edge pixels: where
    a[i, j] and a[i+1, j+1] are both set, the anti-diagonal pair is set to 1
    (and vice versa); other cells keep their value."""
    nz = a != 0
    dr = torch.zeros_like(nz)
    r1 = nz[..., :-1, :-1] & nz[..., 1:, 1:]   # sets (i+1, j) and (i, j+1)
    r2 = nz[..., 1:, :-1] & nz[..., :-1, 1:]   # sets (i, j) and (i+1, j+1)
    dr[..., 1:, :-1] |= r1
    dr[..., :-1, 1:] |= r1
    dr[..., :-1, :-1] |= r2
    dr[..., 1:, 1:] |= r2
    return torch.where(dr, torch.ones_like(a), a)


def otsu(a: torch.Tensor, range_: int = 256):
    """ccv_otsu twin: (threshold, between-class variance) as tensors.

    The closed form over cumulative histogram moments, in float32 as
    ccv_tpu; the first maximum wins ties, as the reference's strict `>`
    update. wB * wF is taken in int64 (ccv_tpu's int32 product wraps past
    2^31, above 92,681 pixels)."""
    flat = a.reshape(-1).to(torch.int64).clamp(0, range_ - 1)
    hist = torch.bincount(flat, minlength=range_).to(torch.int32)
    total = flat.numel()
    i = torch.arange(range_, dtype=torch.float32, device=a.device)
    moments = i * hist
    sum_all = moments.sum()
    wB = torch.cumsum(hist, 0, dtype=torch.int32)
    sumB = tiled_cumsum(moments, 0)
    wF = total - wB
    valid = (wB > 0) & (wF > 0)
    mB = sumB / wB.clamp(min=1)
    mF = (sum_all - sumB) / wF.clamp(min=1)
    d = mB - mF
    var = torch.where(valid, (wB.to(torch.int64) * wF).to(torch.float32)
                      * (d * d), 0.0)
    threshold = torch.argmax(var)
    return threshold, var[threshold] / total / total
