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

``hog`` is the Felzenszwalb 31-channel HOG: the reference's 4-way bilinear
scatter of each pixel's vote becomes a depthwise strided correlation with a
triangular kernel (``F.conv2d(groups=C)``). ``optical_flow_lucas_kanade``
runs every point at once: ccv_tpu's vmap over points becomes tensors over N
points, and its fixed-trip loop of Newton steps a Python loop of masked
updates.
"""

from __future__ import annotations

import math

import numpy as np
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


# ---------------------------------------------------------------------------
# HOG (Felzenszwalb / UoCTTI 31-channel variant)
# ---------------------------------------------------------------------------

def _tri_downsample(x: torch.Tensor, size: int) -> torch.Tensor:
    """Bilinear (triangular-kernel) spatial binning: pixel i adds to cell c
    with weight max(0, 1 - |(i + 0.5) / size - 0.5 - c|), the reference's 4
    scatter-adds per pixel (ccv_classic.c:66-95) as a depthwise strided
    correlation per axis.

    x: (H, W, C) with H, W multiples of ``size``; returns (H // size,
    W // size, C) float32."""
    pad_lo = size // 2
    L = 2 * size
    t = torch.arange(L, dtype=torch.float32, device=x.device)
    k = torch.clamp(1.0 - torch.abs((t - pad_lo + 0.5) / size - 0.5), min=0.0)
    C = x.shape[-1]
    v = x.to(torch.float32).permute(2, 0, 1)[None]   # (1, C, H, W)
    v = F.pad(v, (0, 0, pad_lo, size - pad_lo))
    v = F.conv2d(v, k.view(1, 1, L, 1).expand(C, 1, L, 1), stride=(size, 1),
                 groups=C)
    v = F.pad(v, (pad_lo, size - pad_lo, 0, 0))
    v = F.conv2d(v, k.view(1, 1, 1, L).expand(C, 1, 1, L), stride=(1, size),
                 groups=C)
    return v[0].permute(1, 2, 0)


def hog(a: torch.Tensor, sbin: int = 9, size: int = 8) -> torch.Tensor:
    """ccv_hog twin (lib/ccv_classic.c:4): Felzenszwalb 31-channel HOG.

    Returns (H // size, W // size, 4 + 3 * sbin) float32 in the reference's
    channel order: 4 texture energies, sbin contrast-insensitive and
    2 * sbin contrast-sensitive orientations. Per pixel the strongest
    channel's gradient votes (the first maximum); its angle, clipped to
    359.99, is split between two bins; the four normalisers are edge-clamped
    2 x 2 sums of the cells' energies."""
    if a.dim() == 2:
        a = a[..., None]
    rows, cols = a.shape[0] // size, a.shape[1] // size
    theta, mag = basic.gradient(a, 1, 1)   # (H, W, ch) degrees, magnitude
    theta = theta[:rows * size, :cols * size]
    mag = mag[:rows * size, :cols * size]
    best = torch.argmax(mag, dim=-1, keepdim=True)
    agv = torch.gather(theta, -1, best)[..., 0]
    mgv = torch.gather(mag, -1, best)[..., 0] / 255.0
    nb = 2 * sbin
    agr = (torch.clamp(agv, 0.0, 359.99) / 360.0) * nb
    ag0 = torch.floor(agr).to(torch.int64)
    ag1 = torch.where(ag0 + 1 < nb, ag0 + 1, 0)
    fr = agr - ag0
    w0, w1 = ((1.0 - fr) * mgv)[..., None], (fr * mgv)[..., None]
    wmap = (F.one_hot(ag0, nb).to(torch.float32) * w0
            + F.one_hot(ag1, nb).to(torch.float32) * w1)
    cn = _tri_downsample(wmap, size)   # (rows, cols, 2 * sbin)
    ci = cn[..., :sbin] + cn[..., sbin:]
    ca = torch.sum(ci * ci, dim=-1)
    cap = F.pad(ca[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    R, Cc = ca.shape

    def s(di, dj):
        return cap[1 + di:1 + di + R, 1 + dj:1 + dj + Cc]

    n_dr = ca + s(0, 1) + s(1, 0) + s(1, 1)
    n_ur = ca + s(0, 1) + s(-1, 0) + s(-1, 1)
    n_dl = ca + s(0, -1) + s(1, 0) + s(1, -1)
    n_ul = ca + s(0, -1) + s(-1, 0) + s(-1, -1)
    norm = torch.rsqrt(torch.stack([n_dr, n_ur, n_dl, n_ul], dim=-1) + 1e-4)
    # (rows, cols, 4, 2 * sbin) truncated normalised contributions
    v = 0.5 * torch.clamp(cn[..., None, :] * norm[..., None], max=0.2)
    sensitive = torch.sum(v, dim=2)
    texture = 0.2357 * torch.sum(v, dim=3)
    vi = 0.5 * torch.clamp(ci[..., None, :] * norm[..., None], max=0.2)
    insensitive = torch.sum(vi, dim=2)
    return torch.cat([texture, insensitive, sensitive], dim=-1)


# ---------------------------------------------------------------------------
# pyramidal Lucas-Kanade optical flow
# ---------------------------------------------------------------------------

_LK_MAX_ITER = 30
_LK_EPSILON = 0.01
_W_BITS14 = 14  # the reference's fixed-point scales, emulated in float so
_W_BITS7 = 7    # that thresholds (min_eigen, _LK_EPSILON) keep their meaning
_W_BITS9 = 9
_FLT_SCALE = 1.0 / (1 << 25)


def _lk_window(img: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor,
               w00, w01, w10, w11, wh: int, ww: int,
               scale: float) -> torch.Tensor:
    """(N, wh, ww) bilinear windows at the integer corners (iy, ix) of N
    points, scaled."""
    ry = iy[:, None] + torch.arange(wh + 1, device=img.device)
    rx = ix[:, None] + torch.arange(ww + 1, device=img.device)
    win = img[ry[:, :, None], rx[:, None, :]]   # (N, wh + 1, ww + 1)
    w = [t[:, None, None] for t in (w00, w01, w10, w11)]
    out = (w[0] * win[:, :-1, :-1] + w[1] * win[:, :-1, 1:]
           + w[2] * win[:, 1:, :-1] + w[3] * win[:, 1:, 1:])
    return out * scale


def _bilinear_weights(px: torch.Tensor, py: torch.Tensor):
    ipx = torch.floor(px).to(torch.int64)
    ipy = torch.floor(py).to(torch.int64)
    xd = px - ipx
    yd = py - ipy
    return (ipx, ipy, (1 - xd) * (1 - yd), xd * (1 - yd), (1 - xd) * yd,
            xd * yd)


def _lk_level(a: torch.Tensor, adx: torch.Tensor, ady: torch.Tensor,
              b: torch.Tensor, prev_pts: torch.Tensor, next_pts: torch.Tensor,
              wh: int, ww: int, min_eigen: float):
    """One pyramid level of LK for every point at once: (next points (N, 2),
    tracked (N,)). The reference's per-point loop (ccv_classic.c:482-608)
    with per-point active masks over a fixed count of Newton steps.

    As ccv_tpu, the bilinear y-gradient window is weighted by ``* iw10``
    where the reference has the typo ``+ iw10`` (ccv_classic.c:536)."""
    H, W = a.shape
    half_x, half_y = (ww - 1) * 0.5, (wh - 1) * 0.5
    af, bf = a.to(torch.float32), b.to(torch.float32)
    adxf, adyf = adx.to(torch.float32), ady.to(torch.float32)
    s7 = float(1 << _W_BITS7)
    s5 = float(1 << (_W_BITS14 - _W_BITS9))

    def inside(ix, iy):
        return (ix >= 0) & (ix < W - ww - 1) & (iy >= 0) & (iy < H - wh - 1)

    ipx, ipy, w00, w01, w10, w11 = _bilinear_weights(
        prev_pts[:, 0] - half_x, prev_pts[:, 1] - half_y)
    in_bounds = inside(ipx, ipy)
    ipyc = ipy.clamp(0, H - wh - 1)
    ipxc = ipx.clamp(0, W - ww - 1)
    wi = _lk_window(af, ipyc, ipxc, w00, w01, w10, w11, wh, ww, s7)
    widx = _lk_window(adxf, ipyc, ipxc, w00, w01, w10, w11, wh, ww, s5)
    widy = _lk_window(adyf, ipyc, ipxc, w00, w01, w10, w11, wh, ww, s5)
    a11 = torch.sum(widx * widx, dim=(1, 2)) * _FLT_SCALE
    a12 = torch.sum(widx * widy, dim=(1, 2)) * _FLT_SCALE
    a22 = torch.sum(widy * widy, dim=(1, 2)) * _FLT_SCALE
    D = a11 * a22 - a12 * a12
    eigen = (a22 + a11 - torch.sqrt((a11 - a22) ** 2 + 4.0 * a12 * a12)) \
        / (2.0 * ww * wh)
    good = in_bounds & (eigen >= min_eigen) & (D >= 1.1920929e-07)
    Dinv = torch.where(good, 1.0 / torch.clamp(D, min=1e-30),
                       torch.zeros_like(D))

    nx = next_pts[:, 0] - half_x
    ny = next_pts[:, 1] - half_y
    pdx = torch.zeros_like(nx)
    pdy = torch.zeros_like(ny)
    active = good
    for j in range(_LK_MAX_ITER):
        inx, iny, b00, b01, b10, b11 = _bilinear_weights(nx, ny)
        active = active & inside(inx, iny)
        bwin = _lk_window(bf, iny.clamp(0, H - wh - 1),
                          inx.clamp(0, W - ww - 1), b00, b01, b10, b11,
                          wh, ww, s7)
        diff = bwin - wi
        b1 = torch.sum(diff * widx, dim=(1, 2)) * _FLT_SCALE
        b2 = torch.sum(diff * widy, dim=(1, 2)) * _FLT_SCALE
        dx = (a12 * b2 - a22 * b1) * Dinv
        dy = (a12 * b1 - a11 * b2) * Dinv
        nx = torch.where(active, nx + dx, nx)
        ny = torch.where(active, ny + dy, ny)
        converged = dx * dx + dy * dy < _LK_EPSILON
        osc = ((torch.abs(pdx - dx) < 0.01) & (torch.abs(pdy - dy) < 0.01)
               if j > 0 else torch.zeros_like(converged))
        # oscillation: settle halfway between the last two iterates
        settle = active & osc & ~converged
        nx = torch.where(settle, nx - dx * 0.5, nx)
        ny = torch.where(settle, ny - dy * 0.5, ny)
        active = active & ~converged & ~osc
        pdx, pdy = dx, dy
    inx = torch.floor(nx).to(torch.int64)
    iny = torch.floor(ny).to(torch.int64)
    ok = good & inside(inx, iny)
    out = torch.stack([torch.where(ok, nx + half_x, next_pts[:, 0]),
                       torch.where(ok, ny + half_y, next_pts[:, 1])], dim=1)
    return out, ok


def optical_flow_lucas_kanade(a: torch.Tensor, b: torch.Tensor, points,
                              win_size=(15, 15), level: int = 3,
                              min_eigen: float = 0.025):
    """ccv_optical_flow_lucas_kanade twin (lib/ccv_classic.c:437).

    a, b: uint8 single-channel frames on one device; points: (N, 2) (x, y).
    Returns (points in b (N, 2) float32, status (N,) bool), tensors on the
    frames' device."""
    from ccv_tpu_torch.ops import resample

    if a.dim() == 3:
        a = a[..., 0]
    if b.dim() == 3:
        b = b[..., 0]
    H, W = a.shape
    ww, wh = int(win_size[0]), int(win_size[1])
    max_level = int(math.log(min(H, W) / max(ww * 2, wh * 2)) / math.log(2.0)
                    + 0.5)
    level = int(np.clip(level + 1, 1, max(1, max_level)))
    pts = torch.as_tensor(points, dtype=torch.float32,
                          device=a.device).reshape(-1, 2)
    pyr_a, pyr_b = [a], [b]
    for _ in range(1, level):
        pyr_a.append(resample.sample_down(pyr_a[-1]))
        pyr_b.append(resample.sample_down(pyr_b[-1]))
    nxt = None
    status = None
    prev_shape = None
    for t in range(level - 1, -1, -1):
        at, bt = pyr_a[t], pyr_b[t]
        adx = basic.sobel(at, 3, 0).to(torch.int32)
        ady = basic.sobel(at, 0, 3).to(torch.int32)
        prev = pts / float(1 << t)
        if nxt is None:
            nxt = prev
        else:
            off = torch.tensor([(at.shape[1] - prev_shape[1] * 2) * 0.5,
                                (at.shape[0] - prev_shape[0] * 2) * 0.5],
                               dtype=torch.float32, device=a.device)
            nxt = nxt * 2.0 + off
        nxt, status = _lk_level(at, adx, ady, bt, prev, nxt, wh, ww,
                                float(min_eigen))
        prev_shape = at.shape
    return nxt, status
