"""SIFT keypoints, descriptors and matching (counterpart of
ccv_tpu/detectors/sift.py; reference: lib/ccv_sift.c, VLFeat-derived).

Per octave, on the device (``_octave_body``):

1. the Gaussian chain, its DoG stack and the gradient planes
   (``_build_pyramids``; the -1 octave is the 2x ``sample_up`` of the
   image, the others the ``sample_down`` chain of its original dtype);
2. the 26-neighbour extrema of the DoG stack, every pixel at once;
3. the extrema compact (``torch.nonzero``: exact counts in scan order) and
   run the reference's 5-step quadratic refinement (``_refine_lanes``);
4. 36-bin orientation histograms on a fixed 16 x 16 grid of the keypoint's
   Gaussian disc (bilinear samples of the (gx, gy) planes), the peaks, and
   for each (keypoint, peak) a 4 x 4 x 8 descriptor on a 16 x 16 grid of
   its rotated support.

ccv_tpu's static caps (``_compact_mask``, ``_CAP_HINT`` and the overflow
reruns) exist to keep XLA's shapes static and are not needed here: every
tensor is sized from the counts read back from the device. Keypoints are
listed per image by octave, then in scan order of (level, y, x), then by
orientation bin, as in ccv_tpu.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np
import torch

from ccv_tpu_torch.core.dense_matrix import as_array
from ccv_tpu_torch.ops import basic, resample

SIGMA0 = 1.6
ORI_GRID = 16   # samples per axis over the +-3 sigma_w orientation disc
DESC_GRID = 16  # samples per axis over the 4 x 4-bin descriptor support


@dataclasses.dataclass
class SiftParams:
    """ccv_sift_default_params twin (ccv_sift.c:36)."""

    noctaves: int = 3
    nlevels: int = 6
    up2x: bool = True
    edge_threshold: float = 10.0
    norm_threshold: float = 0.0
    peak_threshold: float = 0.0


def _build_pyramids(g0: torch.Tensor, nlevels: int, up2x_octave: bool):
    """Gaussian chain -> (dog (L-1, H, W), th, md (L-3, H, W)) of one octave
    (ccv_sift.c:233-270; the -1 octave starts at sigma sqrt(2))."""
    sigmak = 2.0 ** (1.0 / (nlevels - 3))
    dsigma0 = SIGMA0 * sigmak * math.sqrt(1.0 - 1.0 / (sigmak * sigmak))
    g = basic.blur(g0.to(torch.float32), math.sqrt(
        SIGMA0 * SIGMA0 - (2.0 if up2x_octave else 0.25)))
    dogs, ths, mds = [], [], []
    for j in range(1, nlevels):
        gn = basic.blur(g, dsigma0 * sigmak ** (j - 1))
        dogs.append(gn - g)
        if 1 < j < nlevels - 1:
            t_, m_ = basic.gradient(g)
            ths.append(t_)
            mds.append(m_)
        g = gn
    return torch.stack(dogs), torch.stack(ths), torch.stack(mds)


def build_octave(g0: torch.Tensor, nlevels: int):
    """One octave from its source: (the first Gaussian level, dog (L-1, H,
    W), th (L-3, H, W), md (L-3, H, W)); the first level is
    blur(g0, sqrt(SIGMA0^2 - 0.25))."""
    g1 = basic.blur(g0.to(torch.float32),
                    math.sqrt(SIGMA0 * SIGMA0 - 0.25))
    return (g1,) + _build_pyramids(g0, nlevels, False)


def _dense_extrema(dog: torch.Tensor, peak_threshold: float) -> torch.Tensor:
    """26-neighbour extrema of the DoG stack (L1, H, W), all levels at once:
    a bool mask (L1-2, H, W) over levels 1..L1-2 (ccv_sift.c:271-285), off
    the one-pixel border."""
    L1, H, W = dog.shape
    v = dog[1:-1]
    lt = v <= -peak_threshold
    gt = v >= peak_threshold
    for ds in (-1, 0, 1):
        for di in (-1, 0, 1):
            for dj in (-1, 0, 1):
                if ds == 0 and di == 0 and dj == 0:
                    continue
                # the roll wraps on H and W; the border mask drops those
                nb = torch.roll(dog, (-di, -dj), (1, 2))[1 + ds:L1 - 1 + ds]
                lt = lt & (v < nb)
                gt = gt & (v > nb)
    border = torch.zeros(H, W, dtype=torch.bool, device=dog.device)
    border[1:H - 1, 1:W - 1] = True
    return (lt | gt) & border[None]


def _solve(N: torch.Tensor):
    """The quadratic fit of a (n, 3, 3, 3) neighbourhood (s, dy, dx) by the
    symmetric 3x3 adjugate, in ccv_tpu's arithmetic (no linalg solve, which
    rounds and treats singular systems otherwise): (bx, by, bs, score)."""
    def n(s, y, x):
        return N[:, s, y, x]

    c = n(1, 1, 1)
    Dxx = n(1, 1, 0) - 2 * c + n(1, 1, 2)
    Dyy = n(1, 0, 1) - 2 * c + n(1, 2, 1)
    Dxy = (n(1, 2, 2) - n(1, 2, 0) - n(1, 0, 2) + n(1, 0, 0)) * 0.25
    tr = Dxx + Dyy
    score = tr * tr / (Dxx * Dyy - Dxy * Dxy)
    Dx = (n(1, 1, 2) - n(1, 1, 0)) * 0.5
    Dy = (n(1, 2, 1) - n(1, 0, 1)) * 0.5
    Ds = (n(2, 1, 1) - n(0, 1, 1)) * 0.5
    Dxs = (n(2, 1, 2) + n(0, 1, 0) - n(2, 1, 0) - n(0, 1, 2)) * 0.25
    Dys = (n(2, 2, 1) + n(0, 0, 1) - n(2, 0, 1) - n(0, 2, 1)) * 0.25
    Dss = n(0, 1, 1) - 2 * c + n(2, 1, 1)
    a00 = Dyy * Dss - Dys * Dys
    a01 = Dys * Dxs - Dxy * Dss
    a02 = Dxy * Dys - Dyy * Dxs
    a11 = Dxx * Dss - Dxs * Dxs
    a12 = Dxy * Dxs - Dxx * Dys
    a22 = Dxx * Dyy - Dxy * Dxy
    det = Dxx * a00 + Dxy * a01 + Dxs * a02
    ok = det.abs() > 1e-20
    inv = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    bx = -(a00 * Dx + a01 * Dy + a02 * Ds) * inv
    by = -(a01 * Dx + a11 * Dy + a12 * Ds) * inv
    bs = -(a02 * Dx + a12 * Dy + a22 * Ds) * inv
    return bx, by, bs, score


def _refine_lanes(dog, lvl, ix, iy, alive, peak_threshold: float,
                  edge_threshold: float, nlevels: int):
    """The reference's iterative 3x3x3 quadratic refinement over keypoint
    lanes (ccv_sift.c:286-316): 5 steps, each moving a lane by at most one
    pixel and stopping it where it settles or leaves the image.

    dog (L1, H, W); lvl, ix, iy int32 and alive bool, (n,) each, lvl in
    1..L1-2. Returns (valid, kx, ky, ks)."""
    L1, H, W = dog.shape
    dflat = dog.reshape(-1)
    offs = [(ds, di, dj) for ds in (-1, 0, 1) for di in (-1, 0, 1)
            for dj in (-1, 0, 1)]

    def n27(yy, xx):
        cols = [dflat[((lvl + ds) * H + (yy + di).clamp(0, H - 1)) * W
                      + (xx + dj).clamp(0, W - 1)] for ds, di, dj in offs]
        return torch.stack(cols, -1).reshape(-1, 3, 3, 3)

    lanes = alive
    kx, ky = ix.to(torch.float32), iy.to(torch.float32)
    ks = lvl.to(torch.float32)
    score = torch.full_like(kx, -1.0)
    for _ in range(5):
        bx, by, bs, sc = _solve(n27(iy, ix))
        nkx = ix + bx.clamp(-1, 1)
        nky = iy + by.clamp(-1, 1)
        nks = lvl + bs
        inb = (nkx >= 1) & (nkx <= W - 2) & (nky >= 1) & (nky <= H - 2)
        nx = (nkx + 0.5).to(torch.int32)
        ny = (nky + 0.5).to(torch.int32)
        converged = (nx == ix) & (ny == iy)
        kx = torch.where(alive, nkx, kx)
        ky = torch.where(alive, nky, ky)
        ks = torch.where(alive, nks, ks)
        score = torch.where(alive, sc, score)
        dead = alive & ~inb
        alive = alive & inb & ~converged
        ix = torch.where(alive, nx, ix)
        iy = torch.where(alive, ny, iy)
        # a lane that left the image is out for good
        score = torch.where(dead, -1.0, score)
        kx = torch.where(dead, -10.0, kx)
    final = dflat[(lvl * H + iy.clamp(0, H - 1)) * W + ix.clamp(0, W - 1)]
    et = (edge_threshold + 1.0) ** 2 / edge_threshold
    valid = (lanes & (kx > -5) & (final.abs() > peak_threshold)
             & (score >= 0) & (score < et) & (ks > 0) & (ks < nlevels - 1))
    return valid, kx, ky, ks


def _grid(G: int, half: float, device) -> tuple:
    """(u, v) of a G x G sample lattice over [-half, half]^2, x fastest."""
    us = (torch.arange(G, dtype=torch.float32, device=device) + 0.5) * (
        2 * half / G) - half
    vv, uu = torch.meshgrid(us, us, indexing="ij")
    return uu.reshape(-1), vv.reshape(-1)


def _bilinear(gxy_flat, H, W, levels, px, py):
    """Bilinear (gx, gy) samples (n, P, 2) of the stacked planes at (px, py)
    (n, P) of each lane's plane ``levels``; and whether each is inside."""
    x0 = torch.floor(px).to(torch.int64)
    y0 = torch.floor(py).to(torch.int64)
    wx = (px - x0)[..., None]
    wy = (py - y0)[..., None]
    inside = (px >= 0) & (px <= W - 1) & (py >= 0) & (py <= H - 1)
    base = levels.to(torch.int64)[:, None] * (H * W)

    def corner(yc, xc):
        return gxy_flat[base + yc.clamp(0, H - 1) * W + xc.clamp(0, W - 1)]

    g = ((corner(y0, x0) * (1 - wx) + corner(y0, x0 + 1) * wx) * (1 - wy)
         + (corner(y0 + 1, x0) * (1 - wx) + corner(y0 + 1, x0 + 1) * wx) * wy)
    return g, inside


def _ori_grid_core(gxy_flat, H, W, kxs, kys, scales, valid, levels):
    """36-bin orientation histograms (n, 36) on a fixed ORI_GRID^2 lattice
    of [-3, 3]^2 sigma_w units around each keypoint (sigma_w = 1.5 scale;
    ccv_sift.c:340-366 weighs every pixel of that disc: the lattice scales
    each bin by the same sample area, which peak selection ignores)."""
    u, v = _grid(ORI_GRID, 3.0, kxs.device)
    r2 = u * u + v * v
    w_gauss = torch.where(r2 <= 9.0 + 1e-3, torch.exp(-r2 / 2.0), 0.0)
    sw = 1.5 * scales
    g, inside = _bilinear(gxy_flat, H, W, levels,
                          kxs[:, None] + sw[:, None] * u,
                          kys[:, None] + sw[:, None] * v)
    gx, gy = g[..., 0], g[..., 1]
    m = torch.sqrt(gx * gx + gy * gy)
    theta = torch.atan2(gy, gx)
    mw = torch.where(inside, m, 0.0) * w_gauss[None, :] * valid[:, None]
    # tent into 36 bins: fbin is the reference's degrees * 0.1 - 0.5
    deg = torch.remainder(theta * (180.0 / math.pi), 360.0)
    fbin = deg * 0.1 - 0.5
    d = (fbin[..., None] - torch.arange(36.0, device=kxs.device)).abs()
    tri = torch.clamp(1.0 - torch.minimum(d, 36.0 - d), min=0.0)
    bins = torch.einsum("np,npb->nb", mw, tri)
    for _ in range(6):
        bins = (torch.roll(bins, 1, 1) + bins + torch.roll(bins, -1, 1)) / 3.0
    return bins


def _desc_grid_core(gxy_flat, H, W, kxs, kys, scales, levels, angles, valid):
    """4 x 4 x 8 descriptors (n, 128) on a fixed DESC_GRID^2 lattice of the
    rotated, scale-normalised support [-2.5, 2.5]^2 bins (ccv_sift.c:391-470
    integrates every pixel of a scale-proportional window; the lattice's
    constant sample area cancels in the L2 normalisation)."""
    dev = kxs.device
    u, v = _grid(DESC_GRID, 2.5, dev)
    P = u.numel()
    w_gauss = torch.exp(-(u * u + v * v) / 8.0)  # sigma = 2 bins
    centers = torch.tensor([-1.5, -0.5, 0.5, 1.5], device=dev)
    tx = torch.clamp(1.0 - (u[:, None] - centers).abs(), min=0.0)
    ty = torch.clamp(1.0 - (v[:, None] - centers).abs(), min=0.0)
    AT = ((w_gauss[:, None] * ty)[:, :, None] * tx[:, None, :]).reshape(P, 16)
    sbp = 3.0 * scales
    ca, sa = torch.cos(angles), torch.sin(angles)
    g, inside = _bilinear(
        gxy_flat, H, W, levels,
        kxs[:, None] + sbp[:, None] * (ca[:, None] * u - sa[:, None] * v),
        kys[:, None] + sbp[:, None] * (sa[:, None] * u + ca[:, None] * v))
    gx, gy = g[..., 0], g[..., 1]
    m = torch.sqrt(gx * gx + gy * gy)
    theta = torch.atan2(gy, gx)
    m = torch.where(inside, m, 0.0) * valid[:, None]
    nt = 8.0 * torch.remainder(theta - angles[:, None], 2.0 * math.pi) / (
        2.0 * math.pi)
    dtt = (nt[..., None] - torch.arange(8.0, device=dev)).abs()
    B = torch.clamp(1.0 - torch.minimum(dtt, 8.0 - dtt), min=0.0)
    desc = torch.einsum("pi,npj->nij", AT, B * m[..., None]).reshape(-1, 128)
    norm = torch.sqrt(torch.sum(desc * desc, dim=1, keepdim=True))
    desc = torch.minimum(desc / norm.clamp(min=1e-12),
                         torch.tensor(0.2, device=dev))
    norm2 = torch.sqrt(torch.sum(desc * desc, dim=1, keepdim=True))
    return desc / norm2.clamp(min=1e-12)


def _octave_body(g0: torch.Tensor, peak_threshold: float,
                 edge_threshold: float, nlevels: int, want_desc: bool,
                 up2x_octave: bool) -> dict:
    """One octave: pyramid -> extrema -> refine -> orientation peaks ->
    descriptors. Returns the (keypoint, angle) entries, in order:
    ``rows`` (n, 5) float32 [x, y, scale, level, angle] in the octave's
    pixels, ``count`` extrema and, with want_desc, ``desc`` (n, 128)."""
    sigmak = 2.0 ** (1.0 / (nlevels - 3))
    dog, th, md = _build_pyramids(g0, nlevels, up2x_octave)
    L, H, W = dog.shape
    dev = dog.device
    idx = torch.nonzero(_dense_extrema(dog, peak_threshold).reshape(-1)
                        ).squeeze(1)
    lvl = (idx // (H * W)).to(torch.int32) + 1
    rem = (idx % (H * W)).to(torch.int32)
    lanes = torch.ones_like(lvl, dtype=torch.bool)
    valid, kxs, kys, kss = _refine_lanes(dog, lvl, rem % W, rem // W, lanes,
                                         peak_threshold, edge_threshold,
                                         nlevels)
    keep = torch.nonzero(valid).squeeze(1)
    kxs, kys, kss, levels = kxs[keep], kys[keep], kss[keep], lvl[keep]
    sigma = (SIGMA0 * sigmak) * torch.pow(2.0, kss / (nlevels - 3))
    ones = torch.ones_like(kxs)
    # (gx, gy) planes for the interpolated samples (th is in degrees)
    rad = th * (math.pi / 180.0)
    gxy_flat = torch.stack([md * torch.cos(rad), md * torch.sin(rad)],
                           dim=-1).reshape(-1, 2)
    bins = _ori_grid_core(gxy_flat, H, W, kxs, kys, sigma, ones, levels - 1)
    # orientation peaks (ccv_sift.c:370-385): the argmax always, other
    # strict local maxima above 0.8 of it too
    bp = torch.roll(bins, -1, 1)
    bm = torch.roll(bins, 1, 1)
    mx = bins.amax(1) if bins.numel() else bins.new_zeros(0)
    peak = (bins > 0.8 * mx[:, None]) & (bins > bp) & (bins > bm)
    if bins.numel():
        peak[torch.arange(bins.shape[0], device=dev), torch.argmax(bins, 1)] \
            = True
    den = bp + bm - 2.0 * bins
    di = torch.where(den != 0, -0.5 * (bp - bm) / den, 0.0)
    ang = (2.0 * math.pi / 36.0) * (
        torch.arange(36.0, device=dev)[None, :] + di + 0.5)
    eidx = torch.nonzero(peak.reshape(-1)).squeeze(1)
    ekp = eidx // 36
    eang = ang.reshape(-1)[eidx]
    out = dict(count=int(idx.numel()), rows=torch.stack([
        kxs[ekp], kys[ekp], sigma[ekp], levels[ekp].to(torch.float32),
        eang], dim=1))
    if want_desc:
        out["desc"] = _desc_grid_core(
            gxy_flat, H, W, kxs[ekp], kys[ekp], sigma[ekp], levels[ekp] - 1,
            eang, torch.ones_like(eang))
    return out


def _octaves(img: torch.Tensor, params: SiftParams):
    """(octave, source) of every octave of an (H, W) image: -1 is the 2x
    up-sample, i >= 0 the i-fold sample_down chain (in the image's dtype:
    integer images take the reference's exact integer steps)."""
    octs = ([-1] if params.up2x else []) + list(range(params.noctaves))
    chain = [img]
    for oct_i in octs:
        if oct_i == -1:
            yield oct_i, resample.sample_up(img)
            continue
        while len(chain) <= oct_i:
            chain.append(resample.sample_down(chain[-1]))
        yield oct_i, chain[oct_i]


def _image_entries(a, params: SiftParams, want_desc: bool, device):
    """Every octave's entries of one image, on the device: (rows (n, 5) in
    image pixels, octave per row (n,), desc (n, 128) or None)."""
    img = as_array(a, device)
    if img.dim() == 3:
        img = img[..., 0]
    rows, octs, descs = [], [], []
    for oct_i, g0 in _octaves(img, params):
        r = _octave_body(g0, params.peak_threshold, params.edge_threshold,
                         params.nlevels, want_desc, oct_i == -1)
        rows.append(r["rows"])
        octs.append(torch.full((r["rows"].shape[0],), oct_i,
                               dtype=torch.int32, device=img.device))
        if want_desc:
            descs.append(r["desc"])
    return (torch.cat(rows), torch.cat(octs),
            torch.cat(descs) if want_desc else None)


def _keypoints(rows: np.ndarray, octs: np.ndarray) -> List[dict]:
    """Host: keypoint dicts {x, y, octave, level, scale, angle} in input
    coordinates, with ccv_tpu's float32 arithmetic."""
    kps = []
    for (kx, ky, sig, lvl, ang), o in zip(rows, octs.tolist()):
        s = 2.0 ** o
        kps.append(dict(x=float(kx * s), y=float(ky * s), octave=o,
                        level=int(lvl), scale=float(sig), angle=float(ang)))
    return kps


def sift_many(imgs, params: Optional[SiftParams] = None,
              want_desc: bool = True, device=None):
    """SIFT over a list of (H, W[, C]) images (channel 0 is read), on
    ``device`` (default: where a tensor is, else the card). Returns
    [(keypoints, descriptors (n, 128) float32 numpy or None), ...]."""
    params = params or SiftParams()
    out = []
    for a in imgs:
        rows, octs, desc = _image_entries(a, params, want_desc, device)
        kps = _keypoints(rows.cpu().numpy(), octs.cpu().numpy())
        d = (desc.cpu().numpy().astype(np.float32)
             if want_desc and len(kps) else None)
        out.append((kps, d))
    return out


def sift(a, params: Optional[SiftParams] = None, want_desc: bool = True,
         device=None):
    """ccv_sift twin (ccv_sift.c:172): (keypoints, descriptors).

    keypoints: dicts {x, y, octave, level, scale, angle} in input
    coordinates; descriptors: (N, 128) float32 numpy, or None."""
    return sift_many([a], params, want_desc, device)[0]


def _nearest_two(d1: torch.Tensor, d2: torch.Tensor):
    """(index of the nearest row of d2, its squared distance, the second
    nearest's) for every row of d1; ties go to the lower index (a stable
    sort, as ccv_tpu's argsort and top_k). With one row in d2 the second
    distance is inf."""
    dots = d1 @ d2.T
    n1 = torch.sum(d1 * d1, dim=1, keepdim=True)
    n2 = torch.sum(d2 * d2, dim=1)
    dist = n1 + n2[None, :] - 2.0 * dots
    if dist.shape[1] < 2:
        dist = torch.cat([dist, torch.full_like(dist[:, :1], math.inf)], 1)
    val, order = torch.sort(dist, dim=1, stable=True)
    return order[:, 0], val[:, 0], val[:, 1]


def _match_core(D1: torch.Tensor, D2: torch.Tensor, ratio: float):
    """Ratio-test nearest-neighbour matching on the device: (index into D2,
    ok) per row of D1, ok where the best squared distance is below
    ``ratio`` times the second best."""
    idx, best, second = _nearest_two(D1, D2)
    return idx, best < ratio * second


def match(desc1, desc2, ratio: float = 0.36, device=None):
    """bin/siftmatch twin: nearest-neighbour matching with the reference's
    squared-distance ratio test (0.36 on dist1 / dist2). Returns numpy
    (index into desc2, ok) per row of desc1."""
    d1 = as_array(desc1, device)
    d2 = as_array(desc2, device if device is not None else d1.device)
    idx, ok = _match_core(d1.to(torch.float32), d2.to(torch.float32), ratio)
    return idx.cpu().numpy(), ok.cpu().numpy()


def match_pair(a, b, params: Optional[SiftParams] = None,
               ratio: float = 0.36, device=None):
    """bin/siftmatch twin: SIFT both images and match them on the device,
    with one copy of the results to the host. Returns (kps1, kps2, pairs),
    pairs the (i1, i2) keypoint indices passing the ratio test."""
    params = params or SiftParams()
    ra, oa, da = _image_entries(a, params, True, device)
    rb, ob, db = _image_entries(b, params, True, device if device is not None
                                else ra.device)
    if da.shape[0] and db.shape[0]:
        idx, ok = _match_core(da, db, ratio)
    else:
        idx = ok = torch.zeros(0, dtype=torch.int64, device=ra.device)
    host = [t.cpu().numpy() for t in (ra, oa, rb, ob, idx, ok)]
    kps1, kps2 = _keypoints(*host[0:2]), _keypoints(*host[2:4])
    pairs = [(i, int(j)) for i, (j, m) in enumerate(zip(host[4], host[5]))
             if m]
    return kps1, kps2, pairs
