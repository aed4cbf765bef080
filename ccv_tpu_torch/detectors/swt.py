"""SWT text detector (counterpart of ccv_tpu/detectors/swt.py; reference:
lib/ccv_swt.c).

The main path of ``detect_words``, per pyramid level:

1. on the device, the front end: 3x3 sobels, ``canny`` and
   ``close_outline`` (``_frontend``);
2. on the device, the stroke widths of both polarities (``_rays``): from
   every edge pixel, six rays (two polarities x the gradient direction and
   its two 45-degree turns, ccv_swt.c:86) step along the gradient with the
   closed form of the reference's Bresenham recurrence (major axis every
   step, minor axis on a ceil staircase), in blocks of RAY_BLOCK steps over
   the rays still marching; a ray ends at the first step where a 5-point
   cross meets an edge (ccv_swt.c:71-74) or it leaves the image. A hit whose
   gradient opposes the origin's paints its width along its path (the
   smallest wins), then each ray's median along its path is written back
   where it is the widest ray (ccv_tpu's max-width-wins rewrite);
3. the stroke cells of both maps and the gray values under them compact
   into one int64 tensor, and that one tensor is copied to the host;
4. on the host, per polarity: width-ratio-gated 8-connected components
   (native C++, csrc/swt_cc.cpp), the letter filters, textline pairing,
   grouping and the Otsu word breakdown.

This is ccv_tpu's "compact" letter route without its lane, ray-length and
slot buckets: the port sizes every tensor from the real edge, ray and
path-cell counts, which it reads from the device. ccv_tpu's on-device
connected components ("device" route) are not ported.
"""

from __future__ import annotations

import dataclasses
import math
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ccv_tpu_torch.core import native
from ccv_tpu_torch.core.dense_matrix import as_array
from ccv_tpu_torch.detectors.common import Comp, group
from ccv_tpu_torch.ops import basic, classic, resample


@dataclasses.dataclass
class SwtParams:
    """ccv_swt_default_params twin (ccv_swt.c:4)."""

    interval: int = 1
    same_word_thresh: Tuple[float, float] = (0.1, 0.8)
    min_neighbors: int = 1
    scale_invariant: bool = False
    size: int = 3
    low_thresh: int = 124
    high_thresh: int = 204
    max_height: int = 300
    min_height: int = 8
    min_area: int = 38
    letter_occlude_thresh: int = 3
    aspect_ratio: float = 8.0
    std_ratio: float = 0.83
    thickness_ratio: float = 1.5
    height_ratio: float = 1.7
    intensity_thresh: int = 31
    distance_ratio: float = 2.9
    intersect_ratio: float = 1.3
    letter_thresh: int = 3
    elongate_ratio: float = 1.9
    breakdown: bool = True
    breakdown_ratio: float = 1.0


MAX_RAY = 70    # steps a ray takes at most
RAY_BLOCK = 16  # steps per block of the march between reads of the device
# 5-point cross probed at a hit and the 3x3 gradient check around it
# (ccv_swt.c:71-74), (dx, dy) in the reference's order
_CROSS = ((-1, 0), (0, 0), (1, 0), (0, -1), (0, 1))
_BOX9 = ((-1, 0), (0, 0), (1, 0), (-1, -1), (0, -1), (1, -1), (-1, 1),
         (0, 1), (1, 1))
# the six ray families: polarity {+1, -1} x rotation (xx, xy, yx, yy) of
# the gradient (ccv_swt.c:86)
_DIRS = (1, 1, 1, -1, -1, -1)
_ROT = ((1, 0, 0, 1), (1, -1, 1, 1), (1, 1, -1, 1)) * 2


def _frontend(img: torch.Tensor, size: int, low: int, high: int):
    """sobel, canny and close_outline of an (H, W) image: (closed edges
    uint8, dx int32, dy int32, gray uint8)."""
    dx = basic.sobel(img, size, 0).to(torch.int32)
    dy = basic.sobel(img, 0, size).to(torch.int32)
    c = classic.close_outline(classic.canny(img, size, low, high))
    return c.to(torch.uint8), dx, dy, img.clamp(0, 255).to(torch.uint8)


def _positions(ox, oy, maj, mnr, sx, sy, xmaj, t):
    """Ray positions after ``t`` steps (broadcast): the reference's error
    recurrence (ccv_swt.c:75-84) in closed form."""
    smaj = torch.where(maj > 0, t, 0)
    smin = torch.clamp((2 * t * mnr + maj - 1) // (2 * maj.clamp(min=1)),
                       min=0)
    xs = ox + sx * torch.where(xmaj, smaj, smin)
    ys = oy + sy * torch.where(xmaj, smin, smaj)
    return xs, ys


def _rays(c: torch.Tensor, dx: torch.Tensor, dy: torch.Tensor
          ) -> torch.Tensor:
    """(2, H, W) uint8 stroke-width maps, DARK_TO_BRIGHT first, of closed
    edges ``c`` with int32 sobels ``dx`` and ``dy`` (ccv_tpu's
    _swt_rays_both, whole: no lane, ray-length or slot cap)."""
    H, W = c.shape
    dev = c.device
    cb = c != 0
    cbp = F.pad(cb, (1, 1, 1, 1))
    # cross-dilated edges: dil[y, x] = any edge of the 5-point cross
    dil = (cb | cbp[1:-1, 2:] | cbp[1:-1, :-2] | cbp[2:, 1:-1]
           | cbp[:-2, 1:-1]).reshape(-1)
    cpf = cbp.reshape(-1)
    out = torch.zeros(2, H * W, dtype=torch.uint8, device=dev)
    ridx = torch.nonzero(cb.reshape(-1)).squeeze(1)
    N = ridx.numel()
    if N == 0:
        return out.reshape(2, H, W)
    ox, oy = ridx % W, ridx // W
    gdx = dx.reshape(-1)[ridx].to(torch.int64)
    gdy = dy.reshape(-1)[ridx].to(torch.int64)
    rot = torch.tensor(_ROT, dtype=torch.int64, device=dev)       # (6, 4)
    dirs = torch.tensor(_DIRS, dtype=torch.int64, device=dev)[:, None]
    rdx = gdx[None] * rot[:, 0:1] + gdy[None] * rot[:, 1:2]      # (6, N)
    rdy = gdx[None] * rot[:, 2:3] + gdy[None] * rot[:, 3:4]
    adx, ady = rdx.abs(), rdy.abs()
    ray = dict(
        ox=ox.repeat(6), oy=oy.repeat(6),
        maj=torch.maximum(adx, ady).reshape(-1),
        mnr=torch.minimum(adx, ady).reshape(-1),
        sx=(torch.where(rdx > 0, -1, 1) * dirs).reshape(-1),
        sy=(torch.where(rdy > 0, -1, 1) * dirs).reshape(-1),
        xmaj=(adx >= ady).reshape(-1))
    R = 6 * N

    def at(idx, t):
        return _positions(*(ray[k][idx] for k in ("ox", "oy", "maj", "mnr",
                                                  "sx", "sy", "xmaj")), t)

    # -- the march: steps 1..MAX_RAY in blocks over the rays still going;
    # a zero gradient never moves, so never hits
    stop_t = torch.full((R,), -1, dtype=torch.int64, device=dev)
    hit = torch.zeros(R, dtype=torch.bool, device=dev)
    act = torch.nonzero(ray["maj"] > 0).squeeze(1)
    for t0 in range(0, MAX_RAY, RAY_BLOCK):
        if act.numel() == 0:
            break
        t = torch.arange(t0 + 1, min(t0 + RAY_BLOCK, MAX_RAY) + 1,
                         device=dev)[:, None]
        xs, ys = at(act, t)                                  # (tb, n)
        inb = (xs >= 1) & (xs < W - 1) & (ys >= 1) & (ys < H - 1)
        far = (((ys - ray["oy"][act]).abs() >= 2)
               | ((xs - ray["ox"][act]).abs() >= 2))
        found = dil[(ys.clamp(0, H - 1) * W + xs.clamp(0, W - 1))]
        cand = inb & far & found
        stop = ~inb | cand
        stopped = stop.any(0)
        first = torch.argmax(stop.to(torch.uint8), 0)
        done = act[stopped]
        stop_t[done] = t0 + first[stopped]
        hit[done] = cand.gather(0, first[None])[0][stopped]
        act = act[~stopped]

    # -- hits: refine to the first cross point on an edge, then the
    # gradient-opposition test (ccv_swt.c:137-155)
    hr = torch.nonzero(hit).squeeze(1)
    if hr.numel() == 0:
        return out.reshape(2, H, W)
    hn = stop_t[hr] + 1                                   # steps to the hit
    hx0, hy0 = at(hr, hn)
    kx, ky = hx0, hy0
    fnd = torch.zeros_like(hr, dtype=torch.bool)
    for ddx, ddy in _CROSS:
        val = cpf[(hy0 + ddy + 1) * (W + 2) + hx0 + ddx + 1]
        sel = val & ~fnd
        kx = torch.where(sel, hx0 + ddx, kx)
        ky = torch.where(sel, hy0 + ddy, ky)
        fnd = fnd | val
    ok = (kx > 0) & (kx < W - 1) & (ky > 0) & (ky < H - 1)
    dxp = F.pad(dx, (1, 1, 1, 1)).reshape(-1)
    dyp = F.pad(dy, (1, 1, 1, 1)).reshape(-1)
    n = hr % N
    odx, ody = gdx[n], gdy[n]
    opp = torch.zeros_like(ok)
    for ddx, ddy in _BOX9:
        q = (ky + ddy + 1) * (W + 2) + kx + ddx + 1
        gx, gy = dxp[q], dyp[q]
        tn = ody * gx - odx * gy
        td = odx * gx + ody * gy
        opp = opp | ((tn * 7 < -td * 4) & (tn * 7 > td * 4))
    keep = ok & opp
    vr, hn = hr[keep], hn[keep]
    if vr.numel() == 0:
        return out.reshape(2, H, W)
    d2 = (hx0[keep] - ray["ox"][vr]) ** 2 + (hy0[keep] - ray["oy"][vr]) ** 2
    w = torch.round(basic.sqrt32(d2.to(torch.float32))).to(torch.int64)

    # -- paint every path cell t = 0..hn with the ray's width, the smallest
    # wins; then each ray's median along its path (the element of rank
    # hn // 2), written where the ray is the widest through the cell
    npath = hn + 1
    nv = vr.numel()
    own = torch.repeat_interleave(torch.arange(nv, device=dev), npath)
    starts = torch.cumsum(npath, 0) - npath
    tslot = torch.arange(own.numel(), device=dev) - starts[own]
    xs, ys = at(vr[own], tslot)
    tgt = (vr[own] // (3 * N)) * (H * W) + ys * W + xs
    big = torch.iinfo(torch.int64).max
    painted = torch.full((2 * H * W,), big, dtype=torch.int64, device=dev)
    painted.scatter_reduce_(0, tgt, w[own], "amin")
    swt = torch.where(painted == big, 0, painted)
    key = torch.sort(own * 1024 + swt[tgt]).values
    med = key[starts + hn // 2] - torch.arange(nv, device=dev) * 1024
    best = torch.zeros(2 * H * W, dtype=torch.int64, device=dev)
    best.scatter_reduce_(0, tgt, (w * 1024 + med)[own], "amax")
    swt = torch.where(best > 0, best % 1024, swt)
    return swt.reshape(2, H, W).to(torch.uint8)


def swt_map(c: torch.Tensor, dx: torch.Tensor, dy: torch.Tensor,
            direction: int) -> torch.Tensor:
    """Stroke-width map of one polarity (1: DARK_TO_BRIGHT, else
    BRIGHT_TO_DARK). c: closed edge map (H, W), nonzero on edges; dx, dy:
    integer sobels. Returns int32 (H, W) widths, 0 off the strokes."""
    both = _rays(c, dx.to(torch.int32), dy.to(torch.int32))
    return both[0 if direction == 1 else 1].to(torch.int32)


def _compact_strokes(maps: torch.Tensor, gray: torch.Tensor) -> torch.Tensor:
    """The stroke cells of both (2, H, W) uint8 maps and the gray byte under
    each, packed (cell << 16 | width << 8 | gray) into one int64 tensor for
    a single copy to the host."""
    HW = gray.numel()
    flat = maps.reshape(-1)
    pos = torch.nonzero(flat).squeeze(1)
    g = gray.reshape(-1)[pos % HW].to(torch.int64)
    return (pos << 16) | (flat[pos].to(torch.int64) << 8) | g


def _expand_strokes(packed: np.ndarray, H: int, W: int):
    """Host: the (2, H, W) uint8 maps and (H, W) gray plane (gray only
    under the strokes) from _compact_strokes' words."""
    pos = packed >> 16
    maps = np.zeros(2 * H * W, np.uint8)
    maps[pos] = (packed >> 8) & 255
    gray = np.zeros(H * W, np.uint8)
    gray[pos % (H * W)] = packed & 255
    return maps.reshape(2, H, W), gray.reshape(H, W)


def cc_plain(swt_np: np.ndarray, ratio: int = 3) -> np.ndarray:
    """The plain version of the native components (ccv_tpu's scipy route):
    8-connected neighbours join when each width is within ``ratio`` x of
    the other. Labels are scipy's, -1 off the strokes."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    s = swt_np.astype(np.int32)
    H, W = s.shape
    fg = s > 0
    idx = np.arange(H * W, dtype=np.int32).reshape(H, W)
    rows, cols = [], []
    for di, dj in ((0, 1), (1, 0), (1, 1), (1, -1)):
        i0, i1 = max(0, -di), H - max(0, di)
        j0, j1 = max(0, -dj), W - max(0, dj)
        A = s[i0:i1, j0:j1]
        B = s[i0 + di:i1 + di, j0 + dj:j1 + dj]
        m = (A > 0) & (B > 0) & (B <= ratio * A) & (A <= ratio * B)
        rows.append(idx[i0:i1, j0:j1][m])
        cols.append(idx[i0 + di:i1 + di, j0 + dj:j1 + dj][m])
    r = np.concatenate(rows)
    c = np.concatenate(cols)
    g = sp.coo_matrix((np.ones(len(r), np.int8), (r, c)),
                      shape=(H * W, H * W))
    _, lab = connected_components(g, directed=False)
    return np.where(fg, lab.reshape(H, W), -1)


# ---------------------------------------------------------------------------
# the host letter stage (numpy; ccv_tpu's host route)
# ---------------------------------------------------------------------------

def _letters_from_components(image_gray: np.ndarray, swt: np.ndarray,
                             labels: np.ndarray, params: SwtParams):
    """_ccv_swt_connected_letters twin (host, vectorized numpy)."""
    H, W = swt.shape
    flat = labels.reshape(-1)
    fg = flat >= 0
    if not fg.any():
        return []
    ids, inv = np.unique(flat[fg], return_inverse=True)
    n = len(ids)
    ys, xs = np.divmod(np.nonzero(fg)[0], W)
    vals = swt.reshape(-1)[fg].astype(np.float64)
    size = np.bincount(inv, minlength=n)
    x0 = np.full(n, W, np.int64)
    np.minimum.at(x0, inv, xs)
    x1 = np.zeros(n, np.int64)
    np.maximum.at(x1, inv, xs)
    y0 = np.full(n, H, np.int64)
    np.minimum.at(y0, inv, ys)
    y1 = np.zeros(n, np.int64)
    np.maximum.at(y1, inv, ys)
    width = x1 - x0 + 1
    height = y1 - y0 + 1
    # size, area and height gates (_ccv_swt_connected_component's tail)
    keep = ((height >= params.min_height) & (height <= params.max_height)
            & (size >= params.min_area))
    ar = width / height
    keep &= (ar >= 1.0 / params.aspect_ratio) & (ar <= params.aspect_ratio)
    # second-moment elongation ratio
    m10 = np.bincount(inv, xs, n)
    m01 = np.bincount(inv, ys, n)
    m20 = np.bincount(inv, xs.astype(np.float64) ** 2, n)
    m02 = np.bincount(inv, ys.astype(np.float64) ** 2, n)
    m11 = np.bincount(inv, xs.astype(np.float64) * ys, n)
    xc, yc = m10 / size, m01 / size
    af = m20 / size - xc * xc
    bf = 2 * (m11 / size - xc * yc)
    cf = m02 / size - yc * yc
    delta = np.sqrt(bf * bf + (af - cf) ** 2)
    with np.errstate(divide="ignore", invalid="ignore"):
        mom_ratio = np.sqrt((af + cf + delta)
                            / np.maximum(af + cf - delta, 1e-12))
    keep &= ((mom_ratio >= 1.0 / params.aspect_ratio)
             & (mom_ratio <= params.aspect_ratio))
    # stroke-width statistics
    mean = np.bincount(inv, vals, n) / size
    var = np.bincount(inv, vals * vals, n) / size - mean ** 2
    std = np.sqrt(np.maximum(var, 0))
    keep &= std <= mean * params.std_ratio

    kept_ids = np.nonzero(keep)[0]
    if len(kept_ids) == 0:
        return []
    # occlusion filter: a letter's bbox may hold pixels of at most
    # letter_occlude_thresh other letters (ccv_swt.c:368-399)
    remap = np.full(n, -1)
    remap[kept_ids] = np.arange(len(kept_ids))
    lab_img = np.full((H, W), -1, np.int64)
    lab_img.reshape(-1)[fg] = remap[inv]
    final = []
    inten = np.bincount(inv, image_gray.reshape(-1)[fg].astype(np.float64),
                        n)
    inten = (inten / size).astype(np.int64)
    # thickness: the median stroke width of each component
    order = np.lexsort((vals, inv))
    sorted_vals = vals[order]
    starts = np.searchsorted(inv[order], np.arange(n))
    for row, comp in enumerate(kept_ids):
        bx0, bx1, by0, by1 = x0[comp], x1[comp], y0[comp], y1[comp]
        sub = lab_img[by0:by1 + 1, bx0:bx1 + 1]
        others = np.unique(sub[(sub >= 0) & (sub != row)])
        if (params.letter_occlude_thresh
                and len(others) > params.letter_occlude_thresh):
            continue
        s, c = starts[comp], size[comp]
        med = sorted_vals[s + (c - 1) // 2]
        final.append(dict(
            x=int(bx0), y=int(by0), width=int(width[comp]),
            height=int(height[comp]),
            cx=int(bx0) + int(width[comp]) // 2,
            cy=int(by0) + int(height[comp]) // 2,
            thickness=int(med), intensity=int(inten[comp]),
            mean=float(mean[comp]), std=float(std[comp])))
    return final


def _merge_textline(letters: List[dict], params: SwtParams) -> List[dict]:
    """_ccv_swt_merge_textline twin (ccv_swt.c:499)."""
    pairs = []
    for i in range(len(letters) - 1):
        li = letters[i]
        for j in range(i + 1, len(letters)):
            lj = letters[j]
            r = li["thickness"] / max(lj["thickness"], 1e-9)
            if r > params.thickness_ratio or r < 1.0 / params.thickness_ratio:
                continue
            r = li["height"] / lj["height"]
            if r > params.height_ratio or r < 1.0 / params.height_ratio:
                continue
            if abs(li["intensity"] - lj["intensity"]) > params.intensity_thresh:
                continue
            dx = li["x"] - lj["x"] + (li["width"] - lj["width"]) // 2
            dy = li["y"] - lj["y"] + (li["height"] - lj["height"]) // 2
            if abs(dx) > params.distance_ratio * max(li["width"], lj["width"]):
                continue
            oy = (min(li["y"] + li["height"], lj["y"] + lj["height"])
                  - max(li["y"], lj["y"]))
            if oy * params.intersect_ratio < min(li["height"], lj["height"]):
                continue
            pairs.append(dict(left=i, right=j, dx=dx, dy=dy))
    if not pairs:
        return []

    def same(p1, p2):
        tn = p1["dy"] * p2["dx"] - p1["dx"] * p2["dy"]
        td = p1["dx"] * p2["dx"] + p1["dy"] * p2["dy"]
        if p1["left"] == p2["left"] or p1["right"] == p2["right"]:
            return tn * 7 < -td * 4 and tn * 7 > td * 4
        if p1["left"] == p2["right"] or p1["right"] == p2["left"]:
            return tn * 7 < td * 4 and tn * 7 > -td * 4
        return False

    idx = group(pairs, same)
    chains = [set() for _ in range(max(idx) + 1)]
    for p, g in zip(pairs, idx):
        chains[g].add(p["left"])
        chains[g].add(p["right"])
    out = []
    for members in chains:
        mem = [letters[m] for m in members]
        if len(mem) < params.letter_thresh:
            continue
        x0 = min(lt["x"] for lt in mem)
        y0 = min(lt["y"] for lt in mem)
        x1 = max(lt["x"] + lt["width"] for lt in mem)
        y1 = max(lt["y"] + lt["height"] for lt in mem)
        if (x1 - x0) <= (y1 - y0) * params.elongate_ratio:
            continue
        out.append(dict(x=x0, y=y0, width=x1 - x0, height=y1 - y0,
                        letters=sorted(mem, key=lambda lt: lt["cx"])))
    return out


def _same_textline(t1, t2, thresh) -> bool:
    w = min(t1["x"] + t1["width"], t2["x"] + t2["width"]) - max(t1["x"],
                                                                t2["x"])
    h = min(t1["y"] + t1["height"], t2["y"] + t2["height"]) - max(t1["y"],
                                                                  t2["y"])
    a1 = t1["width"] * t1["height"]
    a2 = t2["width"] * t2["height"]
    return (w > 0 and h > 0 and w * h > thresh[0] * max(a1, a2)
            and w * h > thresh[1] * min(a1, a2))


def _swt_group_textlines(textlines: List[dict], params: SwtParams):
    """Group overlapping textlines, keep the widest of each group."""
    if not textlines:
        return textlines
    idx = group(textlines, lambda a, b: _same_textline(
        a, b, params.same_word_thresh))
    best = [None] * (max(idx) + 1)
    for t, g in zip(textlines, idx):
        if best[g] is None or t["width"] > best[g]["width"]:
            best[g] = t
    return best


def _otsu_host(gaps: np.ndarray, range_: int):
    """ops.classic.otsu in numpy float64, for the few inter-letter gaps of
    a textline."""
    flat = np.clip(gaps.astype(np.int64), 0, range_ - 1)
    hist = np.bincount(flat, minlength=range_)
    total = flat.size
    i = np.arange(range_, dtype=np.float64)
    sum_all = float(np.sum(i * hist))
    wB = np.cumsum(hist)
    sumB = np.cumsum(i * hist)
    wF = total - wB
    valid = (wB > 0) & (wF > 0)
    mB = sumB / np.maximum(wB, 1)
    mF = (sum_all - sumB) / np.maximum(wF, 1)
    var = np.where(valid, wB * wF * (mB - mF) ** 2, 0.0)
    threshold = int(np.argmax(var))  # the first maximum on ties
    return threshold, float(var[threshold]) / total / total


def _bbox(ls):
    x0 = min(lt["x"] for lt in ls)
    y0 = min(lt["y"] for lt in ls)
    x1 = max(lt["x"] + lt["width"] for lt in ls)
    y1 = max(lt["y"] + lt["height"] for lt in ls)
    return dict(x=x0, y=y0, width=x1 - x0, height=y1 - y0)


def _break_words(textlines: List[dict], params: SwtParams) -> List[dict]:
    """_ccv_swt_break_words twin: Otsu over the inter-letter gaps."""
    words = []
    for t in textlines:
        ls = t["letters"]
        if len(ls) < 2:
            words.append({k: t[k] for k in ("x", "y", "width", "height")})
            continue
        gaps = np.array([max(0, ls[j + 1]["x"] - (ls[j]["x"] + ls[j]["width"]))
                         for j in range(len(ls) - 1)], np.int32)
        th, var = _otsu_host(gaps, int(gaps.max()) + 1)
        if math.sqrt(var) > gaps.mean() * params.breakdown_ratio:
            cur = [ls[0]]
            for j in range(len(ls) - 1):
                if gaps[j] > th:
                    words.append(_bbox(cur))
                    cur = []
                cur.append(ls[j + 1])
            words.append(_bbox(cur))
        else:
            words.append({k: t[k] for k in ("x", "y", "width", "height")})
    return words


# ---------------------------------------------------------------------------
# detect_words
# ---------------------------------------------------------------------------

def _scale_words(img: torch.Tensor, params: SwtParams,
                 timings: Optional[dict]) -> List[dict]:
    """The words of one pyramid level: device front end and rays, one copy
    to the host, the host letter stage."""
    def mark(stage, t0):
        if timings is None:
            return t0
        if img.device.type == "cuda":
            torch.cuda.synchronize(img.device)
        t1 = time.perf_counter()
        timings[stage] = timings.get(stage, 0.0) + (t1 - t0) * 1e3
        return t1

    H, W = img.shape
    t = time.perf_counter()
    c, dx, dy, gray = _frontend(img, params.size,
                                int(params.low_thresh + 0.5),
                                int(params.high_thresh + 0.5))
    t = mark("frontend", t)
    packed = _compact_strokes(_rays(c, dx, dy), gray)
    t = mark("rays", t)
    maps, gray_np = _expand_strokes(packed.cpu().numpy(), H, W)
    t = mark("fetch", t)
    labels = [native.swt_cc(maps[d]) for d in range(2)]
    t = mark("cc", t)
    textlines = []
    for d in range(2):  # DARK_TO_BRIGHT, BRIGHT_TO_DARK
        letters = _letters_from_components(gray_np, maps[d], labels[d],
                                           params)
        textlines += _merge_textline(letters, params)
    textlines = _swt_group_textlines(textlines, params)
    words = (_break_words(textlines, params) if params.breakdown else
             [{k: t_[k] for k in ("x", "y", "width", "height")}
              for t_ in textlines])
    mark("letters", t)
    return words


def detect_words(a, params: Optional[SwtParams] = None,
                 timings: Optional[dict] = None, device=None) -> List[Comp]:
    """ccv_swt_detect_words twin (ccv_swt.c:625), single scale unless
    ``params.scale_invariant``. ``a`` is (H, W) or (H, W, C) (channel 0 is
    read) on ``device`` (default: where a tensor is, else the card).

    Pass a dict as ``timings`` for a per-stage wall-clock breakdown in ms,
    summed over scales: frontend / rays / fetch / cc / letters (each stage
    ends in a device synchronize when one is timed)."""
    params = params or SwtParams()
    img = as_array(a, device)
    if img.dim() == 3:
        img = img[..., 0]
    all_words: List[dict] = []
    scale = 2.0 ** (1.0 / (params.interval + 1.0))
    if params.scale_invariant:
        hr = img.shape[0] * 2 // (params.min_height + params.max_height)
        wr = img.shape[1] * 2 // (params.min_height + params.max_height)
        scale_upto = int(math.log(min(hr, wr)) / math.log(scale))
    else:
        scale_upto = 1
    next_ = params.interval + 1
    phx = img
    cscale = 1.0
    for k in range(scale_upto):
        if k % next_:
            j = k % next_
            pyr = resample.resample(
                phx, rows=int(phx.shape[0] / scale ** j),
                cols=int(phx.shape[1] / scale ** j),
                rows_scale=1 / scale ** j, cols_scale=1 / scale ** j,
                interp=resample.INTER_AREA)
        elif k > 0:
            phx = resample.sample_down(phx)
            pyr = phx
        else:
            pyr = phx
        words = _scale_words(pyr, params, timings)
        if params.scale_invariant:
            for wd in words:
                all_words.append(dict(
                    x=int(wd["x"] * cscale + 0.5),
                    y=int(wd["y"] * cscale + 0.5),
                    width=int(wd["width"] * cscale + 0.5),
                    height=int(wd["height"] * cscale + 0.5)))
            cscale *= scale
        else:
            all_words = words
    comps = [Comp(w["x"], w["y"], w["width"], w["height"]) for w in all_words]
    if params.scale_invariant and params.min_neighbors:
        idx = group(comps, lambda a, b: _same_textline(
            dict(x=a.x, y=a.y, width=a.width, height=a.height),
            dict(x=b.x, y=b.y, width=b.width, height=b.height),
            params.same_word_thresh))
        ngroups = max(idx) + 1 if comps else 0
        best = [None] * ngroups
        counts = [0] * ngroups
        for c_, g in zip(comps, idx):
            counts[g] += 1
            if (best[g] is None
                    or c_.width * c_.height > best[g].width * best[g].height):
                best[g] = c_
        comps = [dataclasses.replace(b, neighbors=n)
                 for b, n in zip(best, counts) if n >= params.min_neighbors]
    return comps


_EXECUTOR: Optional[ThreadPoolExecutor] = None


def detect_words_async(a, params: Optional[SwtParams] = None,
                       device=None) -> Future:
    """Submit an image to a small thread pool, so that one image's host
    letter stage overlaps the next one's device work; resolve the future
    with ``detect_words_collect``."""
    global _EXECUTOR
    if _EXECUTOR is None:
        _EXECUTOR = ThreadPoolExecutor(max_workers=3)
    return _EXECUTOR.submit(detect_words, a, params, None, device)


def detect_words_collect(fut: Future) -> List[Comp]:
    return fut.result()
