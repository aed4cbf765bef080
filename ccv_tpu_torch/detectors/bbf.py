"""BBF, the brightness binary feature face detector (counterpart of
ccv_tpu/detectors/bbf.py; reference: lib/ccv_bbf.c).

A feature compares min(bright points) > max(dark points) over a triple of
pyramid levels, full, half and quarter resolution of the window
(_ccv_run_bbf_feature, ccv_bbf.c:25). All windows of a scale form a regular
grid over the quarter level, so every point a feature reads is a gather off
one of the three flattened levels.

The main path of ``detect_objects``, per image:

1. on the device, the pyramid (ccv_bbf.c:1198-1236): INTER_AREA levels
   within the first octave, exact-2x ``sample_down`` below them, and in the
   accurate mode the three ``sample_down(src_x, src_y)`` variants of the
   quarter levels;
2. on the device, per scale and offset variant (``_eval_scale``): one
   gather of (windows, F, 16) points per level, in chunks of windows that
   keep the gathers within ``GATHER_ELEMENTS``; the min / max per feature,
   the comparison, and the stage sums as one float32 matmul ``contrib @
   onehot`` (features to stages); a window passes when every stage sum
   reaches its threshold (the early exit as an all-stages mask);
3. one copy of every scale's pass mask and last-stage sum to the host, then
   the rects, the grouping and the small-inside-large filter
   (ccv_bbf.c:1296-1358).

Cascades are the reference's per-stage text files (``load_cascade``;
``write_cascade`` writes them), floats stored as their int bit patterns.
"""

from __future__ import annotations

import dataclasses
import math
import os
import struct
from typing import List, Optional

import numpy as np
import torch

from ccv_tpu_torch.core.dense_matrix import as_array
from ccv_tpu_torch.detectors.common import Comp, group
from ccv_tpu_torch.device import to_device
from ccv_tpu_torch.ops import resample

# int32 points gathered at once per level (windows x F x 16): the chunk of
# windows is cut to fit, so a 1080p frame's level 0 does not need gigabytes
GATHER_ELEMENTS = 1 << 25


@dataclasses.dataclass
class BbfParams:
    """ccv_bbf_default_params twin (ccv_bbf.c:12)."""

    interval: int = 5
    min_neighbors: int = 2
    accurate: bool = True
    size: tuple = (24, 24)


@dataclasses.dataclass
class BbfCascade:
    """The features of all stages, flattened; points -1-padded to 8."""

    width: int
    height: int
    stage_of: np.ndarray     # (F,)
    n_stages: int
    thresholds: np.ndarray   # (S,)
    alphas: np.ndarray       # (F, 2)
    px: np.ndarray           # (F, 8)
    py: np.ndarray
    pz: np.ndarray
    nx: np.ndarray
    ny: np.ndarray
    nz: np.ndarray


def _as_float(i: int) -> float:
    return struct.unpack("<f", struct.pack("<i", i))[0]


def _bits(f: float) -> int:
    return struct.unpack("<i", struct.pack("<f", float(f)))[0]


def load_cascade(directory: str) -> BbfCascade:
    """ccv_bbf_read_classifier_cascade twin: cascade.txt and one
    stage-N.txt per stage; a missing stage file ends the cascade."""
    with open(os.path.join(directory, "cascade.txt")) as f:
        count, w, h = (int(t) for t in f.read().split()[:3])
    stage_of, thresholds, alphas = [], [], []
    pts = {k: [] for k in ("px", "py", "pz", "nx", "ny", "nz")}
    for s in range(count):
        path = os.path.join(directory, f"stage-{s}.txt")
        if not os.path.exists(path):
            count = s
            break
        with open(path) as f:
            toks = iter(int(t) for t in f.read().split())
        fcount = next(toks)
        thresholds.append(_as_float(next(toks)))
        for _ in range(fcount):
            size = next(toks)
            fp = {k: [-1 if k[1] != "y" else 0] * 8 for k in pts}
            for j in range(size):
                for k in ("px", "py", "pz", "nx", "ny", "nz"):
                    fp[k][j] = next(toks)
            alphas.append((_as_float(next(toks)), _as_float(next(toks))))
            stage_of.append(s)
            for k in pts:
                pts[k].append(fp[k])
    return BbfCascade(
        width=w, height=h, stage_of=np.array(stage_of, np.int32),
        n_stages=count, thresholds=np.array(thresholds, np.float32),
        alphas=np.array(alphas, np.float32),
        **{k: np.array(v, np.int32).reshape(-1, 8) for k, v in pts.items()})


def write_cascade(cas: BbfCascade, directory: str) -> None:
    """The reference's cascade text: cascade.txt and stage-N.txt, floats as
    their int bit patterns (a copy of ccv_tpu/train/bbf.py's writer)."""
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "cascade.txt"), "w") as f:
        f.write(f"{cas.n_stages} {cas.width} {cas.height}\n")
    for s in range(cas.n_stages):
        sel = np.nonzero(cas.stage_of == s)[0]
        lines = [f"{len(sel)}", f"{_bits(cas.thresholds[s])}"]
        for i in sel:
            size = int((cas.pz[i] >= 0).sum())
            lines.append(f"{size}")
            for j in range(size):
                lines.append(f"{cas.px[i, j]} {cas.py[i, j]} {cas.pz[i, j]}")
                lines.append(f"{cas.nx[i, j]} {cas.ny[i, j]} {cas.nz[i, j]}")
            lines.append(f"{_bits(cas.alphas[i, 0])} "
                         f"{_bits(cas.alphas[i, 1])}")
        with open(os.path.join(directory, f"stage-{s}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")


def _prepare_tables(c: BbfCascade, W0: int, W1: int, W2: int):
    """Per level: (offsets (F, 16) into the flattened level for row widths
    W0, W1, W2, the value a point takes when it is not on this level or is
    padding: 256 for a positive point, -1 for a negative one, (F, 16)),
    then the (F, S) one-hot of each feature's stage."""
    tabs = []
    for level, width in ((0, W0), (1, W1), (2, W2)):
        offs, fills = [], []
        for xs, ys, zs, fill in ((c.px, c.py, c.pz, 256),
                                 (c.nx, c.ny, c.nz, -1)):
            on = (zs == level) & (xs >= 0)
            offs.append(np.where(on, ys * width + xs, 0))
            fills.append(np.where(on, 0, fill))   # 0: read the level
        tabs.append((np.concatenate(offs, 1).astype(np.int64),
                     np.concatenate(fills, 1).astype(np.int16)))
    onehot = np.zeros((len(c.stage_of), c.n_stages), np.float32)
    onehot[np.arange(len(c.stage_of)), c.stage_of] = 1.0
    return tabs, onehot


def _tables(c: BbfCascade, key, device: torch.device, cache: dict):
    """The cascade's device tables for the level widths ``key``, once per
    detect call."""
    if key not in cache:
        tabs, onehot = _prepare_tables(c, *key)
        cache[key] = ([(to_device(off, device), to_device(fill, device))
                       for off, fill in tabs],
                      to_device(onehot, device),
                      to_device(c.thresholds, device),
                      to_device(c.alphas, device))
    return cache[key]


def _stage_sums(levels, tables, ny_: int, nx_: int):
    """The (windows, S) stage sums of every window of one scale triple, in
    chunks of windows. Window (y, x) of the quarter grid covers
    full[4y:4y + H, 4x:4x + W]; a point's linear offset wraps modulo its
    level's size, as ccv_tpu's gather does."""
    (tabs, onehot, _thresholds, alphas) = tables
    dev = levels[0].device
    iy = torch.arange(ny_, device=dev)
    ix = torch.arange(nx_, device=dev)
    bases = [((iy[:, None] * (4 >> k)) * lv.shape[1]
              + ix[None, :] * (4 >> k)).reshape(-1)
             for k, lv in enumerate(levels)]
    flats = [lv.reshape(-1).to(torch.int16) for lv in levels]
    chunk = max(1, GATHER_ELEMENTS // (onehot.shape[0] * 16))
    for s in range(0, ny_ * nx_, chunk):
        pmin = nmax = None
        for flat, base, (off, fill) in zip(flats, bases, tabs):
            g = flat[(base[s:s + chunk, None, None] + off[None])
                     % flat.shape[0]]                       # (w, F, 16)
            g = torch.where(fill == 0, g, fill)
            p, n = g[..., :8].amin(-1), g[..., 8:].amax(-1)
            pmin = p if pmin is None else torch.minimum(pmin, p)
            nmax = n if nmax is None else torch.maximum(nmax, n)
        contrib = torch.where(pmin > nmax, alphas[:, 1], alphas[:, 0])
        yield contrib @ onehot                               # (w, S)


def _eval_scale(levels, tables, ny_: int, nx_: int):
    """Every window of one scale triple: (passed (windows,), last-stage sum
    (windows,)); a window passes when every stage sum reaches its
    threshold."""
    thresholds = tables[2]
    passed, conf = [], []
    for sums in _stage_sums(levels, tables, ny_, nx_):
        passed.append(torch.all(sums >= thresholds, dim=-1))
        conf.append(sums[:, -1])
    return torch.cat(passed), torch.cat(conf)


def _gray(img: torch.Tensor) -> torch.Tensor:
    """core.io.rgb_to_gray_u8 on the device (libjpeg's coefficients)."""
    r, g, b = (img[..., i].to(torch.int32) for i in range(3))
    return ((r * 6969 + g * 23434 + b * 2365) >> 15).to(torch.uint8)


def _pyramid(img: torch.Tensor, c0: BbfCascade, params: BbfParams,
             scale: float, scale_upto: int) -> dict:
    """{(level, variant): plane}: the resample / sample_down pyramid, and in
    the accurate mode the src_x / src_y variants (1, 2, 3) of the quarter
    levels (ccv_bbf.c:1198-1236)."""
    H, W = img.shape
    pw, ph = params.size
    next_ = params.interval + 1
    pyr = {}
    if (ph, pw) != (c0.height, c0.width):
        rows, cols = H * c0.height // ph, W * c0.width // pw
        pyr[(0, 0)] = resample.resample(
            img, rows=rows, cols=cols, rows_scale=rows / H,
            cols_scale=cols / W, interp=resample.INTER_AREA)
    else:
        pyr[(0, 0)] = img
    base = pyr[(0, 0)]
    for i in range(1, min(params.interval + 1, scale_upto + next_ * 2)):
        r = int(base.shape[0] / scale ** i)
        cl = int(base.shape[1] / scale ** i)
        pyr[(i, 0)] = resample.resample(
            base, rows=r, cols=cl, rows_scale=r / base.shape[0],
            cols_scale=cl / base.shape[1], interp=resample.INTER_AREA)
    for i in range(next_, scale_upto + next_ * 2):
        pyr[(i, 0)] = resample.sample_down(pyr[(i - next_, 0)])
    if params.accurate:
        for i in range(next_ * 2, scale_upto + next_ * 2):
            src = pyr[(i - next_, 0)]
            pyr[(i, 1)] = resample.sample_down(src, src_x=1)
            pyr[(i, 2)] = resample.sample_down(src, src_y=1)
            pyr[(i, 3)] = resample.sample_down(src, src_x=1, src_y=1)
    return pyr


_DXS, _DYS = (0, 1, 0, 1), (0, 0, 1, 1)   # the accurate mode's variants


def _shifted(plane: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """plane[dy:, dx:] zero-padded back to its shape, so that the linear
    offsets of the tables stay valid."""
    if not (dy or dx):
        return plane
    out = torch.zeros_like(plane)
    out[:plane.shape[0] - dy, :plane.shape[1] - dx] = plane[dy:, dx:]
    return out


def _scale_triples(pyr: dict, casc: BbfCascade, params: BbfParams,
                   scale_upto: int):
    """(i, q, rows, cols, levels, tables) of every scale and offset variant
    with windows: the full and half levels shifted for the variant."""
    next_ = params.interval + 1
    cache: dict = {}
    for i in range(scale_upto):
        full, half = pyr[(i, 0)], pyr[(i + next_, 0)]
        for q in range(4 if params.accurate else 1):
            quarter = pyr[(i + 2 * next_, q)]
            i_rows = quarter.shape[0] - (casc.height >> 2)
            i_cols = quarter.shape[1] - (casc.width >> 2)
            if i_rows <= 0 or i_cols <= 0:
                continue
            key = (full.shape[1], half.shape[1], quarter.shape[1])
            levels = (_shifted(full, _DYS[q] * 2, _DXS[q] * 2),
                      _shifted(half, _DYS[q], _DXS[q]), quarter)
            yield (i, q, i_rows, i_cols, levels,
                   _tables(casc, key, full.device, cache))


def _windows(pyr: dict, casc: BbfCascade, params: BbfParams,
             scale_upto: int):
    """Every (scale, variant) of one cascade on the device: the list of
    (i, q, rows, cols) and the pass masks and last-stage sums of all their
    windows, concatenated, copied to the host once."""
    runs, passed, conf = [], [], []
    for i, q, rows, cols, levels, tables in _scale_triples(
            pyr, casc, params, scale_upto):
        p, cf = _eval_scale(levels, tables, rows, cols)
        runs.append((i, q, rows, cols))
        passed.append(p)
        conf.append(cf)
    if not runs:
        return runs, np.zeros(0, bool), np.zeros(0, np.float32)
    return (runs, torch.cat(passed).cpu().numpy(),
            torch.cat(conf).cpu().numpy())


def _group(comps: List[Comp], min_neighbors: int, t: int) -> List[Comp]:
    """The average box per group, then the small-inside-large filter
    (ccv_bbf.c:1296-1358)."""
    def same(r1, r2):
        d = int(r1.width * 0.25 + 0.5)
        return (r2.classification_id == r1.classification_id
                and r1.x - d <= r2.x <= r1.x + d
                and r1.y - d <= r2.y <= r1.y + d
                and r2.width <= int(r1.width * 1.5 + 0.5)
                and int(r2.width * 1.5 + 0.5) >= r1.width)

    idx = group(comps, same)
    sums = [[0, 0, 0, 0, 0, 0.0] for _ in range(max(idx) + 1)]
    for cm, g in zip(comps, idx):
        s_ = sums[g]
        s_[0] += cm.x
        s_[1] += cm.y
        s_[2] += cm.width
        s_[3] += cm.height
        s_[4] += 1
        s_[5] = max(s_[5], cm.confidence)
    seq2 = [Comp(x=(x * 2 + n) // (2 * n), y=(y * 2 + n) // (2 * n),
                 width=(w * 2 + n) // (2 * n), height=(h * 2 + n) // (2 * n),
                 confidence=cf, neighbors=n, classification_id=t)
            for x, y, w, h, n, cf in sums if n >= min_neighbors]

    def inside(r1, r2):
        d = int(r2.width * 0.25 + 0.5)
        return (r1.classification_id == r2.classification_id
                and r1.x >= r2.x - d and r1.y >= r2.y - d
                and r1.x + r1.width <= r2.x + r2.width + d
                and r1.y + r1.height <= r2.y + r2.height + d
                and (r2.neighbors > max(3, r1.neighbors)
                     or r1.neighbors < 3))

    return [r1 for i1, r1 in enumerate(seq2) if not any(
        i1 != j1 and inside(r1, r2) for j1, r2 in enumerate(seq2))]


def _prepare(a, cascades, params: Optional[BbfParams], device):
    params = params or BbfParams()
    if not isinstance(cascades, (list, tuple)):
        cascades = [cascades]
    img = as_array(a, device)
    if img.dim() == 3 and img.shape[-1] == 3:
        img = _gray(img)
    elif img.dim() == 3:
        img = img[..., 0]
    H, W = img.shape
    pw, ph = params.size
    scale = 2.0 ** (1.0 / (params.interval + 1.0))
    scale_upto = int(math.log(min(H // ph, W // pw)) / math.log(scale))
    pyr = _pyramid(img, cascades[0], params, scale, scale_upto)
    return params, cascades, pyr, scale, scale_upto


def _rects(casc: BbfCascade, params: BbfParams, scale: float, runs,
           idx: Optional[np.ndarray] = None) -> np.ndarray:
    """(n, 4) int64 rects (x, y, width, height) of the windows ``idx`` (all
    when None) of ``runs`` in their order, the window scale of level i
    compounded as ccv_bbf.c does."""
    pw, ph = params.size
    scales, sx, sy = [], pw / casc.width, ph / casc.height
    for _ in range(max([r[0] for r in runs], default=-1) + 1):
        scales.append((sx, sy))
        sx, sy = sx * scale, sy * scale
    sizes = np.array([r[2] * r[3] for r in runs], np.int64)
    starts = np.concatenate([[0], np.cumsum(sizes)])
    idx = np.arange(starts[-1]) if idx is None else np.asarray(idx, np.int64)
    run = np.searchsorted(starts, idx, side="right") - 1
    out = np.zeros((len(idx), 4), np.int64)
    for r, (i, q, rows, cols) in enumerate(runs):
        m = run == r
        wy, wx = np.divmod(idx[m] - starts[r], cols)
        sx, sy = scales[i]
        out[m, 0] = ((wx * 4 + _DXS[q] * 2) * sx + 0.5).astype(np.int64)
        out[m, 1] = ((wy * 4 + _DYS[q] * 2) * sy + 0.5).astype(np.int64)
        out[m, 2] = int(casc.width * sx + 0.5)
        out[m, 3] = int(casc.height * sy + 0.5)
    return out


def window_sums(a, casc: BbfCascade, params: Optional[BbfParams] = None,
                device=None):
    """(rects (windows, 4), stage sums (windows, S) float32), on the host, of
    every window of ``casc`` on ``a`` in ``detect_objects``' order; a window
    passes where every sum reaches its stage's threshold."""
    params, cascades, pyr, scale, scale_upto = _prepare(a, casc, params,
                                                        device)
    runs, sums = [], []
    for i, q, rows, cols, levels, tables in _scale_triples(
            pyr, casc, params, scale_upto):
        runs.append((i, q, rows, cols))
        sums += list(_stage_sums(levels, tables, rows, cols))
    return (_rects(casc, params, scale, runs),
            torch.cat(sums).cpu().numpy() if sums else
            np.zeros((0, casc.n_stages), np.float32))


def detect_objects(a, cascades, params: Optional[BbfParams] = None,
                   device=None) -> List[Comp]:
    """ccv_bbf_detect_objects twin (ccv_bbf.c:1188) on ``a``'s device (a
    numpy image goes to ``device``, default the card); an RGB image is
    turned to gray with libjpeg's coefficients, as ccv_tpu does."""
    params, cascades, pyr, scale, scale_upto = _prepare(a, cascades, params,
                                                        device)
    result: List[Comp] = []
    for t, casc in enumerate(cascades):
        runs, passed, conf = _windows(pyr, casc, params, scale_upto)
        idx = np.nonzero(passed)[0]
        comps = [Comp(*(int(v) for v in r), confidence=float(conf[k]),
                      classification_id=t)
                 for k, r in zip(idx, _rects(casc, params, scale, runs, idx))]
        if params.min_neighbors == 0:
            result += comps
        elif comps:
            result += _group(comps, params.min_neighbors, t)
    return result
