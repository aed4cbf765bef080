"""DPM: the deformable parts model detector (counterpart of
ccv_tpu/detectors/dpm.py; reference: lib/ccv_dpm.c).

The main path of ``detect``, per image:

1. on the device, the HOG feature pyramid (``_feature_pyramid``,
   ccv_dpm.c:45): INTER_AREA levels within the first octave, exact-2x
   ``sample_down`` below them, ``ops.classic.hog`` on each, the first
   ``interval + 1`` levels at twice the resolution (cells of 4 pixels);
2. on the device, per level and root (``_level``, ccv_dpm.c:76-118): the
   31-channel correlations of the root filter and of the part filters
   (``_corr31``: ``F.pad`` then ``F.conv2d``, zero padding, the output the
   input's size), each part's generalized distance transform (``_gsedt``, a
   dense (..., j, v) cost and its first minimum per axis instead of the
   reference's lower-envelope scan), and the root score minus the parts'
   transformed responses at their anchors;
3. on the host, the windows whose score passes the threshold, their parts'
   displacements (the part planes are copied only for levels where a
   window passes), and the grouping and nested-rectangle filters
   (``_dpm_group``, ccv_dpm.c:2195-2276).

Model files are the reference's text format (ccv_dpm_read_mixture_model,
ccv_dpm.c:2279), parsed with ``float.fromhex``; ``write_mixture_model``
writes it.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ccv_tpu_torch.core.dense_matrix import as_array
from ccv_tpu_torch.detectors.common import Comp, group
from ccv_tpu_torch.ops import classic, resample

WINDOW_SIZE = 8  # CCV_DPM_WINDOW_SIZE


@dataclasses.dataclass
class DpmPartClassifier:
    x: int
    y: int
    z: int
    dx: float
    dy: float
    dxx: float
    dyy: float
    alpha: np.ndarray      # (6,)
    w: np.ndarray          # (rows, cols, 31)
    counterpart: int


@dataclasses.dataclass
class DpmRootClassifier:
    beta: float
    alpha: np.ndarray      # (3,) drift x / y / scale
    w: np.ndarray          # (rows, cols, 31)
    parts: List[DpmPartClassifier]


@dataclasses.dataclass
class DpmMixtureModel:
    roots: List[DpmRootClassifier]

    @property
    def count(self):
        return len(self.roots)


@dataclasses.dataclass
class DpmParams:
    """ccv_dpm_default_params twin (ccv_dpm.c:16)."""

    interval: int = 8
    min_neighbors: int = 1
    flags: int = 0
    threshold: float = 0.6


@dataclasses.dataclass
class RootComp:
    """ccv_root_comp_t twin: a detection and its part placements."""

    x: int
    y: int
    width: int
    height: int
    confidence: float
    classification_id: int = 1
    neighbors: int = 1
    parts: List[Comp] = dataclasses.field(default_factory=list)


def _ffloat(tok: str) -> float:
    return float.fromhex(tok) if "x" in tok or "X" in tok else float(tok)


def parse_roots(toks: List[str], pos: int, count: int
                ) -> Tuple[List[DpmRootClassifier], int]:
    """``count`` root classifiers of the model text's tokens from ``pos``
    on: (the roots, the position after them)."""
    def floats(n):
        nonlocal pos
        out = [_ffloat(t) for t in toks[pos:pos + n]]
        pos += n
        return out

    def ints(n):
        nonlocal pos
        out = [int(t) for t in toks[pos:pos + n]]
        pos += n
        return out

    roots = []
    for _ in range(count):
        rows, cols = ints(2)
        beta, *alpha = floats(4)
        w = np.array(floats(rows * cols * 31), np.float32).reshape(
            rows, cols, 31)
        parts = []
        for _ in range(ints(1)[0]):
            x, y, z = ints(3)
            dx, dy, dxx, dyy = floats(4)
            palpha = np.array(floats(6), np.float32)
            pr, pc, cp = ints(3)
            pw = np.array(floats(pr * pc * 31), np.float32).reshape(
                pr, pc, 31)
            parts.append(DpmPartClassifier(x, y, z, dx, dy, dxx, dyy,
                                           palpha, pw, cp))
        roots.append(DpmRootClassifier(beta, np.array(alpha, np.float32), w,
                                       parts))
    return roots, pos


def read_mixture_model(path: str) -> DpmMixtureModel:
    """ccv_dpm_read_mixture_model twin (ccv_dpm.c:2279): text with C99 hex
    floats."""
    with open(path) as f:
        toks = f.read().split()
    if toks[0] != ".":
        raise ValueError(f"{path}: not a finished DPM model (starts with "
                         f"{toks[0]!r})")
    roots, pos = parse_roots(toks, 2, int(toks[1]))
    if pos != len(toks):
        raise ValueError(f"{path}: {len(toks) - pos} tokens after the model")
    return DpmMixtureModel(roots)


def model_lines(model: DpmMixtureModel) -> List[str]:
    """The roots of _ccv_dpm_write_checkpoint's text (ccv_dpm.c:169), C99
    hex floats, without the header lines."""
    def hexf(vals):
        return " ".join(float(v).hex() for v in vals)

    lines = []
    for root in model.roots:
        r, c = root.w.shape[0], root.w.shape[1]
        lines += [f"{r} {c}", hexf([root.beta, *root.alpha])]
        lines += [hexf(root.w[y].reshape(-1)) + " " for y in range(r)]
        lines.append(f"{len(root.parts)}")
        for p in root.parts:
            lines += [f"{p.x} {p.y} {p.z}", hexf([p.dx, p.dy, p.dxx, p.dyy]),
                      hexf(p.alpha),
                      f"{p.w.shape[0]} {p.w.shape[1]} {p.counterpart}"]
            lines += [hexf(p.w[y].reshape(-1)) + " "
                      for y in range(p.w.shape[0])]
    return lines


def write_lines(lines: List[str], path: str) -> None:
    """The lines, each ended by a newline, into ``path`` by way of
    ``path.swp`` (replaced in one step, as the reference's checkpoint)."""
    tmp = path + ".swp"
    with open(tmp, "w") as f:
        f.write("\n".join(lines) + "\n")
    os.replace(tmp, path)


def write_mixture_model(model: DpmMixtureModel, path: str) -> None:
    """The finished-model text of _ccv_dpm_write_checkpoint (ccv_dpm.c:169),
    readable by ``read_mixture_model`` and the reference's reader (the
    bytes of ccv_tpu/train/dpm.py's writer)."""
    write_lines([".", f"{len(model.roots)}"] + model_lines(model), path)


# ---------------------------------------------------------------------------
# device programs
# ---------------------------------------------------------------------------

def _corr31(a: torch.Tensor, w) -> torch.Tensor:
    """ccv_filter + ccv_flatten twin: the 31-channel correlation of an
    (H, W, 31) map with a (bh, bw, 31) filter, zero padding, the output the
    input's size, the window anchored at ((bh - 1) // 2, (bw - 1) // 2)."""
    w = torch.as_tensor(w, dtype=torch.float32, device=a.device)
    bh, bw = w.shape[0], w.shape[1]
    sy, sx = (bh - 1) // 2, (bw - 1) // 2
    x = a.to(torch.float32).permute(2, 0, 1)[None]           # (1, 31, H, W)
    x = F.pad(x, (sx, bw - 1 - sx, sy, bh - 1 - sy))
    return F.conv2d(x, w.permute(2, 0, 1)[None])[0, 0]


def _gsedt_1d(f: torch.Tensor, d1: float, d2: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """min over v of d1 * (j - v) + d2 * (j - v)^2 + f[..., v] along the last
    axis: (values, offsets j - argmin), the first minimum, from the dense
    (..., j, v) cost."""
    n = f.shape[-1]
    j = torch.arange(n, dtype=torch.float32, device=f.device)
    d = j[:, None] - j[None, :]                       # (j, v) displacement
    cost = d1 * d + d2 * d * d + f[..., None, :]      # (..., j, v)
    val, idx = torch.min(cost, dim=-1)
    return val, (torch.arange(n, device=f.device) - idx).to(torch.int32)


def _gsedt(f: torch.Tensor, dx: float, dy: float, dxx: float, dyy: float):
    """ccv_distance_transform(CCV_NEGATIVE | CCV_GSEDT) twin: the x pass,
    then the y pass, on -f; (values, x offsets, y offsets), each offset from
    its own pass, as the reference reads them."""
    v1, rx = _gsedt_1d(-f, dx, dxx)
    v2, ry = _gsedt_1d(v1.transpose(-1, -2), dy, dyy)
    return v2.transpose(-1, -2), rx, ry.transpose(-1, -2)


def _anchor(part: DpmPartClassifier, rwh: int, rww: int):
    """(offy, offx, pwh, pww, ph, pw) of a part against its root."""
    ph, pw = part.w.shape[0], part.w.shape[1]
    pwh, pww = (ph - 1) // 2, (pw - 1) // 2
    return part.y + pwh - rwh * 2, part.x + pww - rww * 2, pwh, pww, ph, pw


# the filters of a root on a device, copied once: (root, device) -> (root
# kept alive so that its id is not reused, root filter, part filters)
_FILTERS: dict = {}


def _filters(root: DpmRootClassifier, device: torch.device):
    key = (id(root), str(device))
    if key not in _FILTERS:
        _FILTERS[key] = (root, *(
            torch.as_tensor(w, dtype=torch.float32).to(device)
            for w in [root.w] + [p.w for p in root.parts]))
    return _FILTERS[key][1:]


def _level(root: DpmRootClassifier, hog: torch.Tensor, hog2x: torch.Tensor):
    """One pyramid level for one root (_ccv_dpm_compute_score,
    ccv_dpm.c:76-118): (root score (H, W), and per part stacked: the
    transformed responses, x and y offsets (P, H2, W2))."""
    rr, rc = root.w.shape[0], root.w.shape[1]
    rwh, rww = (rr - 1) // 2, (rc - 1) // 2
    w_root, *w_parts = _filters(root, hog.device)
    score = _corr31(hog, w_root)
    H, W = score.shape
    y_grid = torch.arange(H, device=hog.device)[:, None]
    x_grid = torch.arange(W, device=hog.device)[None, :]
    pfs, dxs, dys = [], [], []
    for part, w in zip(root.parts, w_parts):
        pf, dxm, dym = _gsedt(_corr31(hog2x, w), part.dx, part.dy,
                              part.dxx, part.dyy)
        offy, offx, pwh, pww, ph, pw = _anchor(part, rwh, rww)
        iy = torch.clamp(y_grid * 2 + offy, pwh, pf.shape[0] - ph + pwh)
        ix = torch.clamp(x_grid * 2 + offx, pww, pf.shape[1] - pw + pww)
        score = score - pf[iy, ix]
        pfs.append(pf)
        dxs.append(dxm)
        dys.append(dym)
    if not pfs:
        return score, None, None, None
    return score, torch.stack(pfs), torch.stack(dxs), torch.stack(dys)


# ---------------------------------------------------------------------------
# pyramid + detect
# ---------------------------------------------------------------------------

def _feature_pyramid(a: torch.Tensor, scale_upto: int, interval: int
                     ) -> List[torch.Tensor]:
    """_ccv_dpm_feature_pyramid twin (ccv_dpm.c:45): the image pyramid, then
    HOG; the first ``interval + 1`` levels are 2x-resolution HOG (cells of
    4)."""
    next_ = interval + 1
    scale = 2.0 ** (1.0 / next_)
    n = scale_upto + next_ * 2
    imgs: List[Optional[torch.Tensor]] = [None] * n
    imgs[next_] = a
    H, W = a.shape[0], a.shape[1]
    for i in range(1, interval + 1):
        rows, cols = int(H / scale ** i), int(W / scale ** i)
        imgs[next_ + i] = resample.resample(
            a, rows=rows, cols=cols, rows_scale=rows / H, cols_scale=cols / W,
            interp=resample.INTER_AREA)
    for i in range(next_, scale_upto + next_):
        imgs[i + next_] = resample.sample_down(imgs[i])
    pyr = [classic.hog(imgs[i + next_], sbin=9, size=WINDOW_SIZE // 2)
           for i in range(next_)]
    pyr += [classic.hog(imgs[i], sbin=9, size=WINDOW_SIZE)
            for i in range(next_, n)]
    return pyr


def _scale_upto(H: int, W: int, models: Sequence[DpmMixtureModel],
                interval: int) -> int:
    size_w, size_h = W, H
    for model in models:
        for root in model.roots:
            size_w = min(root.w.shape[1] * WINDOW_SIZE, size_w)
            size_h = min(root.w.shape[0] * WINDOW_SIZE, size_h)
    hr, wr = H // size_h, W // size_w
    if min(hr, wr) < 1:
        return -1
    scale = 2.0 ** (1.0 / (interval + 1))
    return int(math.log(min(hr, wr)) / math.log(scale)) - (interval + 1)


def _root_comps(root: DpmRootClassifier, score: np.ndarray, planes,
                ys, xs, c: int, scale_x: float, scale_y: float
                ) -> List[RootComp]:
    """The passing windows (ys, xs) of one level as RootComps with their
    parts (ccv_dpm.c:2120-2190); ``planes`` are the level's part planes on
    the host."""
    rr, rc = root.w.shape[0], root.w.shape[1]
    rwh, rww = (rr - 1) // 2, (rc - 1) // 2
    out = []
    for y, x in zip(ys.tolist(), xs.tolist()):
        drift_x, drift_y, drift_scale = (float(root.alpha[0]),
                                         float(root.alpha[1]),
                                         float(root.alpha[2]))
        parts = []
        for k, part in enumerate(root.parts):
            pf, dxm, dym = (p[k] for p in planes)
            offy, offx, pwh, pww, ph, pw = _anchor(part, rwh, rww)
            iy = int(np.clip(y * 2 + offy, pwh, pf.shape[0] - ph + pwh))
            ix = int(np.clip(x * 2 + offx, pww, pf.shape[1] - pw + pww))
            ry, rx = int(dym[iy, ix]), int(dxm[iy, ix])
            drift_x += part.alpha[0] * rx + part.alpha[1] * ry
            drift_y += part.alpha[2] * rx + part.alpha[3] * ry
            drift_scale += part.alpha[4] * rx + part.alpha[5] * ry
            parts.append(Comp(
                x=int((ix - rx - pww) * WINDOW_SIZE / 2 * scale_x + 0.5),
                y=int((iy - ry - pwh) * WINDOW_SIZE / 2 * scale_y + 0.5),
                width=int(pw * WINDOW_SIZE / 2 * scale_x + 0.5),
                height=int(ph * WINDOW_SIZE / 2 * scale_y + 0.5),
                confidence=-float(pf[iy, ix]), classification_id=c))
        out.append(RootComp(
            x=int((x + drift_x) * WINDOW_SIZE * scale_x
                  - rww * WINDOW_SIZE * scale_x * (1.0 + drift_scale) + 0.5),
            y=int((y + drift_y) * WINDOW_SIZE * scale_y
                  - rwh * WINDOW_SIZE * scale_y * (1.0 + drift_scale) + 0.5),
            width=int(rc * WINDOW_SIZE * scale_x * (1.0 + drift_scale) + 0.5),
            height=int(rr * WINDOW_SIZE * scale_y * (1.0 + drift_scale)
                       + 0.5),
            confidence=float(score[y, x]) + root.beta,
            classification_id=c + 1, parts=parts))
    return out


def detect(img, models, params: Optional[DpmParams] = None,
           device=None) -> List[RootComp]:
    """ccv_dpm_detect_objects twin (ccv_dpm.c:2045) on ``img``'s device (a
    numpy image goes to ``device``, default the card)."""
    if isinstance(models, DpmMixtureModel):
        models = [models]
    params = params or DpmParams()
    a = as_array(img, device)
    if a.dim() == 2:
        a = a[..., None]
    H, W = int(a.shape[0]), int(a.shape[1])
    scale = 2.0 ** (1.0 / (params.interval + 1))
    next_ = params.interval + 1
    scale_upto = _scale_upto(H, W, models, params.interval)
    if scale_upto < 0:
        return []
    pyr = _feature_pyramid(a, scale_upto, params.interval)
    result: List[RootComp] = []
    for c, model in enumerate(models):
        seq: List[RootComp] = []
        scale_x = scale_y = 1.0
        for i in range(next_, scale_upto + next_ * 2):
            for root in model.roots:
                score, pf, dxm, dym = _level(root, pyr[i], pyr[i - next_])
                rr, rc = root.w.shape[0], root.w.shape[1]
                rwh, rww = (rr - 1) // 2, (rc - 1) // 2
                score_h = score.cpu().numpy()
                ys, xs = np.nonzero(score_h + root.beta > params.threshold)
                sel = ((ys >= rwh) & (ys < score_h.shape[0] - rr // 2)
                       & (xs >= rww) & (xs < score_h.shape[1] - rc // 2))
                ys, xs = ys[sel], xs[sel]
                if len(ys):
                    planes = ((pf.cpu().numpy(), dxm.cpu().numpy(),
                               dym.cpu().numpy()) if pf is not None else ())
                    seq += _root_comps(root, score_h, planes, ys, xs, c,
                                       scale_x, scale_y)
            scale_x *= scale
            scale_y *= scale
        result.extend(_dpm_group(seq, params.min_neighbors))
    return result


def _same_class(r1: RootComp, r2: RootComp) -> bool:
    """_ccv_is_equal_same_class twin (ccv_dpm.c:2028)."""
    distance = int(min(r1.width, r1.height) * 0.25 + 0.5)
    return (r2.classification_id == r1.classification_id
            and r1.x - distance <= r2.x <= r1.x + distance
            and r1.y - distance <= r2.y <= r1.y + distance
            and r2.width <= int(r1.width * 1.5 + 0.5)
            and int(r2.width * 1.5 + 0.5) >= r1.width
            and r2.height <= int(r1.height * 1.5 + 0.5)
            and int(r2.height * 1.5 + 0.5) >= r1.height)


def _inside(r1: RootComp, r2: RootComp) -> bool:
    """r1 lies in r2 grown by a quarter of r2's shorter side, same class."""
    d = int(min(r2.width, r2.height) * 0.25 + 0.5)
    return (r1.classification_id == r2.classification_id
            and r1.x >= r2.x - d and r1.y >= r2.y - d
            and r1.x + r1.width <= r2.x + r2.width + d
            and r1.y + r1.height <= r2.y + r2.height + d)


def _dpm_group(seq: List[RootComp], min_neighbors: int) -> List[RootComp]:
    """The grouping and nested-rectangle filters of ccv_dpm_detect_objects
    (ccv_dpm.c:2195-2276)."""
    if min_neighbors == 0:
        return list(seq)
    if not seq:
        return []
    idx = group(seq, lambda a, b: _same_class(a, b) or _same_class(b, a))
    ngroups = max(idx) + 1
    best: List[Optional[RootComp]] = [None] * ngroups
    counts = [0] * ngroups
    for r, g in zip(seq, idx):
        counts[g] += 1
        if best[g] is None or r.confidence > best[g].confidence:
            best[g] = r
    seq2 = [dataclasses.replace(best[g], neighbors=counts[g])
            for g in range(ngroups) if counts[g] >= min_neighbors]
    # mute large rects that contain a better smaller rect
    muted = [any(i != j and _inside(r1, r2) and r2.confidence <= r1.confidence
                 and r2.neighbors < r1.neighbors
                 for j, r1 in enumerate(seq2))
             for i, r2 in enumerate(seq2)]
    return [r1 for i, r1 in enumerate(seq2) if not muted[i] and not any(
        i != j and _inside(r1, r2) and (r2.confidence > r1.confidence
                                        or r2.neighbors >= r1.neighbors)
        for j, r2 in enumerate(seq2))]
