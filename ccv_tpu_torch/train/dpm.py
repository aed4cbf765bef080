"""DPM mixture-model training, the dpmcreate twin (counterpart of
ccv_tpu/train/dpm.py; reference: lib/ccv_dpm.c ccv_dpm_mixture_model_new
:1575, a latent SVM with hard-negative data mining).

- examples: the warped positives (``_summon_positive``: ``sample_up``, the
  zero-padded slice, INTER_AREA to the root window) and random background
  windows (``_collect_randomly``), their HOG by ``ops.classic.hog``, all on
  ``device`` (default: the card);
- ``_svm_fit``: the root's liblinear initialisation (L2R_L1LOSS_SVC_DUAL,
  ccv_dpm.c:581) as ``ccv_tpu`` replaces it, full-batch subgradient
  descent on the hinge loss with momentum, 400 steps in float32: a torch
  loop on the device, two products a step, the gradient written out (no
  autograd); with the symmetric prior every example's mirror is appended,
  as the reference feeds liblinear (ccv_dpm.c:457-575);
- the parts' energy search (``_initialize_part_classifiers``) over
  ``sample_up`` of the root filter;
- the latent steps (``_collect_best`` / ``_collect_all``, ccv_dpm.c:843 /
  923) through ``detectors.dpm``'s score programs (``_feature_pyramid``,
  ``_level``: the correlations and the generalized distance transform) on
  the device, the windows picked on the host;
- the per-example SGD (``_sgd``, ccv_dpm.c:1120), ``_regularize`` and the
  bookkeeping in numpy on the host, as ``ccv_tpu`` has them: the filters
  are a few thousand floats;
- checkpoint and resume as the reference: ``<dir>/model`` ("," while in
  progress with the declared total, "." when done), ``<dir>/init.model``
  and ``<dir>/gradient_descent_progress``. Both packages read each other's
  files, byte for byte the same.

Every random draw comes from one ``np.random.Generator`` in ``ccv_tpu``'s
order. No kernel of the port's own: ``ccv_tpu``'s trainer is XLA ops and
numpy.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ccv_tpu_torch import device as _device
from ccv_tpu_torch.core.util import slice_
from ccv_tpu_torch.detectors import dpm as dpm_detect
from ccv_tpu_torch.detectors.dpm import (DpmMixtureModel, DpmParams,
                                         DpmPartClassifier, DpmRootClassifier,
                                         WINDOW_SIZE, read_mixture_model)
from ccv_tpu_torch.ops import classic, resample

# channel mirror permutation for horizontally flipped 31-channel HOG
# (_ccv_dpm_sym_lut, ccv_dpm.c:292)
SYM_LUT = np.array(
    [2, 3, 0, 1]
    + [4, 12, 11, 10, 9, 8, 7, 6, 5]
    + [22, 21, 20, 19, 18, 17, 16, 15, 14, 13,
       30, 29, 28, 27, 26, 25, 24, 23],
    dtype=np.int32)

REGQ = 100        # ccv_dpm.c:21
MINI_BATCH = 10   # ccv_dpm.c:22


@dataclasses.dataclass
class DpmTrainParams:
    """ccv_dpm_new_param_t twin with bin/dpmcreate.c:73's defaults."""

    components: int = 1
    parts: int = 8
    min_area: int = 3000
    max_area: int = 5000
    symmetric: bool = True
    alpha: float = 0.01
    balance: float = 1.5
    alpha_ratio: float = 0.995
    iterations: int = 1000
    data_minings: int = 50
    root_relabels: int = 20
    relabels: int = 10
    negative_cache_size: int = 2000
    C: float = 0.002
    percentile_breakdown: float = 0.05
    include_overlap: float = 0.7
    grayscale: bool = False
    discard_estimating_constant: bool = True
    detector: DpmParams = dataclasses.field(
        default_factory=lambda: DpmParams(interval=4, threshold=0.0))
    seed: int = 0


def _mirror(w: np.ndarray) -> np.ndarray:
    """Horizontal flip of a (rows, cols, 31) HOG filter or feature."""
    return w[:, ::-1, :][..., SYM_LUT]


# ---------------------------------------------------------------------------
# model text I/O (_ccv_dpm_write_checkpoint, ccv_dpm.c:169)
# ---------------------------------------------------------------------------

def write_mixture_model(model: DpmMixtureModel, path: str,
                        done: bool = True, total: Optional[int] = None):
    """_ccv_dpm_write_checkpoint twin: the C99-hex text, "." and the count
    when ``done``, else "," and "<total> <count>" (a checkpoint of the
    first roots of ``total``)."""
    n = len(model.roots)
    head = ["." if done else ",",
            f"{n}" if done else f"{total or n} {n}"]
    dpm_detect.write_lines(head + dpm_detect.model_lines(model), path)


def _read_checkpoint(path: str) -> Optional[DpmMixtureModel]:
    """_ccv_dpm_read_checkpoint twin: a finished model, or the roots an
    in-progress checkpoint ("," prefix) holds; None without a file, with
    another prefix or with no root."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        toks = f.read().split()
    if not toks or toks[0] not in (".", ","):
        return None
    if toks[0] == ".":
        return read_mixture_model(path)
    roots, _ = dpm_detect.parse_roots(toks, 3, int(toks[2]))
    return DpmMixtureModel(roots) if roots else None


# ---------------------------------------------------------------------------
# example harvesting
# ---------------------------------------------------------------------------

def _load(img_or_path, grayscale: bool) -> np.ndarray:
    """A path read on the host (gray or RGB), or the array itself."""
    if isinstance(img_or_path, str):
        from ccv_tpu_torch.core.io import IO_GRAY, IO_RGB_COLOR, read
        return read(img_or_path, IO_GRAY if grayscale else IO_RGB_COLOR,
                    device="cpu").numpy()
    return np.asarray(img_or_path)


def _hog_of(img, device: torch.device) -> np.ndarray:
    """HOG (cells of 8) of a host image or a device tensor, on ``device``,
    to the host."""
    a = torch.as_tensor(img).to(device, torch.float32)
    return classic.hog(a, sbin=9, size=WINDOW_SIZE).cpu().numpy()


def _summon_positive(img: np.ndarray, bbox, rows: int, cols: int,
                     device: torch.device) -> Optional[np.ndarray]:
    """_ccv_dpm_summon_examples_by_rectangle twin (ccv_dpm.c:384): centre
    the bbox on the root's aspect, 2x upsample, crop (zero outside the
    image), INTER_AREA to the root window, HOG; None when the box is too
    small to be useful."""
    bx, by, bw, bh = bbox
    mcols = int(math.sqrt(bw * bh * cols / float(rows)) + 0.5)
    mrows = int(math.sqrt(bw * bh * rows / float(cols)) + 0.5)
    bx = bx + (bw - mcols) // 2
    by = by + (bh - mrows) // 2
    if mcols * 2 < cols * WINDOW_SIZE or mrows * 2 < rows * WINDOW_SIZE:
        return None
    a = torch.from_numpy(np.ascontiguousarray(img)).to(device, torch.float32)
    if a.dim() == 2:
        a = a[..., None]
    sl = slice_(resample.sample_up(a), by * 2, bx * 2, mrows * 2, mcols * 2)
    rs = resample.resample(
        sl, rows=rows * WINDOW_SIZE, cols=cols * WINDOW_SIZE,
        rows_scale=rows * WINDOW_SIZE / sl.shape[0],
        cols_scale=cols * WINDOW_SIZE / sl.shape[1],
        interp=resample.INTER_AREA)
    return _hog_of(rs, device)


def _collect_randomly(rng: np.random.Generator, bgimgs, negnum: int,
                      rows: Sequence[int], cols: Sequence[int],
                      grayscale: bool, device: torch.device
                      ) -> List[List[np.ndarray]]:
    """_ccv_dpm_collect_examples_randomly twin (ccv_dpm.c:326): random
    windows of the backgrounds, their HOG for each component."""
    components = len(rows)
    negex: List[List[np.ndarray]] = [[] for _ in range(components)]
    mrows, mcols = max(rows), max(cols)
    guard = 0
    while len(negex[0]) < negnum and guard < 100:
        guard += 1
        p = negnum / max(1, len(bgimgs))
        for src in bgimgs:
            if rng.uniform() >= min(1.0, p):
                continue
            image = _load(src, grayscale)
            if (image.shape[0] < mrows * WINDOW_SIZE
                    or image.shape[1] < mcols * WINDOW_SIZE):
                continue
            y = rng.integers(0, image.shape[0] - mrows * WINDOW_SIZE + 1)
            x = rng.integers(0, image.shape[1] - mcols * WINDOW_SIZE + 1)
            for j in range(components):
                oy = y + ((mrows - rows[j]) * WINDOW_SIZE + 1) // 2
                ox = x + ((mcols - cols[j]) * WINDOW_SIZE + 1) // 2
                sl = image[oy:oy + rows[j] * WINDOW_SIZE,
                           ox:ox + cols[j] * WINDOW_SIZE]
                negex[j].append(_hog_of(np.ascontiguousarray(sl), device))
            if len(negex[0]) >= negnum:
                break
    return negex


# ---------------------------------------------------------------------------
# root initialisation (liblinear's place: hinge-loss descent on the device)
# ---------------------------------------------------------------------------

def _svm_fit(X: torch.Tensor, y: torch.Tensor, C: float, steps: int = 400,
             lr: float = 0.05) -> torch.Tensor:
    """L2-regularised L1-hinge linear SVM by full-batch subgradient descent
    with momentum, ``ccv_tpu``'s stand-in for liblinear
    L2R_L1LOSS_SVC_DUAL (ccv_dpm.c:581), in float32 on ``X``'s device. X
    carries the bias column (regularised too, as liblinear does). The
    objective is the mean hinge plus ||w||^2 / (2 C N)."""
    N = X.shape[0]
    w = torch.zeros(X.shape[1], dtype=torch.float32, device=X.device)
    m = torch.zeros_like(w)
    for _ in range(steps):
        f = X @ w
        g = -(((y * f) < 1.0) * y) @ X / N + w / (C * N)
        m = 0.9 * m + g
        w = w - lr * m
    return w


def _initialize_root_classifier(hog_pos: List[np.ndarray],
                                hog_neg: List[np.ndarray],
                                rows: int, cols: int, C: float,
                                symmetric: bool, device: torch.device,
                                timings: Optional[dict] = None
                                ) -> DpmRootClassifier:
    """_ccv_dpm_initialize_root_classifier twin (ccv_dpm.c:434): a linear
    SVM on the warped examples; with the symmetric prior each example and
    its mirror train, and the filter is made exactly mirror-symmetric.
    ``timings``, if a dict, gets ``svm_fit_ms`` (the fit, synchronised)."""
    feats, labels = [], []
    for h in hog_pos:
        feats.append(h.reshape(-1))
        labels.append(1.0)
        if symmetric:
            feats.append(_mirror(h).reshape(-1))
            labels.append(1.0)
    for h in hog_neg:
        feats.append(h.reshape(-1))
        labels.append(-1.0)
        if symmetric:
            feats.append(_mirror(h).reshape(-1))
            labels.append(-1.0)
    X = np.stack(feats).astype(np.float32)
    X = np.concatenate([X, np.ones((X.shape[0], 1), np.float32)], axis=1)
    y = np.array(labels, np.float32)
    Xd, yd = (_device.to_device(a, device) for a in (X, y))
    t0 = time.perf_counter()
    w = _svm_fit(Xd, yd, C).cpu().numpy()
    if timings is not None:
        timings["svm_fit_ms"] = (time.perf_counter() - t0) * 1e3
        timings["svm_fit_shape"] = list(X.shape)
    wf = w[:-1].reshape(rows, cols, 31)
    beta = float(w[-1])
    if symmetric:
        wf = 0.5 * (wf + _mirror(wf))
    return DpmRootClassifier(beta=beta,
                             alpha=np.zeros(3, np.float32),
                             w=wf.astype(np.float32), parts=[])


# ---------------------------------------------------------------------------
# part initialisation (the energy search, ccv_dpm.c:620)
# ---------------------------------------------------------------------------

def _initialize_part_classifiers(root: DpmRootClassifier, parts: int,
                                 symmetric: bool, device: torch.device):
    """_ccv_dpm_initialize_part_classifiers twin: the parts are the
    highest-energy rectangles of the 2x root filter (``sample_up`` on
    ``device``), each zeroed once taken; with the symmetric prior a part
    off the centre line takes its mirror as its counterpart."""
    w = resample.sample_up(torch.from_numpy(root.w).to(device)).cpu().numpy()
    R, C_ = w.shape[0], w.shape[1]
    area = R * C_ / float(parts)
    out: List[DpmPartClassifier] = []
    i = 0
    while i < parts:
        dx = dy = dw = dh = 0
        sym = 0
        dsum = -1.0
        j = 1
        while j < area + 1 and j * 3 <= R * 2:
            k = int(area / j + 0.5)
            if k < 1 or k * 3 > C_ * 2 or j > k * 2 or k > j * 2:
                j += 1
                continue
            energy = np.abs(w).sum(axis=2)  # recomputed: w is zeroed as we go
            if symmetric:
                if k % 2 == C_ % 2:
                    x = (C_ - k) // 2
                    for y in range(R - j + 1):
                        s = energy[y:y + j, x:x + k].sum() / (j * k)
                        if s > dsum:
                            dsum, dx, dy, dw, dh, sym = s, x, y, k, j, 0
                if i < parts - 1:
                    for y in range(R - j + 1):
                        for x in range(C_ // 2 - k + 1):
                            s = energy[y:y + j, x:x + k].sum() / (j * k)
                            if s > dsum:
                                dsum, dx, dy, dw, dh, sym = s, x, y, k, j, 1
            else:
                for y in range(R - j + 1):
                    for x in range(C_ - k + 1):
                        s = energy[y:y + j, x:x + k].sum() / (j * k)
                        if s > dsum:
                            dsum, dx, dy, dw, dh, sym = s, x, y, k, j, 0
            j += 1
        if dh == 0 or dw == 0:
            # no rectangle meets the aspect and area rules (a tiny root
            # with few parts): a centred square, as ccv_tpu does
            dh = dw = max(1, min(int(math.sqrt(area)), R * 2 // 3,
                                 C_ * 2 // 3))
            dy, dx = (R - dh) // 2, (C_ - dw) // 2
        pw = w[dy:dy + dh, dx:dx + dw].copy()
        w[dy:dy + dh, dx:dx + dw] = 0.0
        out.append(DpmPartClassifier(x=dx, y=dy, z=1, dx=0.0, dy=0.0,
                                     dxx=0.1, dyy=0.1,
                                     alpha=np.zeros(6, np.float32),
                                     w=pw, counterpart=-1))
        i += 1
        if symmetric and sym:
            dx2 = C_ - (dx + dw)
            pw2 = w[dy:dy + dh, dx2:dx2 + dw].copy()
            w[dy:dy + dh, dx2:dx2 + dw] = 0.0
            out[-1].counterpart = i
            out.append(DpmPartClassifier(x=dx2, y=dy, z=1, dx=0.0, dy=0.0,
                                         dxx=0.1, dyy=0.1,
                                         alpha=np.zeros(6, np.float32),
                                         w=pw2, counterpart=i - 1))
            i += 1
    root.parts = out[:parts]


# ---------------------------------------------------------------------------
# latent feature vectors
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FeatureVector:
    """ccv_dpm_feature_vector_t twin (ccv_dpm.c:318)."""

    id: int
    score: float
    x: int
    y: int
    scale_x: float
    scale_y: float
    root_w: np.ndarray                      # (rows, cols, 31)
    part_dx: np.ndarray                     # (P,)
    part_dy: np.ndarray
    part_dxx: np.ndarray
    part_dyy: np.ndarray
    part_w: List[np.ndarray]                # per part (pr, pc, 31)


def _vector_score(model: DpmMixtureModel, v: FeatureVector) -> float:
    """_ccv_dpm_vector_score twin (ccv_dpm.c:763)."""
    root = model.roots[v.id]
    score = root.beta + float(np.vdot(root.w, v.root_w))
    for k, p in enumerate(root.parts):
        score -= (p.dx * v.part_dx[k] + p.dxx * v.part_dxx[k]
                  + p.dy * v.part_dy[k] + p.dyy * v.part_dyy[k])
        score += float(np.vdot(p.w, v.part_w[k]))
    return score


def _extract_vector(root: DpmRootClassifier, rid: int, score: float,
                    x: int, y: int, hog: np.ndarray, hog2x: np.ndarray,
                    dxm: np.ndarray, dym: np.ndarray,
                    scale_x: float, scale_y: float) -> FeatureVector:
    """_ccv_dpm_collect_feature_vector twin (ccv_dpm.c:792): the root's
    HOG window and each part's displaced HOG window (zero outside the
    detail level)."""
    rr, rc = root.w.shape[0], root.w.shape[1]
    rwh, rww = (rr - 1) // 2, (rc - 1) // 2
    rw = np.zeros((rr, rc, 31), np.float32)
    ys, xs = y - rwh, x - rww
    rw[:, :] = hog[ys:ys + rr, xs:xs + rc]
    P = len(root.parts)
    pdx = np.zeros(P, np.float32)
    pdy = np.zeros(P, np.float32)
    pws: List[np.ndarray] = []
    for k, part in enumerate(root.parts):
        ph, pw_ = part.w.shape[0], part.w.shape[1]
        pwh, pww = (ph - 1) // 2, (pw_ - 1) // 2
        offy = part.y + pwh - rwh * 2
        offx = part.x + pww - rww * 2
        iy = int(np.clip(y * 2 + offy, pwh, hog2x.shape[0] - ph + pwh))
        ix = int(np.clip(x * 2 + offx, pww, hog2x.shape[1] - pw_ + pww))
        ry = int(dym[k, iy, ix])
        rx = int(dxm[k, iy, ix])
        pdx[k] = rx
        pdy[k] = ry
        w = np.zeros((ph, pw_, 31), np.float32)
        sy0 = iy - ry - pwh
        sx0 = ix - rx - pww
        ay0, ax0 = max(0, sy0), max(0, sx0)
        ay1 = min(hog2x.shape[0], sy0 + ph)
        ax1 = min(hog2x.shape[1], sx0 + pw_)
        if ay1 > ay0 and ax1 > ax0:
            w[ay0 - sy0:ay1 - sy0, ax0 - sx0:ax1 - sx0] = \
                hog2x[ay0:ay1, ax0:ax1]
        pws.append(w)
    return FeatureVector(id=rid, score=score, x=x, y=y,
                         scale_x=scale_x, scale_y=scale_y, root_w=rw,
                         part_dx=pdx, part_dy=pdy,
                         part_dxx=pdx * pdx, part_dyy=pdy * pdy,
                         part_w=pws)


def _pyramid_for(img: np.ndarray, model: DpmMixtureModel, interval: int,
                 device: torch.device):
    """(the HOG pyramid on ``device``, scale_upto), or (None, -1) where the
    image is smaller than the model's smallest root window."""
    H, W = img.shape[0], img.shape[1]
    scale_upto = dpm_detect._scale_upto(H, W, [model], interval)
    if scale_upto < 0:
        return None, -1
    a = torch.from_numpy(np.ascontiguousarray(img)).to(device, torch.float32)
    if a.dim() == 2:
        a = a[..., None]
    return dpm_detect._feature_pyramid(a, scale_upto, interval), scale_upto


def _level_host(root: DpmRootClassifier, pyr, j: int, next_: int):
    """One level's root score, HOG, detail HOG and part offsets on the
    host (``detectors.dpm._level`` on the pyramid's device)."""
    score, _, dxm, dym = dpm_detect._level(root, pyr[j], pyr[j - next_])
    return (score.cpu().numpy(), pyr[j].cpu().numpy(),
            pyr[j - next_].cpu().numpy(), dxm.cpu().numpy(),
            dym.cpu().numpy())


def _collect_best(img: np.ndarray, model: DpmMixtureModel, bbox,
                  overlap: float, params: DpmParams,
                  device: _device.DeviceLike = None
                  ) -> Optional[FeatureVector]:
    """_ccv_dpm_collect_best twin (ccv_dpm.c:843): the best-scoring window
    that overlaps the ground-truth box enough (the latent step), scored on
    ``device`` (default: the card)."""
    dev = _device.resolve(device)
    interval = params.interval
    next_ = interval + 1
    scale = 2.0 ** (1.0 / next_)
    pyr, scale_upto = _pyramid_for(img, model, interval, dev)
    if scale_upto < 0:
        return None
    bx, by, bw, bh = bbox
    best = -np.inf
    out: Optional[FeatureVector] = None
    for i, root in enumerate(model.roots):
        scale_x = scale_y = 1.0
        rr, rc = root.w.shape[0], root.w.shape[1]
        rwh, rww = (rr - 1) // 2, (rc - 1) // 2
        rwh_1, rww_1 = rr // 2, rc // 2
        for j in range(next_, scale_upto + next_ * 2):
            size_w = int(rc * WINDOW_SIZE * scale_x + 0.5)
            size_h = int(rr * WINDOW_SIZE * scale_y + 0.5)
            if (min(size_w * size_h, bw * bh)
                    / max(bw * bh, size_w * size_h) < overlap):
                scale_x *= scale
                scale_y *= scale
                continue
            score_h, hog, hog2x, dxm, dym = _level_host(root, pyr, j, next_)
            for y in range(rwh, score_h.shape[0] - rwh_1):
                for x in range(rww, score_h.shape[1] - rww_1):
                    rx0 = int((x - rww) * WINDOW_SIZE * scale_x + 0.5)
                    ry0 = int((y - rwh) * WINDOW_SIZE * scale_y + 0.5)
                    inter = (max(0, min(rx0 + size_w, bx + bw) - max(rx0, bx))
                             * max(0, min(ry0 + size_h, by + bh)
                                   - max(ry0, by)))
                    if (inter / max(size_w * size_h, bw * bh) >= overlap
                            and score_h[y, x] > best):
                        out = _extract_vector(
                            root, i, float(score_h[y, x]) + root.beta,
                            x, y, hog, hog2x, dxm, dym, scale_x, scale_y)
                        best = score_h[y, x]
            scale_x *= scale
            scale_y *= scale
    return out


def _collect_all(rng: np.random.Generator, img: np.ndarray,
                 model: DpmMixtureModel, params: DpmParams,
                 threshold: float, enough: int = 64,
                 device: _device.DeviceLike = None) -> List[FeatureVector]:
    """_ccv_dpm_collect_all twin (ccv_dpm.c:923): every window scoring
    above ``threshold``, capped at ``enough`` (the hard-negative mining
    step), scored on ``device`` (default: the card)."""
    dev = _device.resolve(device)
    interval = params.interval
    next_ = interval + 1
    scale = 2.0 ** (1.0 / next_)
    pyr, scale_upto = _pyramid_for(img, model, interval, dev)
    if scale_upto < 0:
        return []
    av: List[FeatureVector] = []
    per = max(1, enough // model.count)
    order = rng.permutation(model.count)
    for oi, i in enumerate(order):
        root = model.roots[i]
        scale_x = scale_y = 1.0
        rr, rc = root.w.shape[0], root.w.shape[1]
        rwh, rww = (rr - 1) // 2, (rc - 1) // 2
        rwh_1, rww_1 = rr // 2, rc // 2
        cap = per * (oi + 1)
        for j in range(next_, scale_upto + next_ * 2):
            if len(av) >= cap:
                break
            score, _, dxm_d, dym_d = dpm_detect._level(root, pyr[j],
                                                       pyr[j - next_])
            score_h = score.cpu().numpy()
            ys, xs = np.nonzero(score_h + root.beta > threshold)
            sel = ((ys >= rwh) & (ys < score_h.shape[0] - rwh_1)
                   & (xs >= rww) & (xs < score_h.shape[1] - rww_1))
            ys, xs = ys[sel], xs[sel]
            if len(ys):
                hog = pyr[j].cpu().numpy()
                hog2x = pyr[j - next_].cpu().numpy()
                dxm = dxm_d.cpu().numpy()
                dym = dym_d.cpu().numpy()
                for y, x in zip(ys.tolist(), xs.tolist()):
                    av.append(_extract_vector(
                        root, int(i), float(score_h[y, x]) + root.beta,
                        x, y, hog, hog2x, dxm, dym, scale_x, scale_y))
                    if len(av) >= cap:
                        break
            scale_x *= scale
            scale_y *= scale
    return av


# ---------------------------------------------------------------------------
# SGD on the latent-SVM objective (the reference's update rule, on the host)
# ---------------------------------------------------------------------------

def _sgd(model: DpmMixtureModel, v: FeatureVector, y: float, alpha: float,
         Cn: float, symmetric: bool):
    """_ccv_dpm_stochastic_gradient_descent twin (ccv_dpm.c:1120)."""
    root = model.roots[v.id]
    s = alpha * y * Cn
    if symmetric:
        root.w += s * (v.root_w + _mirror(v.root_w))
        root.beta += s * 2.0
    else:
        root.w += s * v.root_w
        root.beta += s
    for k, p in enumerate(root.parts):
        p.dx -= s * float(v.part_dx[k])
        p.dxx = max(p.dxx - s * float(v.part_dxx[k]), 0.01)
        p.dy -= s * float(v.part_dy[k])
        p.dyy = max(p.dyy - s * float(v.part_dyy[k]), 0.01)
        if not symmetric:
            p.w += s * v.part_w[k]
        else:
            if p.counterpart == -1:
                # self-symmetric part: converge 2x, dx flips sign
                p.dx += s * float(v.part_dx[k])
                p.dxx = max(p.dxx - s * float(v.part_dxx[k]), 0.01)
                p.dy -= s * float(v.part_dy[k])
                p.dyy = max(p.dyy - s * float(v.part_dyy[k]), 0.01)
                p.w += s * (v.part_w[k] + _mirror(v.part_w[k]))
            else:
                other = root.parts[p.counterpart]
                other.dx += s * float(v.part_dx[k])
                other.dxx = max(other.dxx - s * float(v.part_dxx[k]), 0.01)
                other.dy -= s * float(v.part_dy[k])
                other.dyy = max(other.dyy - s * float(v.part_dyy[k]), 0.01)
                p.w += s * v.part_w[k]
                other.w += s * _mirror(v.part_w[k])


def _regularize(model: DpmMixtureModel, i: int, regz: float):
    """_ccv_dpm_regularize_mixture_model twin (ccv_dpm.c:1092)."""
    root = model.roots[i]
    root.w *= (1.0 - regz)
    root.beta *= (1.0 - regz)
    for p in root.parts:
        p.w *= (1.0 - regz)
        p.dx -= regz * p.dx
        p.dy -= regz * p.dy
        p.dxx = max(p.dxx - regz * p.dxx, 0.01)
        p.dyy = max(p.dyy - regz * p.dyy, 0.01)


def _adjust_model_constant(model: DpmMixtureModel, k: int,
                           posv: List[Optional[FeatureVector]],
                           percentile: float):
    """_ccv_dpm_adjust_model_constant twin (ccv_dpm.c:1365)."""
    scores = sorted(_vector_score(model, v) for v in posv
                    if v is not None and v.id == k)
    if not scores:
        return
    adjust = scores[int(np.clip(int(percentile * len(scores)),
                                0, len(scores) - 1))]
    model.roots[k].beta -= adjust


def _model_copy(model: DpmMixtureModel) -> DpmMixtureModel:
    return DpmMixtureModel([
        DpmRootClassifier(
            beta=r.beta, alpha=r.alpha.copy(), w=r.w.copy(),
            parts=[dataclasses.replace(p, alpha=p.alpha.copy(),
                                       w=p.w.copy()) for p in r.parts])
        for r in model.roots])


def _estimate_root_rectangles(model: DpmMixtureModel, posimgs, bboxes,
                              params: DpmTrainParams, device: torch.device):
    """_ccv_dpm_initialize_root_rectangle_estimator twin (ccv_dpm.c:1017):
    the least-squares fit of the x / y / scale drift from the parts'
    displacements."""
    vs: List[Optional[FeatureVector]] = []
    for img, bbox in zip(posimgs, bboxes):
        vs.append(_collect_best(_load(img, params.grayscale), model, bbox,
                                params.include_overlap, params.detector,
                                device))
    for i, root in enumerate(model.roots):
        rows_x, ys = [], [[], [], []]
        for v, bbox in zip(vs, bboxes):
            if v is None or v.id != i:
                continue
            rows_x.append(np.concatenate(
                [[1.0], np.stack([v.part_dx, v.part_dy], -1).reshape(-1)]))
            bx, by, bw, bh = bbox
            ys[0].append((bx + bw * 0.5) / (v.scale_x * WINDOW_SIZE) - v.x)
            ys[1].append((by + bh * 0.5) / (v.scale_y * WINDOW_SIZE) - v.y)
            ys[2].append(math.sqrt(
                (bw * bh) / (root.w.shape[0] * v.scale_x * WINDOW_SIZE
                             * root.w.shape[1] * v.scale_y * WINDOW_SIZE))
                - 1.0)
        if len(rows_x) < 2:
            continue
        X = np.stack(rows_x)
        for j in range(3):
            z, *_ = np.linalg.lstsq(X, np.array(ys[j]), rcond=None)
            root.alpha[j] = (0.0 if params.discard_estimating_constant
                             else z[0])
            for k, p in enumerate(root.parts):
                p.alpha[j * 2] = z[k * 2 + 1]
                p.alpha[j * 2 + 1] = z[k * 2 + 2]


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

def _components(bboxes, params: DpmTrainParams):
    """The aspect-ratio clustering into components (ccv_dpm.c:1602-1640):
    (each positive's component, the roots' rows, their cols)."""
    posnum = len(bboxes)
    aspects = np.array([bw / float(bh) for _, _, bw, bh in bboxes])
    order = np.argsort(aspects, kind="stable")
    mnum = []
    outnum = posnum
    for i in range(params.components):
        mnum.append(int(outnum / (params.components - i) + 0.5))
        outnum -= mnum[-1]
    areas = np.sort([bw * bh for _, _, bw, bh in bboxes])
    area = int(np.clip(areas[int(posnum * 0.2 + 0.5)]
                       if posnum > 1 else areas[0],
                       params.min_area, params.max_area))
    poslabels = np.zeros(posnum, np.int32)
    rows, cols = [], []
    innum = 0
    for i in range(params.components):
        sel = order[innum:innum + mnum[i]]
        poslabels[sel] = i
        aspect = float(aspects[sel].mean())
        cols.append(max(int(math.sqrt(area / aspect) * aspect
                            / WINDOW_SIZE + 0.5), 1))
        rows.append(max(int(math.sqrt(area / aspect) / WINDOW_SIZE + 0.5), 1))
        innum += mnum[i]
    return poslabels, rows, cols


def mixture_model_new(posimgs, bboxes, bgimgs, negnum: int, dir: str,
                      params: Optional[DpmTrainParams] = None,
                      log=print, device: _device.DeviceLike = None,
                      timings: Optional[dict] = None) -> DpmMixtureModel:
    """ccv_dpm_mixture_model_new twin (ccv_dpm.c:1575) on ``device``
    (default: the card).

    posimgs / bgimgs: file paths or numpy images; bboxes: (x, y, w, h) a
    positive. Writes checkpoints under ``dir`` (and resumes from them) and
    returns the final model, also written as ``<dir>/model`` with the "."
    marker. ``timings``, if a dict, gets ``init_s``, ``svm_fit_ms`` (each
    component's fit), and for each relabel its latent pass's seconds
    (``relabel_s``) and for each data mining its seconds (``mining_s``),
    of which the negatives' collection (``collect_s``) and the SGD
    (``sgd_s``)."""
    params = params or DpmTrainParams()
    dev = _device.resolve(device)
    rng = np.random.default_rng(params.seed)
    os.makedirs(dir, exist_ok=True)
    checkpoint = os.path.join(dir, "model")
    initcheckpoint = os.path.join(dir, "init.model")
    progress = os.path.join(dir, "gradient_descent_progress")
    posnum = len(posimgs)
    clock = {"init_s": 0.0, "svm_fit_ms": [], "relabel_s": [],
             "mining_s": [], "collect_s": [], "sgd_s": []}
    poslabels, rows, cols = _components(bboxes, params)

    t_init = time.perf_counter()
    model = _read_checkpoint(checkpoint)
    if model is None or len(model.roots) < params.components:
        log(f"dpm: initializing {params.components} root(s) at "
            + ", ".join(f"{c}x{r}" for r, c in zip(rows, cols)))
        posex = [[] for _ in range(params.components)]
        for idx in range(posnum):
            i = int(poslabels[idx])
            h = _summon_positive(_load(posimgs[idx], params.grayscale),
                                 bboxes[idx], rows[i], cols[i], dev)
            if h is not None:
                posex[i].append(h)
        negex = _collect_randomly(rng, bgimgs, negnum, rows, cols,
                                  params.grayscale, dev)
        neglabels = rng.integers(0, params.components, len(negex[0]))
        roots = []
        for i in range(params.components):
            neg_i = [h for h, l in zip(negex[i], neglabels) if l == i]
            fit = {}
            roots.append(_initialize_root_classifier(
                posex[i], neg_i, rows[i], cols[i], params.C,
                params.symmetric, dev, fit))
            clock["svm_fit_ms"].append(fit["svm_fit_ms"])
        model = DpmMixtureModel(roots)
        write_mixture_model(model, checkpoint, done=False,
                            total=params.components)
    else:
        log("dpm: resuming root mixture model from checkpoint")

    for i, root in enumerate(model.roots):
        if not root.parts:
            log(f"dpm: initializing part filters for model {i + 1}")
            _initialize_part_classifiers(root, params.parts,
                                         params.symmetric, dev)
    write_mixture_model(model, checkpoint, done=False,
                        total=params.components)
    write_mixture_model(model, initcheckpoint, done=False,
                        total=params.components)
    clock["init_s"] = time.perf_counter() - t_init

    # latent SVM with data mining (ccv_dpm.c:1760-1980)
    c0 = d0 = 0
    if os.path.exists(progress):
        try:
            with open(progress) as f:
                c0, d0 = map(int, f.read().split())
        except ValueError:   # a damaged progress file: start over
            c0 = d0 = 0
    negv: List[FeatureVector] = []
    detector = dataclasses.replace(params.detector, threshold=0.0)
    for c in range(c0, params.relabels):
        t_relabel = time.perf_counter()
        regz_rate = params.C
        posv: List[Optional[FeatureVector]] = []
        for img, bbox in zip(posimgs, bboxes):
            posv.append(_collect_best(
                _load(img, params.grayscale), model, bbox,
                params.include_overlap, detector, dev))
        clock["relabel_s"].append(time.perf_counter() - t_relabel)
        posvnum = np.zeros(model.count, np.int32)
        for v in posv:
            if v is not None:
                posvnum[v.id] += 1
        log(f"dpm: relabel {c + 1}/{params.relabels}, positives per "
            f"component: {posvnum.tolist()}")
        d = d0
        d0 = 0
        while d < params.data_minings:
            t_mining = time.perf_counter()
            with open(progress, "w") as f:
                f.write(f"{c} {d}\n")
            alpha = params.alpha
            # recycle still-violating negatives, then mine more
            negv = [v for v in negv if _vector_score(model, v) >= -1]
            if len(negv) < params.negative_cache_size:
                for src in rng.permutation(len(bgimgs)):
                    negv.extend(_collect_all(
                        rng, _load(bgimgs[src], params.grayscale), model,
                        detector, threshold=0.0, device=dev))
                    if len(negv) >= params.negative_cache_size:
                        break
            clock["collect_s"].append(time.perf_counter() - t_mining)
            negvnum = np.zeros(model.count, np.int32)
            for v in negv:
                negvnum[v.id] += 1
            min_per = max(params.negative_cache_size // (model.count * 3),
                          2)
            if len(negv) <= max(params.negative_cache_size // 2, 2):
                for i in range(model.count):
                    _adjust_model_constant(model, i, posv,
                                           params.percentile_breakdown)
                clock["sgd_s"].append(0.0)
                clock["mining_s"].append(time.perf_counter() - t_mining)
                d += 1
                continue
            t_sgd = time.perf_counter()
            prev_pl = prev_nl = 0.0
            for t in range(params.iterations):
                for p in range(model.count):
                    if (negvnum[p] <= min_per or posvnum[p] < 1):
                        continue
                    pos_w = math.sqrt(negvnum[p] / posvnum[p]
                                      * params.balance)
                    neg_w = math.sqrt(posvnum[p] / negvnum[p]
                                      / params.balance)
                    _model = _model_copy(model)
                    idx = rng.permutation(posnum + len(negv))
                    l = 0
                    for k in idx:
                        if k < posnum:
                            v = posv[k]
                            if v is None or v.id != p:
                                continue
                            if _vector_score(model, v) <= 1:
                                _sgd(_model, v, 1, alpha * pos_w,
                                     regz_rate, params.symmetric)
                        else:
                            v = negv[k - posnum]
                            if v.id != p:
                                continue
                            if _vector_score(model, v) >= -1:
                                _sgd(_model, v, -1, alpha * neg_w,
                                     regz_rate, params.symmetric)
                        l += 1
                        if l % REGQ == REGQ - 1:
                            _regularize(_model, p, 1.0 - (
                                1.0 - alpha / ((posvnum[p] + negvnum[p])
                                               * (2 if params.symmetric
                                                  else 1))) ** REGQ)
                        if l % MINI_BATCH == MINI_BATCH - 1:
                            model = _model
                            _model = _model_copy(model)
                    _regularize(_model, p, 1.0 - (
                        1.0 - alpha / ((posvnum[p] + negvnum[p])
                                       * (2 if params.symmetric else 1)))
                        ** ((((posvnum[p] + negvnum[p]) % REGQ) + 1)
                            % (REGQ + 1)))
                    model = _model
                # loss bookkeeping and the convergence abort
                # (ccv_dpm.c:1906)
                pos_scores = [_vector_score(model, v) for v in posv
                              if v is not None]
                neg_scores = [_vector_score(model, v) for v in negv]
                pl = (sum(max(0.0, 1.0 - s) for s in pos_scores)
                      / max(1, len(pos_scores)))
                nl = (sum(max(0.0, 1.0 + s) for s in neg_scores)
                      / max(1, len(neg_scores)))
                if (abs(prev_pl - pl) < 1e-5 and abs(prev_nl - nl) < 1e-5):
                    break
                prev_pl, prev_nl = pl, nl
                alpha *= params.alpha_ratio
            clock["sgd_s"].append(time.perf_counter() - t_sgd)
            write_mixture_model(model, checkpoint, done=False,
                                total=params.components)
            log(f"dpm: data mining {d + 1}/{params.data_minings} "
                f"(relabel {c + 1}) loss+ {prev_pl:.4f} loss- {prev_nl:.4f}"
                f" negatives {len(negv)}")
            clock["mining_s"].append(time.perf_counter() - t_mining)
            d += 1

    _estimate_root_rectangles(model, posimgs, bboxes, params, dev)
    write_mixture_model(model, checkpoint, done=True)
    if os.path.exists(progress):
        os.remove(progress)
    log("dpm: done")
    if timings is not None:
        timings.update(clock)
    return model
