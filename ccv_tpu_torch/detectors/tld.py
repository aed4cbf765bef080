"""TLD, the track-learn-detect long-term tracker (counterpart of
ccv_tpu/detectors/tld.py; reference: lib/ccv_tld.c).

A short-term median-flow tracker (pyramidal LK with forward-backward
verification), a random-ferns detector over a sliding box grid, a
nearest-neighbour (NCC) confirmation classifier over kept patches, and the
online learning that keeps both up to date.

Where the work is on images, it runs on the frames' device as torch ops:
the Gaussian blur of each frame, ``ops.classic.optical_flow_lucas_kanade``
and the ``ops.transform.decimal_slice`` patches of the short-term track,
the perspective warps of the deformed training patches
(``ops.transform.perspective_transform``) and the INTER_AREA | INTER_CUBIC
resample of the grid boxes to the patch size. The host math stays numpy as
in ccv_tpu: the box grid, the integral images and box variances, the
ferns' comparisons over every grid box at once, the NCC matmuls, the
medians and the clustering. The blurred frame is copied to the host once
per frame for the ferns.

The reference seeds its SFMT generators from heap pointers
(ccv_tld.c:685, 703), so it is not reproducible run to run; ccv_tpu draws
from a seeded ``np.random.default_rng``, and the port calls it in
ccv_tpu's order, so that one seed gives the same track in both.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ccv_tpu_torch.core.dense_matrix import as_array
from ccv_tpu_torch.detectors import ferns as ferns_mod
from ccv_tpu_torch.detectors.common import Comp, group
from ccv_tpu_torch.ops import basic, classic, resample, transform

GRID_SPARSITY = 10  # TLD_GRID_SPARSITY
PATCH_SIZE = 10     # TLD_PATCH_SIZE
# comparison pixels gathered at once by the ferns features of many boxes
GATHER_ELEMENTS = 1 << 24


@dataclasses.dataclass
class TldParams:
    """ccv_tld_default_params twin (ccv_tld.c:6)."""

    win_size: Tuple[int, int] = (15, 15)
    level: int = 5
    min_forward_backward_error: float = 100.0
    min_eigen: float = 0.025
    min_win: int = 20
    interval: int = 3
    shift: float = 0.1
    top_n: int = 100
    rotation: int = 0
    include_overlap: float = 0.7
    exclude_overlap: float = 0.2
    structs: int = 40
    features: int = 18
    validate_set: float = 0.5
    nnc_same: float = 0.95
    nnc_thres: float = 0.65
    nnc_verify: float = 0.7
    nnc_beyond: float = 0.8
    nnc_collect: float = 0.5
    bad_patches: int = 100
    new_deform: int = 20
    track_deform: int = 10
    new_deform_angle: float = 20.0
    track_deform_angle: float = 10.0
    new_deform_scale: float = 0.02
    track_deform_scale: float = 0.02
    new_deform_shift: float = 0.02
    track_deform_shift: float = 0.02


@dataclasses.dataclass
class TldInfo:
    """ccv_tld_info_t twin."""

    perform_track: int = 0
    perform_learn: int = 0
    track_success: int = 0
    ferns_detects: int = 0
    nnc_detects: int = 0
    clustered_detects: int = 0
    confident_matches: int = 0
    close_matches: int = 0


def _rect_intersect(r1, r2) -> float:
    """_ccv_tld_rect_intersect twin: IoU."""
    ix = max(0, min(r1[0] + r1[2], r2[0] + r2[2]) - max(r1[0], r2[0]))
    iy = max(0, min(r1[1] + r1[3], r2[1] + r2[3]) - max(r1[1], r2[1]))
    inter = ix * iy
    union = r1[2] * r1[3] + r2[2] * r2[3] - inter
    return inter / union if union > 0 else 0.0


def _grid_overlaps(grid: np.ndarray, box) -> np.ndarray:
    """_rect_intersect of every grid box with ``box``, vectorised (integer
    areas, one float64 division each, as the scalar twin)."""
    g = grid[:, :4].astype(np.int64)
    x, y, w, h = (int(v) for v in box[:4])
    ix = np.maximum(0, np.minimum(g[:, 0] + g[:, 2], x + w)
                    - np.maximum(g[:, 0], x))
    iy = np.maximum(0, np.minimum(g[:, 1] + g[:, 3], y + h)
                    - np.maximum(g[:, 1], y))
    inter = ix * iy
    union = g[:, 2] * g[:, 3] + w * h - inter
    return np.where(union > 0, inter / np.maximum(union, 1), 0.0)


def _median(v) -> float:
    """CCV_IMPLEMENT_MEDIAN twin: element at index (len-1)//2 of the sorted
    order (quickselect semantics, lower middle on even sizes)."""
    v = np.sort(np.asarray(v))
    return float(v[(len(v) - 1) // 2])


def _ncc(a: np.ndarray, b: np.ndarray) -> float:
    """_ccv_tld_norm_cross_correlate twin on two uint8 patches."""
    a = a.astype(np.float64).ravel()
    b = b.astype(np.float64).ravel()
    a = a - a.mean()
    b = b - b.mean()
    den = math.sqrt((a * a).sum() * (b * b).sum())
    return float((a * b).sum() / den) if den > 0 else 0.0


def _grid_boxes(image_size, input_size, interval: int, shift: float):
    """for_each_box twin (ccv_tld.c:250): (x, y, w, h, scale_id) int arrays,
    enumerated in the same order."""
    iw, ih = image_size
    bw, bh = input_size
    scale = 2.0 ** (1.0 / (interval + 1))
    scale_upto = int(math.log(min(iw / bw, ih / bh)) / math.log(scale))
    boxes = []
    ss = 1.0
    for s in range(scale_upto):
        w = int(bw * ss + 0.5)
        h = int(bh * ss + 0.5)
        ss *= scale
        if w > iw or h > ih:
            break
        min_side = min(w, h)
        piy = -1
        y = 0.0
        while y < ih - h - 0.5:
            iy = int(y + 0.5)
            y += shift * min_side
            if iy == piy:
                continue
            piy = iy
            pix = -1
            x = 0.0
            while x < iw - w - 0.5:
                ix = int(x + 0.5)
                x += shift * min_side
                if ix == pix:
                    continue
                pix = ix
                boxes.append((ix, iy, w, h, s))
    return np.array(boxes, np.int32).reshape(-1, 5)


def _scales_for(image_size, input_size, interval: int):
    """for_each_size twin: the (w, h) per scale id."""
    iw, ih = image_size
    bw, bh = input_size
    scale = 2.0 ** (1.0 / (interval + 1))
    scale_upto = int(math.log(min(iw / bw, ih / bh)) / math.log(scale))
    out = []
    ss = 1.0
    for _ in range(scale_upto):
        w = int(bw * ss + 0.5)
        h = int(bh * ss + 0.5)
        ss *= scale
        if w > iw or h > ih:
            break
        out.append((w, h))
    return out


def _gray(a, device) -> torch.Tensor:
    a = as_array(a, device)
    return a[..., 0] if a.dim() == 3 else a


class Tld:
    """ccv_tld_t twin. Construct with ccv_tld_new semantics (ccv_tld.c:599)
    from the first frame (uint8 gray, a tensor or a host array, which goes
    to ``device``, default the card); call track_object per frame pair."""

    def __init__(self, a, box, params: Optional[TldParams] = None, seed=0,
                 device=None):
        params = params or TldParams()
        self.params = params
        a = _gray(a, device)
        self.device = a.device
        self.rng = np.random.default_rng(seed)
        x, y, w, h = box
        self.patch = (int(math.sqrt(params.min_win ** 2 * w / h) + 0.5),
                      int(math.sqrt(params.min_win ** 2 * h / w) + 0.5))
        self.box = (int(x), int(y), int(w), int(h))
        self.confidence = 1.0
        H, W = a.shape
        self.grid = _grid_boxes((W, H), self.patch, params.interval,
                                params.shift)
        scales = _scales_for((W, H), self.patch, params.interval)
        self.ferns = ferns_mod.ferns_new(params.structs, params.features,
                                         scales, seed=seed)
        self.sv: List[List[np.ndarray]] = [[], []]  # [negative, positive]
        self.found = True
        self.verified = True
        self.count = 0
        self.top: List[Comp] = []

        good, bad, best_box = self._generate_box_for(self.box, 20)
        ga = basic.blur(a, 1.5)
        sat, sqsat = self._sats(a.cpu().numpy())
        b = self._fetch_patch(ga, best_box[:4])
        self.var_thres = float(np.var(b.astype(np.float64)))  * 0.5
        self.sv[1].append(b)
        self.nnc_verify_thres = params.nnc_verify

        bad = bad[self._shuffled(len(bad))]
        badex = (len(bad) + 1) // 2
        # inflate good for deformations (ccv_tld.c:705-712)
        goods = list(good) * (params.new_deform + 1)
        order = np.arange(badex + len(goods))
        self.rng.shuffle(order)
        fern_feats = self._batch_ferns_features(ga, bad)
        ok = self._batch_variances(sat, sqsat, bad) > self.var_thres * 0.5
        self._train(ga, order, fern_feats[:badex], ok[:badex], goods,
                    (params.new_deform_angle, params.new_deform_scale,
                     params.new_deform_shift), self.ferns.threshold, 2)
        # detection threshold from the remaining bad boxes (ccv_tld.c:558)
        rest = np.nonzero(ok[badex:])[0] + badex
        self.ferns_thres = max([self.ferns.threshold] + ferns_mod.
                               ferns_predict_many(self.ferns,
                                                  fern_feats[rest]).tolist())
        # train the nearest-neighbor classifier (ccv_tld.c:692-700)
        first = np.nonzero(ok)[0][:params.bad_patches]
        for p in self._fetch_patches(ga, bad[first]):
            self._sv_correct(p, 0)
        # nnc threshold from 1/10 of remaining bad (ccv_tld.c:576): one
        # draw per box that passes the variance test, in order, as
        # ccv_tpu's short-circuit draws them; one fetch and one NCC matmul
        self.nnc_thres = params.nnc_thres
        sample = rest[self.rng.random(len(rest)) <= 0.1]
        if len(sample):
            patches = self._fetch_patches(ga, bad[sample])
            confs = self._sv_classify_batch(patches)[0]
            self.nnc_thres = max(self.nnc_thres, float(confs.max()))
        self.nnc_thres = min(self.nnc_thres, params.nnc_beyond)

    # -- building blocks ---------------------------------------------------

    def _sats(self, a: np.ndarray):
        a64 = a.astype(np.int64)
        sat = np.cumsum(np.cumsum(a64, 0), 1)
        sqsat = np.cumsum(np.cumsum(a64 * a64, 0), 1)
        return sat, sqsat

    def _batch_variances(self, sat, sqsat, boxes) -> np.ndarray:
        """_ccv_tld_box_variance twin for every box at once."""
        if len(boxes) == 0:
            return np.zeros(0)
        b = np.asarray(boxes, np.int64)
        x0, y0 = b[:, 0] - 1, b[:, 1] - 1
        x1 = b[:, 0] + b[:, 2] - 1
        y1 = b[:, 1] + b[:, 3] - 1

        def read(s, ys, xs):
            v = np.zeros(len(b), np.float64)
            m = (ys >= 0) & (xs >= 0)
            v[m] = s[ys[m], xs[m]]
            return v

        area = (b[:, 2] * b[:, 3]).astype(np.float64)
        mean = (read(sat, y1, x1) - read(sat, y0, x1)
                - read(sat, y1, x0) + read(sat, y0, x0)) / area
        var = (read(sqsat, y1, x1) - read(sqsat, y0, x1)
               - read(sqsat, y1, x0) + read(sqsat, y0, x0)) / area
        return var - mean * mean

    def _batch_ferns_features(self, ga: torch.Tensor, boxes) -> np.ndarray:
        """Ferns features of every box at once on the blurred frame's
        device: per scale, one gather of all (box, struct, feature, 2)
        comparison pixels off the frame edge-padded by the points' reach
        (box origins and points are >= 0, so this is ccv_tpu's clamp), the
        comparisons packed into leaf indices with integer shifts (exact).
        Returns (boxes, structs) uint32 on the host."""
        n = len(boxes)
        out = np.zeros((n, self.ferns.structs), np.uint32)
        if n == 0:
            return out
        b = np.asarray(boxes, np.int64)
        pts_all = self.ferns.points
        dev = ga.device
        gap = F.pad(ga[None, None].to(torch.float32),
                    (0, int(pts_all[..., 0].max()), 0,
                     int(pts_all[..., 1].max())), mode="replicate")[0, 0]
        flat = gap.to(torch.uint8).reshape(-1)
        Wp = gap.shape[1]
        shifts = torch.arange(self.ferns.features - 1, -1, -1, device=dev)
        feats, order = [], []
        for s in range(self.ferns.scales):
            sel = np.nonzero(b[:, 4] == s)[0]
            if len(sel) == 0:
                continue
            pl = torch.as_tensor(pts_all[s, ..., 1].astype(np.int64) * Wp
                                 + pts_all[s, ..., 0], device=dev)
            base = torch.as_tensor(b[sel, 1] * Wp + b[sel, 0], device=dev)
            step = max(1, GATHER_ELEMENTS // pl.numel())
            for c in range(0, len(sel), step):
                v = flat[base[c:c + step, None, None, None] + pl[None]]
                bits = (v[..., 0] > v[..., 1]).to(torch.int64)  # (n, S, F)
                feats.append(torch.sum(bits << shifts, dim=-1).to(torch.int32))
            order.append(sel)
        out[np.concatenate(order)] = torch.cat(feats).cpu().numpy()
        return out

    def _shuffled(self, n: int) -> np.ndarray:
        """The permutation ``self.rng.shuffle`` gives a list of n items (the
        same draws, the generator left in the same state)."""
        perm = np.arange(n)
        self.rng.shuffle(perm)
        return perm

    def _train(self, ga: torch.Tensor, order: np.ndarray, feats: np.ndarray,
               ok: np.ndarray, goods, deform, good_thres: float,
               good_repeat: int) -> None:
        """Two passes over ``order`` (ccv_tld.c:705-720, 773-790): a bad box
        j < len(feats) that passes ``ok`` and that the ferns call positive
        (>= their threshold) is learnt as negative, twice; every good box
        is warped by a random deformation and learnt as positive (repeat
        ``good_repeat``) where the ferns say <= ``good_thres``.

        ccv_tpu's loop, with the bad boxes' predictions made in blocks
        (``ferns_predict_many``, equal to the single calls) and made again
        for the boxes that share a leaf with each update of the posteriors,
        so that each box is judged by the posteriors it would meet in the
        loop; the loop itself visits only the boxes that act."""
        ferns = self.ferns
        badex = len(feats)
        seq = np.tile(np.asarray(order), 2)
        block = 4096
        for start in range(0, len(seq), block):
            chunk = seq[start:start + block]
            is_bad = chunk < badex
            idx = np.where(is_bad, chunk, 0)
            live = is_bad & ok[idx] if badex else is_bad
            pred = np.full(len(chunk), -np.inf)
            sel = np.nonzero(live)[0]
            pred[sel] = ferns_mod.ferns_predict_many(ferns, feats[idx[sel]])
            t = 0
            while True:
                act = ~is_bad[t:] | (pred[t:] >= ferns.threshold)
                if not act.any():
                    break
                t += int(np.argmax(act))
                j = int(chunk[t])
                changed = None
                if j < badex:
                    changed = feats[j]
                    ferns_mod.ferns_correct(ferns, changed, 0, 2)
                else:
                    fern = self._deformed_fern(ga, goods[j - badex], *deform)
                    if ferns_mod.ferns_predict(ferns, fern) <= good_thres:
                        changed = fern
                        ferns_mod.ferns_correct(ferns, fern, 1, good_repeat)
                t += 1
                if changed is not None:   # predict again where a leaf moved
                    rest = np.nonzero(live[t:])[0] + t
                    hit = rest[(feats[idx[rest]] == changed).any(1)]
                    pred[hit] = ferns_mod.ferns_predict_many(
                        ferns, feats[idx[hit]])

    def _deformed_fern(self, ga: torch.Tensor, box, angle, scale_d, shift):
        """_ccv_tld_ferns_feature_for with deformation (ccv_tld.c:384):
        random 3-D rotation + scale + shift, perspective-warped patch (on
        the device)."""
        x, y, w, h = int(box[0]), int(box[1]), int(box[2]), int(box[3])
        s = int(box[4])
        rng = self.rng
        rx = (angle * 2 * rng.random() - angle) * math.pi / 180
        ry = (angle * 2 * rng.random() - angle) * math.pi / 180
        rz = (angle * 2 * rng.random() - angle) * math.pi / 180
        sc = 1 + scale_d - scale_d * 2 * rng.random()
        m00 = math.cos(rz) * sc
        m01 = math.cos(ry) * math.sin(rz) * sc
        m02 = (shift * 2 * rng.random() - shift) * w
        m10 = (math.sin(ry) * math.cos(rz)
               - math.cos(rx) * math.sin(rz)) * sc
        m11 = (math.sin(ry) * math.sin(rz)
               + math.cos(rx) * math.cos(rz)) * sc
        m12 = (shift * rng.random() - shift) * h
        m20 = (math.sin(ry) * math.cos(rz) + math.sin(rx) * math.sin(rz)) * sc
        m21 = (math.sin(ry) * math.sin(rz) - math.sin(rx) * math.cos(rz)) * sc
        m22 = math.cos(rx) * math.cos(ry)
        # the box and an edge-clamped margin of 8, as ccv_tpu's fixed-shape
        # ROI (the warp's scale is 1 / max(rows, cols) of the ROI)
        pad = 8
        H, W = ga.shape
        ys = torch.arange(y - pad, y + h + pad, device=ga.device)
        xs = torch.arange(x - pad, x + w + pad, device=ga.device)
        roi = ga.index_select(0, ys.clamp(0, H - 1)).index_select(
            1, xs.clamp(0, W - 1))
        warped = transform.perspective_transform(
            roi, m00, m01, m02, m10, m11, m12, m20, m21, m22)
        patch = warped[pad:pad + h, pad:pad + w]
        return ferns_mod.ferns_feature(self.ferns, patch, s)

    def _fetch_patch(self, ga: torch.Tensor, rect) -> np.ndarray:
        """_ccv_tld_fetch_patch twin: slice + resample to the patch size."""
        return self._fetch_patches(ga, [rect])[0]

    def _fetch_patches(self, ga: torch.Tensor, rects) -> np.ndarray:
        """Batched _ccv_tld_fetch_patch on the device: group boxes by size,
        slice every member with one gather, resample the whole group in one
        call (the group rides the channel axis: the separable resample
        treats channels independently). Returns (n, ph, pw) uint8 on the
        host."""
        pw, ph = self.patch
        out = np.zeros((len(rects), ph, pw), np.uint8)
        rects = np.asarray([[int(v) for v in r[:4]] for r in rects])
        sizes = {}
        for i, (x, y, w, h) in enumerate(rects):
            sizes.setdefault((w, h), []).append(i)
        H, W = ga.shape
        dev = ga.device
        groups = []
        for (w, h), idxs in sizes.items():
            sel = torch.as_tensor(rects[idxs], device=dev)
            ys = (sel[:, 1:2] + torch.arange(h, device=dev)).clamp(0, H - 1)
            xs = (sel[:, 0:1] + torch.arange(w, device=dev)).clamp(0, W - 1)
            hwn = ga[ys.T[:, None, :], xs.T[None, :, :]]  # (h, w, n)
            res = resample.resample(
                hwn, rows=ph, cols=pw, rows_scale=ph / h, cols_scale=pw / w,
                interp=resample.INTER_AREA | resample.INTER_CUBIC)
            groups.append((idxs, res.permute(2, 0, 1)))
        if groups:   # one copy to the host for every group
            host = torch.cat([g for _, g in groups]).cpu().numpy()
            start = 0
            for idxs, g in groups:
                out[idxs] = host[start:start + len(idxs)]
                start += len(idxs)
        return out

    def _sv_matrix(self, which: int) -> np.ndarray:
        svs = self.sv[which]
        m = np.stack([p.astype(np.float64).ravel() for p in svs])
        m = m - m.mean(axis=1, keepdims=True)
        n = np.sqrt((m * m).sum(axis=1, keepdims=True))
        return m / np.maximum(n, 1e-12)

    def _sv_classify_batch(self, patches: np.ndarray, pnum: int = 0,
                           nnum: int = 0):
        """_ccv_tld_sv_classify twin (ccv_tld.c:472) for a (n, ph, pw)
        batch: ONE normalized matmul per support set instead of the
        reference's nested per-patch x per-sv loops.
        Returns (conf, anyp, anyn) arrays of shape (n,)."""
        n = len(patches)
        pnum = len(self.sv[1]) if pnum <= 0 else min(pnum, len(self.sv[1]))
        if pnum == 0:
            return np.zeros(n), np.zeros(n, int), np.zeros(n, int)
        nnum = len(self.sv[0]) if nnum <= 0 else min(nnum, len(self.sv[0]))
        if nnum == 0:
            return np.ones(n), np.zeros(n, int), np.zeros(n, int)
        v = patches.reshape(n, -1).astype(np.float64)
        v = v - v.mean(axis=1, keepdims=True)
        nv = np.sqrt((v * v).sum(axis=1, keepdims=True))
        v = v / np.maximum(nv, 1e-12)
        maxp = (np.max(self._sv_matrix(1)[:pnum] @ v.T, axis=0) + 1) * 0.5
        maxn = (np.max(self._sv_matrix(0)[:nnum] @ v.T, axis=0) + 1) * 0.5
        anyp = (maxp > self.params.nnc_same).astype(int)
        anyn = (maxn > self.params.nnc_same).astype(int)
        return (1 - maxn) / (2 - maxn - maxp), anyp, anyn

    def _sv_classify(self, a: np.ndarray, pnum: int = 0, nnum: int = 0):
        conf, anyp, anyn = self._sv_classify_batch(a[None], pnum, nnum)
        return float(conf[0]), int(anyp[0]), int(anyn[0])

    def _sv_correct(self, a: np.ndarray, y: int) -> int:
        """_ccv_tld_sv_correct twin."""
        if y == 1 and len(self.sv[1]) == 0:
            self.sv[1].append(a)
            return 0
        conf, _, _ = self._sv_classify(a)
        if y == 1 and conf < self.params.nnc_thres:
            self.sv[1].append(a)
            return 0
        if y == 0 and conf > self.params.nnc_collect:
            self.sv[0].append(a)
            return 0
        return -1

    def _generate_box_for(self, box, gcap: int):
        """_ccv_tld_generate_box_for twin: (good, bad, best) grid boxes by
        overlap with `box`; good = top-gcap by overlap (> include_overlap)."""
        overlap = _grid_overlaps(self.grid, box)
        good_mask = overlap > self.params.include_overlap
        bad_mask = overlap < self.params.exclude_overlap
        good_idx = np.nonzero(good_mask)[0]
        good_idx = good_idx[np.argsort(-overlap[good_idx], kind="stable")][:gcap]
        good = self.grid[good_idx]
        bad = self.grid[np.nonzero(bad_mask)[0]]
        if len(good_idx):
            best = self.grid[good_idx[0]]
        else:
            best = np.zeros(5, np.int32)
        return good, bad, best

    # -- short-term tracking ------------------------------------------------

    def _short_term_track(self, a: torch.Tensor, b: torch.Tensor, box):
        """_ccv_tld_short_term_track twin (ccv_tld.c:87): median flow with
        forward-backward + NCC gating; LK and the NCC patches on the
        frames' device."""
        params = self.params
        x, y, w, h = box
        gapx = w / GRID_SPARSITY
        gapy = h / GRID_SPARSITY
        pts = [(x + px, y + py)
               for px in np.arange(gapx * 0.5, w, gapx)
               for py in np.arange(gapy * 0.5, h, gapy)]
        if not pts:
            return None
        p0 = np.array(pts, np.float32)
        p1_d, s1 = classic.optical_flow_lucas_kanade(
            a, b, p0, params.win_size, params.level, params.min_eigen)
        p2, s2 = classic.optical_flow_lucas_kanade(
            b, a, p1_d, params.win_size, params.level, params.min_eigen)
        p1, s1, p2, s2 = (t.cpu().numpy() for t in (p1_d, s1, p2, s2))
        H, W = a.shape
        ok = (s1 & s2
              & (p1[:, 0] >= 0) & (p1[:, 0] < W)
              & (p1[:, 1] >= 0) & (p1[:, 1] < H)
              & (p2[:, 0] >= 0) & (p2[:, 0] < W)
              & (p2[:, 1] >= 0) & (p2[:, 1] < H))
        if not ok.any():
            return None
        idx = np.nonzero(ok)[0]
        fberr = ((p2[idx] - p0[idx]) ** 2).sum(-1)
        half = (PATCH_SIZE - 1) * 0.5
        # offsets stay numpy float32, so the fixed-point weights round as
        # ccv_tpu's do
        slices = torch.stack([torch.stack([
            transform.decimal_slice(a, p0[i, 1] - half, p0[i, 0] - half,
                                    PATCH_SIZE, PATCH_SIZE),
            transform.decimal_slice(b, p1[i, 1] - half, p1[i, 0] - half,
                                    PATCH_SIZE, PATCH_SIZE)])
            for i in idx]).cpu().numpy()
        sim = np.array([_ncc(pa, pb) for pa, pb in slices])
        simmd = _median(sim)
        keep = sim > simmd
        if not keep.any():
            return None
        idx = idx[keep]
        fberr = fberr[keep]
        fberrmd = _median(fberr)
        if fberrmd >= params.min_forward_backward_error:
            return None
        idx = idx[fberr <= fberrmd]
        if len(idx) == 0:
            return None
        off = p1[idx] - p0[idx]
        dx = _median(off[:, 0])
        dy = _median(off[:, 1])
        if len(idx) > 1:
            d1 = ((p1[idx][:, None, :] - p1[idx][None, :, :]) ** 2).sum(-1)
            d0 = ((p0[idx][:, None, :] - p0[idx][None, :, :]) ** 2).sum(-1)
            iu = np.triu_indices(len(idx), 1)
            ds = _median(np.sqrt(d1[iu] / d0[iu]))
            return (int(x + dx - w * (ds - 1) * 0.5 + 0.5),
                    int(y + dy - h * (ds - 1) * 0.5 + 0.5),
                    int(w * ds + 0.5), int(h * ds + 0.5))
        return (int(x + dx + 0.5), int(y + dy + 0.5), w, h)

    # -- long-term detection ------------------------------------------------

    def _long_term_detect(self, ga, sat, sqsat, info: TldInfo):
        """_ccv_tld_long_term_detect twin, batched: variance filter + ferns
        over the WHOLE grid at once, NCC on the top_n."""
        params = self.params
        r1 = params.rotation + 1
        r0 = self.count % r1
        sel = np.arange(len(self.grid)) % r1 == r0
        variances = self._batch_variances(sat, sqsat, self.grid)
        sel &= variances > self.var_thres
        cand = np.nonzero(sel)[0]
        top: List[Comp] = []
        if len(cand):
            feats = self._batch_ferns_features(ga, self.grid[cand])
            idx = np.arange(self.ferns.structs)
            post = self.ferns.posterior  # (structs, leaves, 2)
            votes = post[idx[None, :], feats.astype(np.int64), :]
            conf = votes[..., 1].sum(-1) - votes[..., 0].sum(-1)
            pass_f = conf > self.ferns_thres
            order = np.argsort(-conf[pass_f], kind="stable")[:params.top_n]
            chosen = cand[pass_f][order]
            top = [Comp(x=int(b[0]), y=int(b[1]), width=int(b[2]),
                        height=int(b[3]), confidence=float(c),
                        classification_id=int(b[4]))
                   for b, c in zip(self.grid[chosen], conf[pass_f][order])]
        self.top = top
        info.ferns_detects = len(top)
        seq = []
        if top:
            patches = self._fetch_patches(
                ga, [(b.x, b.y, b.width, b.height) for b in top])
            confs = self._sv_classify_batch(patches)[0]
            cons = self._sv_classify_batch(
                patches,
                pnum=max(int(len(self.sv[1]) * params.validate_set + 0.5),
                         1))[0]
            for box, c, conservative in zip(top, confs, cons):
                if c > self.nnc_thres:
                    seq.append(Comp(x=box.x, y=box.y, width=box.width,
                                    height=box.height,
                                    confidence=float(conservative),
                                    classification_id=box.classification_id))
        info.nnc_detects = len(seq)
        return seq

    # -- learning ------------------------------------------------------------

    def _quick_learn(self, ga, sat, sqsat, dd) -> bool:
        """_ccv_tld_quick_learn twin (ccv_tld.c:722)."""
        params = self.params
        x, y, w, h = dd
        pw, ph = self.patch
        scale = math.sqrt((w * h) / (pw * ph))
        rect = (int(x + (w - pw * scale) + 0.5), int(y + (h - ph * scale) + 0.5),
                int(pw * scale + 0.5), int(ph * scale + 0.5))
        b = self._fetch_patch(ga, rect)
        variance = float(np.var(b.astype(np.float64)))
        c, anyp, anyn = self._sv_classify(b)
        if not (c > params.nnc_collect and not anyn
                and variance > self.var_thres):
            return False
        good, bad, best = self._generate_box_for(rect, 10)
        goods = list(good) * (params.track_deform + 1)
        bad = bad[self._shuffled(len(bad))]
        badex = (len(bad) * 4 + 3) // 6
        order = np.arange(badex + len(goods))
        self.rng.shuffle(order)
        feats = self._batch_ferns_features(ga, bad[:badex])
        variances = self._batch_variances(sat, sqsat, bad[:badex])
        r1 = params.rotation + 1
        r0 = self.count % r1
        ok = (((bad[:badex, 4] % r1 == r0) | (params.rotation == 0))
              & (variances > self.var_thres))
        self._train(ga, order, feats, ok, goods,
                    (params.track_deform_angle, params.track_deform_scale,
                     params.track_deform_shift), self.ferns_thres, 1)
        self._sv_correct(self._fetch_patch(ga, best[:4]), 1)
        for box in self.top:
            if _rect_intersect((box.x, box.y, box.width, box.height),
                               best[:4]) < params.exclude_overlap:
                self._sv_correct(self._fetch_patch(
                    ga, (box.x, box.y, box.width, box.height)), 0)
        return True

    # -- per-frame entry -----------------------------------------------------

    def track_object(self, a, b, info: Optional[TldInfo] = None):
        """ccv_tld_track_object twin (ccv_tld.c:887). a = previous frame,
        b = current frame (uint8 gray, tensors or host arrays, which go to
        the tracker's device). Returns (rect, confidence)."""
        info = info if info is not None else TldInfo()
        a = _gray(a, self.device)
        b = _gray(b, self.device)
        params = self.params
        gb = basic.blur(b, 1.5)
        tracked = False
        verified = False
        result = None
        confidence = 0.0
        info.perform_track = int(self.found)
        if self.found:
            nb = self._short_term_track(a, b, self.box)
            if nb is not None:
                x, y, w, h = nb
                pw, ph = self.patch
                scale = math.sqrt((w * h) / (pw * ph))
                result = (int(x + (w - pw * scale) + 0.5),
                          int(y + (h - ph * scale) + 0.5),
                          int(pw * scale + 0.5), int(ph * scale + 0.5))
                tracked = True
                verified = self.verified
                c = self._sv_classify(self._fetch_patch(gb, result))[0]
                confidence = c
                if c > self.nnc_verify_thres:
                    verified = True
        info.track_success = int(tracked)
        sat, sqsat = self._sats(b.cpu().numpy())
        dd = self._long_term_detect(gb, sat, sqsat, info)
        # cluster detections (ccv_tld.c:938-975)
        if len(dd) > 1:
            idx = group(dd, lambda r1_, r2_: _rect_intersect(
                (r1_.x, r1_.y, r1_.width, r1_.height),
                (r2_.x, r2_.y, r2_.width, r2_.height)) > 0.5)
            ngroups = max(idx) + 1
            acc = np.zeros((ngroups, 5))
            cnt = np.zeros(ngroups, int)
            for r, g in zip(dd, idx):
                acc[g] += (r.x, r.y, r.width, r.height, r.confidence)
                cnt[g] += 1
            dd = [Comp(x=int((acc[g][0] * 2 + cnt[g]) / (2 * cnt[g])),
                       y=int((acc[g][1] * 2 + cnt[g]) / (2 * cnt[g])),
                       width=int((acc[g][2] * 2 + cnt[g]) / (2 * cnt[g])),
                       height=int((acc[g][3] * 2 + cnt[g]) / (2 * cnt[g])),
                       confidence=acc[g][4] / cnt[g], neighbors=int(cnt[g]))
                  for g in range(ngroups)]
        info.clustered_detects = len(dd)
        info.confident_matches = info.close_matches = 0
        if tracked:
            if dd:
                confident = [r for r in dd if _rect_intersect(
                    result, (r.x, r.y, r.width, r.height)) < 0.5
                    and r.confidence > confidence]
                info.confident_matches = len(confident)
                if len(confident) == 1:
                    r = confident[0]
                    result = (r.x, r.y, r.width, r.height)
                    confidence = r.confidence
                    verified = False
                else:
                    close = [r for r in dd if _rect_intersect(
                        result, (r.x, r.y, r.width, r.height)) > 0.7]
                    info.close_matches = len(close)
                    if close:
                        n = len(close)
                        sx = sum(r.x for r in close)
                        sy = sum(r.y for r in close)
                        sw = sum(r.width for r in close)
                        sh = sum(r.height for r in close)
                        result = (
                            (20 * result[0] + sx * 2 + n + 10) // (20 + 2 * n),
                            (20 * result[1] + sy * 2 + n + 10) // (20 + 2 * n),
                            (20 * result[2] + sw * 2 + n + 10) // (20 + 2 * n),
                            (20 * result[3] + sh * 2 + n + 10) // (20 + 2 * n))
        elif len(dd) == 1:
            r = dd[0]
            result = (r.x, r.y, r.width, r.height)
            confidence = r.confidence
            self.found = True
        else:
            self.found = False
        info.perform_learn = int(verified)
        if verified and result is not None:
            verified = self._quick_learn(gb, sat, sqsat, result)
        self.verified = verified
        if result is not None:
            self.box = result
            self.confidence = confidence
        else:
            self.found = False
        self.count += 1
        return (self.box if result is not None else None), confidence
