"""SWT parameter search, the swtcreate twin (counterpart of
ccv_tpu/train/swt.py; reference: bin/swtcreate.c).

SWT "training" is a coordinate-descent search over the SwtParams fields
that maximises the harmonic mean of the Wolf-Jolion precision and recall on
annotated images.

- ``evaluate_wolf``: _ccv_evaluate_wolf (bin/swtcreate.c:47) exactly, as
  ``ccv_tpu`` has it: one-to-one matches gated on coverage and centre
  distance, then one-to-many both ways with the 1 / (1 + log n) dispersion
  penalty (``OM_ONE``); plain Python on the host;
- ``optimize_params``: the sweep of each ``Range`` in turn over
  ``detectors.swt.detect_words`` on ``device`` (default: the card), with
  ``ccv_tpu``'s ``1e-9`` comparisons and integer fields.

No kernel of the port's own: ``ccv_tpu``'s search is Python around its SWT
detector's XLA ops, these are the port's detector's torch ops.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ccv_tpu_torch import device as _device
from ccv_tpu_torch.core.dense_matrix import as_array
from ccv_tpu_torch.detectors import swt as swt_mod

ONE_G = 0.8
ONE_D = 0.4
OM_ONE = 0.8
CENTER_DIFF_THR = 1.0


def evaluate_wolf(words: Sequence, truth: Sequence[Tuple[int, int, int, int]]
                  ) -> Tuple[float, float]:
    """_ccv_evaluate_wolf twin. ``words`` are Comp-like (x / y / width /
    height) or (x, y, w, h) tuples; returns (total_precision,
    total_recall), the sums before the division by the counts, as the
    reference."""
    def rect(w):
        if hasattr(w, "x"):
            return (w.x, w.y, w.width, w.height)
        return tuple(w)

    D = [rect(w) for w in words]
    G = [tuple(t) for t in truth]
    if not D or not G:
        return 0.0, 0.0
    nG, nD = len(G), len(D)
    mG = np.zeros((nG, nD))
    mD = np.zeros((nD, nG))
    for j, g in enumerate(G):
        for k, d in enumerate(D):
            ix = max(0, min(d[0] + d[2], g[0] + g[2]) - max(d[0], g[0]))
            iy = max(0, min(d[1] + d[3], g[1] + g[3]) - max(d[1], g[1]))
            match = ix * iy
            if match > 0:
                mG[j, k] = match / (g[2] * g[3])
                mD[k, j] = match / (d[2] * d[3])
    cG = (mG > 0).sum(axis=1)
    cD = (mD > 0).sum(axis=1)
    tG = np.zeros(nG, bool)
    tD = np.zeros(nD, bool)
    recall = precision = 0.0
    # one to one
    for j in range(nG):
        if cG[j] != 1:
            continue
        for k in range(nD):
            if cD[k] != 1:
                continue
            if mG[j, k] >= ONE_G and mD[k, j] >= ONE_D:
                g, d = G[j], D[k]
                dx = (d[0] + d[2] * 0.5) - (g[0] + g[2] * 0.5)
                dy = (d[1] + d[3] * 0.5) - (g[1] + g[3] * 0.5)
                dist = math.sqrt(dx * dx + dy * dy) * 2.0 / (
                    math.hypot(d[2], d[3]) + math.hypot(g[2], g[3]))
                if dist < CENTER_DIFF_THR:
                    recall += 1.0
                    precision += 1.0
                    tG[j] = tD[k] = True
    # one (truth) to many (detections)
    for j in range(nG):
        if tG[j] or cG[j] <= 1:
            continue
        many = [k for k in range(nD) if not tD[k] and mD[k, j] >= ONE_D]
        one_sum = sum(mG[j, k] for k in many)
        if len(many) == 1:
            k = many[0]
            if mG[j, k] >= ONE_G and mD[k, j] >= ONE_D:
                recall += 1.0
                precision += 1.0
                tG[j] = tD[k] = True
        elif one_sum >= ONE_G and many:
            for k in many:
                tD[k] = True
            recall += OM_ONE
            precision += OM_ONE / (1 + math.log(len(many)))
    # one (detection) to many (truths)
    for k in range(nD):
        if tD[k] or cD[k] <= 1:
            continue
        many = [j for j in range(nG) if not tG[j] and mG[j, k] >= ONE_G]
        one_sum = sum(mD[k, j] for j in many)
        if len(many) == 1:
            j = many[0]
            if mG[j, k] >= ONE_G and mD[k, j] >= ONE_D:
                recall += 1.0
                precision += 1.0
                tG[j] = tD[k] = True
        elif one_sum >= ONE_G and many:
            for j in many:
                tG[j] = True
            recall += OM_ONE / (1 + math.log(len(many)))
            precision += OM_ONE
    return precision, recall


@dataclasses.dataclass
class Range:
    """ccv_swt_range_t twin: min, step, max (inclusive)."""

    min_value: float
    step: float
    max_value: float


def optimize_params(images: Sequence, truths: Sequence[Sequence],
                    ranges: Dict[str, Range],
                    base: Optional[swt_mod.SwtParams] = None,
                    iterations: int = 10,
                    integer_fields: Sequence[str] = (),
                    device: _device.DeviceLike = None
                    ) -> swt_mod.SwtParams:
    """bin/swtcreate.c's coordinate descent: for each parameter in turn,
    sweep its range on every image and keep the value that maximises the
    harmonic mean of precision and recall; repeat ``iterations`` times or
    until nothing improves. The images (numpy arrays or tensors) go to
    ``device`` once (default: where a tensor is, else the card)."""
    imgs = [as_array(img, device) for img in images]
    params = dataclasses.replace(base or swt_mod.SwtParams())
    best_params = params

    def score(p: swt_mod.SwtParams) -> float:
        tp = tr = 0.0
        nw = ng = 0
        for img, truth in zip(imgs, truths):
            words = swt_mod.detect_words(img, p)
            prec, rec = evaluate_wolf(words, truth)
            tp += prec
            tr += rec
            nw += max(len(words), 1)
            ng += max(len(truth), 1)
        precision = tp / nw
        recall = tr / ng
        if precision + recall == 0:
            return 0.0
        return 2 * precision * recall / (precision + recall)

    best_f = score(best_params)
    for it in range(iterations):
        improved = False
        for name, r in ranges.items():
            v = r.min_value
            while v <= r.max_value + 1e-9:
                val = int(round(v)) if name in integer_fields else v
                cand = dataclasses.replace(best_params, **{name: val})
                f = score(cand)
                if f > best_f + 1e-9:
                    best_f = f
                    best_params = cand
                    improved = True
                v += r.step
        if not improved:
            break
    return best_params
