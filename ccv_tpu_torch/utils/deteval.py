"""Detection-accuracy scoring twins of the reference's vldtr tooling
(counterpart of ccv_tpu/utils/deteval.py, kept as the port's own copy).

- ``deteval``: DetEval one-to-one / one-to-many matching, the protocol of
  bin/swtvldtr.rb (used for the published ICDAR precision/recall numbers,
  doc/swt.rst:29).
- ``pascal_score``: Pascal-VOC style IoU>=0.5 AP-less precision/recall,
  the protocol of bin/dpmvldtr.rb / bin/icfvldtr.rb.
- ``cmu_face_score``: CMU annotated-landmark containment, the protocol of
  bin/bbfvldtr.rb (a detection counts when all six landmarks fall inside
  the 1.5x-relaxed box).

All functions take plain dict rects {x, y, width, height} keyed per image.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

ONE_G = 0.8
ONE_D = 0.4
OM_ONE = 0.8
CENTER_DIFF_THR = 1.0


def _inter(a, b) -> float:
    w = min(a["x"] + a["width"], b["x"] + b["width"]) - max(a["x"], b["x"])
    h = (min(a["y"] + a["height"], b["y"] + b["height"])
         - max(a["y"], b["y"]))
    return max(w, 0.0) * max(h, 0.0)


def deteval_image(rects: List[dict], targets: List[dict]) -> Tuple[float, float]:
    """DetEval recall/precision CONTRIBUTIONS for one image
    (bin/swtvldtr.rb:38-140). Returns (recall_sum, precision_sum); divide
    by the truth/estimate counts across the dataset for the final rates."""
    nG, nD = len(rects), len(targets)
    cG = [0] * nG
    cD = [0] * nD
    mG = [[0.0] * nD for _ in range(nG)]
    mD = [[0.0] * nG for _ in range(nD)]
    for i, rect in enumerate(rects):
        for j, target in enumerate(targets):
            match = _inter(target, rect)
            if match > 0.0001:
                mG[i][j] = match / (rect["width"] * rect["height"])
                mD[j][i] = match / (target["width"] * target["height"])
                cG[i] += 1
                cD[j] += 1
    recall = precision = 0.0
    tG = [False] * nG
    tD = [False] * nD
    # one-to-one
    for i, rect in enumerate(rects):
        if cG[i] != 1:
            continue
        for j, target in enumerate(targets):
            if cD[j] != 1:
                continue
            if mG[i][j] >= ONE_G and mD[j][i] >= ONE_D:
                dx = ((target["x"] + target["width"] * 0.5)
                      - (rect["x"] + rect["width"] * 0.5))
                dy = ((target["y"] + target["height"] * 0.5)
                      - (rect["y"] + rect["height"] * 0.5))
                d = (math.hypot(dx, dy) * 2.0
                     / (math.hypot(target["width"], target["height"])
                        + math.hypot(rect["width"], rect["height"])))
                if d < CENTER_DIFF_THR:
                    recall += 1.0
                    precision += 1.0
                    tG[i] = tD[j] = True
    # one(truth)-to-many(estimates)
    for i in range(nG):
        if tG[i] or cG[i] <= 1:
            continue
        one_sum = 0.0
        many = [j for j in range(nD)
                if not tD[j] and mD[j][i] >= ONE_D]
        one_sum = sum(mG[i][j] for j in many)
        if len(many) == 1:
            j = many[0]
            if mG[i][j] >= ONE_G and mD[j][i] >= ONE_D:
                recall += 1.0
                precision += 1.0
                tG[i] = tD[j] = True
        elif one_sum >= ONE_G:
            for j in many:
                tD[j] = True
            recall += OM_ONE
            precision += OM_ONE / (1.0 + math.log(len(many)))
    # one(estimate)-to-many(truths)
    for j in range(nD):
        if tD[j] or cD[j] <= 1:
            continue
        many = [i for i in range(nG)
                if not tG[i] and mG[i][j] >= ONE_G]
        one_sum = sum(mD[j][i] for i in many)
        if len(many) == 1:
            i = many[0]
            if mG[i][j] >= ONE_G and mD[j][i] >= ONE_D:
                recall += 1.0
                precision += 1.0
                tG[i] = tD[j] = True
        elif one_sum >= ONE_D:
            for i in many:
                tG[i] = True
            precision += OM_ONE
            recall += OM_ONE / (1.0 + math.log(len(many)))
    return recall, precision


def deteval(truth: Dict[str, List[dict]],
            estimate: Dict[str, List[dict]]) -> Tuple[float, float]:
    """Dataset DetEval (swtvldtr.rb tail): returns (precision, recall)."""
    recall = precision = 0.0
    total_truth = sum(len(v) for v in truth.values())
    total_est = sum(len(v) for v in estimate.values())
    for fn, rects in truth.items():
        targets = estimate.get(fn)
        if not targets:
            continue
        r, p = deteval_image(rects, targets)
        recall += r
        precision += p
    return (precision / max(total_est, 1), recall / max(total_truth, 1))


def pascal_score(truth: Dict[str, List[dict]],
                 estimate: Dict[str, List[dict]],
                 iou_thresh: float = 0.5) -> Tuple[float, float]:
    """Greedy IoU matching (dpmvldtr.rb protocol): (precision, recall)."""
    tp = 0
    total_truth = sum(len(v) for v in truth.values())
    total_est = sum(len(v) for v in estimate.values())
    for fn, rects in truth.items():
        targets = list(estimate.get(fn, []))
        used = [False] * len(targets)
        for rect in rects:
            best, best_iou = -1, iou_thresh
            for j, target in enumerate(targets):
                if used[j]:
                    continue
                inter = _inter(rect, target)
                union = (rect["width"] * rect["height"]
                         + target["width"] * target["height"] - inter)
                iou = inter / union if union > 0 else 0.0
                if iou >= best_iou:
                    best, best_iou = j, iou
            if best >= 0:
                used[best] = True
                tp += 1
    return (tp / max(total_est, 1), tp / max(total_truth, 1))


def overlap_score(truth: Dict[str, List[dict]],
                  detections: Dict[str, List[dict]]) -> Tuple[int, int, int]:
    """dpmvldtr.rb / icfvldtr.rb criterion: a detection matches a truth box
    when intersection > 0.5 * max(truth area, det area); a re-detection of
    an already-found box counts as neither tp nor fa. Returns
    (true_positives, false_alarms, total_truth_boxes)."""
    tp = fa = 0
    total = sum(len(v) for v in truth.values())
    found: Dict[str, List[bool]] = {k: [False] * len(v)
                                    for k, v in truth.items()}
    for name, dets in detections.items():
        objs = truth.get(name)
        for det in dets:
            if objs is None:
                fa += 1
                continue
            outlier = -1
            for oi, obj in enumerate(objs):
                r0 = _inter(obj, det)
                r1 = max(obj["width"] * obj["height"],
                         det["width"] * det["height"]) * 0.5
                if r0 > r1:
                    outlier = 0 if found[name][oi] else 1
                    found[name][oi] = True
                    break
            if outlier == -1:
                fa += 1
            elif outlier == 1:
                tp += 1
    return tp, fa, total


def topk_miss(truth: List[int], ranks: List[List[int]]) -> Tuple[float, float]:
    """cnnvldtr.rb: (top-1 missing rate, top-5 missing rate)."""
    miss1 = miss5 = 0
    n = len(ranks)
    for t, r in zip(truth, ranks):
        if not r or r[0] != t:
            miss1 += 1
        if t not in r[:5]:
            miss5 += 1
    return miss1 / max(n, 1), miss5 / max(n, 1)


def cmu_face_score(truth: Dict[str, List[dict]],
                   detections: Dict[str, List[dict]]) -> Tuple[int, int, int]:
    """bbfvldtr.rb protocol: truth holds per-face landmark dicts with keys
    left_eye/right_eye/nose/left_mouth/center_mouth/right_mouth (each
    {x, y}); returns (true_positives, false_alarms, total_faces)."""
    tp = fa = 0
    total = sum(len(v) for v in truth.values())
    for name, dets in detections.items():
        faces = truth.get(name)
        for det in dets:
            if not faces:
                fa += 1
                continue
            x = det["x"] - det["width"] * 0.25
            y = det["y"] - det["height"] * 0.25
            w = det["width"] * 1.5
            h = det["height"] * 1.5
            hit = any(
                all(x < f[k]["x"] < x + w and y < f[k]["y"] < y + h
                    for k in ("left_eye", "right_eye", "nose", "left_mouth",
                              "center_mouth", "right_mouth"))
                for f in faces)
            if hit:
                tp += 1
            else:
                fa += 1
    return tp, fa, total


def parse_rect_file(path: str) -> Dict[str, List[dict]]:
    """swtvldtr.rb input format: a filename line, then one 'x y w h' line
    per rect (extra columns ignored)."""
    import re

    out: Dict[str, List[dict]] = {}
    filename = None
    rect_re = re.compile(r"^\s*-?\d+\s+-?\d+\s+-?\d+\s+-?\d+")
    with open(path) as f:
        for line in f:
            if rect_re.match(line):
                nb = line.split()
                out.setdefault(filename, []).append(dict(
                    x=float(nb[0]), y=float(nb[1]),
                    width=float(nb[2]), height=float(nb[3])))
            elif line.strip():
                filename = line.strip()
    return out
