"""Shared detector utilities: rectangle grouping / NMS at the host edge.

Counterpart of ccv_tpu/detectors/common.py (ccv_array_group,
lib/ccv_util.c:1800, and the per-detector merge loops): union-find over a
pairwise ``same`` predicate, then a per-group reduction. Plain Python: the
variable-length outputs live on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence


@dataclasses.dataclass(slots=True)
class Comp:
    """A detection: rect (x, y, width, height) + classification. Slots: a
    detect call can return hundreds of thousands of these."""

    x: float
    y: float
    width: float
    height: float
    confidence: float = 0.0
    neighbors: int = 1
    classification_id: int = 1


def iom(a: Comp, b: Comp) -> float:
    """Intersection over min-area (the HeadHunter-style criterion)."""
    iw = min(a.x + a.width, b.x + b.width) - max(a.x, b.x)
    ih = min(a.y + a.height, b.y + b.height) - max(a.y, b.y)
    inter = max(iw, 0) * max(ih, 0)
    m = min(a.width * a.height, b.width * b.height)
    return inter / m if m > 0 else 0.0


def group(items: Sequence, same: Callable) -> List[int]:
    """Union-find grouping; returns a group index per item, numbered by
    first appearance."""
    parent = list(range(len(items)))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    for i in range(len(items)):
        for j in range(i + 1, len(items)):
            if same(items[i], items[j]):
                ri, rj = find(i), find(j)
                if ri != rj:
                    parent[rj] = ri
    roots = {}
    out = []
    for i in range(len(items)):
        r = find(i)
        out.append(roots.setdefault(r, len(roots)))
    return out


def merge_detections(comps: List[Comp], min_neighbors: int,
                     iom_thresh: float = 0.3) -> List[Comp]:
    """SCD-style merge (lib/ccv_scd.c:1806-1836): group by IoM>=thresh &
    same class; keep the first max-confidence rect per group; neighbors =
    group size; drop groups below min_neighbors."""
    if min_neighbors == 0:
        return list(comps)
    if not comps:
        return []

    def same(a, b):
        return (a.classification_id == b.classification_id
                and iom(a, b) >= iom_thresh)

    idx = group(comps, same)
    ngroups = max(idx) + 1
    best: List[Optional[Comp]] = [None] * ngroups
    counts = [0] * ngroups
    for c, g in zip(comps, idx):
        counts[g] += 1
        if best[g] is None or c.confidence > best[g].confidence:
            best[g] = c
    out = []
    for g in range(ngroups):
        c = best[g]
        out.append(Comp(c.x, c.y, c.width, c.height, c.confidence,
                        neighbors=counts[g],
                        classification_id=c.classification_id))
    return [c for c in out if c.neighbors >= min_neighbors]
