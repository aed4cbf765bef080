"""Random ferns classifier (counterpart of ccv_tpu/detectors/ferns.py;
reference: lib/ccv_ferns.c), used by TLD.

A fern hashes ``features`` pairwise pixel comparisons into a leaf index;
per-leaf class posteriors are updated online (semi-naive Bayes). Host numpy
as in ccv_tpu: ``ferns_new`` draws its points from
``np.random.default_rng(seed)`` in ccv_tpu's order, so one seed gives the
same ferns in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class Ferns:
    structs: int
    features: int
    scales: int
    # (scales, structs, features, 2, 2) as (point index -> (x, y))
    points: np.ndarray
    posterior: np.ndarray   # (structs, 2**features, 2) log posteriors
    rnum: np.ndarray        # (structs, 2**features, 2) observation counts
    cnum: np.ndarray        # (2,) class counts
    threshold: float = 0.0

    @property
    def posteriors(self) -> int:
        return 1 << self.features


def ferns_new(structs: int, features: int, sizes: Sequence[Tuple[int, int]],
              seed: int = 0) -> Ferns:
    """ccv_ferns_new twin: random axis-restricted point pairs per scale.

    sizes: list of (width, height) per scale."""
    scales = len(sizes)
    rng = np.random.default_rng(seed)
    points = np.zeros((scales, structs, features, 2, 2), np.int32)
    for i in range(structs):
        for k in range(features):
            if rng.integers(0, 2):
                while True:
                    x1f, x2f = rng.random(), rng.random()
                    y1f = y2f = rng.random()
                    if abs(x1f - x2f) < 0.2:
                        break
            else:
                while True:
                    x1f = x2f = rng.random()
                    y1f, y2f = rng.random(), rng.random()
                    if abs(y1f - y2f) < 0.2:
                        break
            for j, (w, h) in enumerate(sizes):
                points[j, i, k, 0] = (int(x1f * w), int(y1f * h))
                points[j, i, k, 1] = (int(x2f * w), int(y2f * h))
    posteriors = 1 << features
    return Ferns(structs=structs, features=features, scales=scales,
                 points=points,
                 posterior=np.full((structs, posteriors, 2), np.log(0.5),
                                   np.float32),
                 rnum=np.zeros((structs, posteriors, 2), np.int64),
                 cnum=np.zeros(2, np.int64))


def ferns_feature(ferns: Ferns, patch, scale: int) -> np.ndarray:
    """ccv_ferns_feature twin: (structs,) leaf indices for one patch (a host
    array or a tensor): one gather per point set, then the bit packing."""
    a = patch.cpu().numpy() if isinstance(patch, torch.Tensor) else \
        np.asarray(patch)
    if a.ndim == 3:
        a = a[..., 0]
    pts = ferns.points[scale]  # (structs, features, 2, 2)
    H, W = a.shape
    x = np.clip(pts[..., 0], 0, W - 1)
    y = np.clip(pts[..., 1], 0, H - 1)
    vals = a[y, x]  # (structs, features, 2)
    bits = (vals[..., 0] > vals[..., 1]).astype(np.uint32)
    weights = (1 << np.arange(ferns.features - 1, -1, -1)).astype(np.uint32)
    return (bits * weights).sum(-1).astype(np.uint32)


def ferns_correct(ferns: Ferns, fern: np.ndarray, c: int, repeat: int = 0):
    """ccv_ferns_correct twin: online posterior update of the fern's leaf in
    every struct (one leaf a struct, so the structs update at once)."""
    c = int(c)
    repeat += 1
    ferns.cnum[c] += repeat
    cw = 1.0 / (ferns.cnum + 1)
    i = np.arange(ferns.structs)
    k = np.asarray(fern).astype(np.int64)
    ferns.rnum[i, k, c] += repeat
    rcw0 = ferns.rnum[i, k, 0] * cw[0] + 1e-5
    rcw1 = ferns.rnum[i, k, 1] * cw[1] + 1e-5
    ferns.posterior[i, k, 0] = np.log(rcw0 / (rcw0 + rcw1))
    ferns.posterior[i, k, 1] = np.log(rcw1 / (rcw0 + rcw1))


def ferns_predict(ferns: Ferns, fern: np.ndarray) -> float:
    """ccv_ferns_predict twin: vote margin (class 1 - class 0)."""
    idx = np.arange(ferns.structs)
    votes = ferns.posterior[idx, fern.astype(np.int64)]
    return float(votes[:, 1].sum() - votes[:, 0].sum())


def _pairwise_sum(a: np.ndarray) -> np.ndarray:
    """Row sums of a float32 (m, n) array in numpy's pairwise order (8
    accumulators up to 128 elements, halves above), so that each equals
    ``row.sum()`` to the bit."""
    n = a.shape[1]
    if n < 8:
        res = np.zeros(a.shape[0], a.dtype)
        for i in range(n):
            res = res + a[:, i]
        return res
    if n <= 128:
        r = [a[:, j] for j in range(8)]
        i = 8
        while i < n - n % 8:
            r = [r[j] + a[:, i + j] for j in range(8)]
            i += 8
        res = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]))
        for i in range(i, n):
            res = res + a[:, i]
        return res
    n2 = n // 2
    n2 -= n2 % 8
    return _pairwise_sum(a[:, :n2]) + _pairwise_sum(a[:, n2:])


def ferns_predict_many(ferns: Ferns, feats: np.ndarray) -> np.ndarray:
    """``ferns_predict`` of each row of ``feats`` (m, structs) at once,
    float64, each equal to the single call's value."""
    votes = ferns.posterior[np.arange(ferns.structs)[None, :],
                            feats.astype(np.int64)]      # (m, structs, 2)
    return (_pairwise_sum(np.ascontiguousarray(votes[..., 1]))
            - _pairwise_sum(np.ascontiguousarray(votes[..., 0]))
            ).astype(np.float64)
