"""BBF cascade training, the bbfcreate twin (counterpart of
ccv_tpu/train/bbf.py; reference: lib/ccv_bbf.c, the genetic feature search
and boosting halves of ccv_bbf_classifier_cascade_new).

A BBF feature compares min(bright points) > max(dark points) across the
3-level window pyramid (24/12/6 at the published 24 x 24).

- ``flatten_pyramids``: every patch's three levels, the ``sample_down``
  chain ``detectors.bbf`` runs, on ``device``, stacked as (N, D) int32;
- ``feature_responses``: one gather of each point set over every example
  and feature on the device, (N, F, 8), then min > max; the (N, F)
  booleans come to the host;
- ``_random_features`` / ``_mutate``: the population's point sets, drawn
  from a ``np.random.Generator`` in ``ccv_tpu``'s order, so both packages
  evolve the same features from one seed;
- ``train_cascade``: the genetic search a feature (elite and mutations,
  ``generations`` rounds), AdaBoost's float64 weights, alphas and the
  soft-cascade thresholds on the host in numpy, as ``ccv_tpu`` has them
  (the weighted errors are a numpy ``einsum``, so ``argsort``'s ties break
  as in ``ccv_tpu``), and the negatives a stage passes kept for the next;
- ``write_cascade``: ``detectors.bbf.write_cascade`` (cascade.txt and
  stage-N.txt, floats as their int bits), the same bytes as ``ccv_tpu``'s.

No kernel of the port's own: ``ccv_tpu``'s trainer is XLA ops and numpy.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch

from ccv_tpu_torch import device as _device
from ccv_tpu_torch.detectors import bbf as bbf_mod
from ccv_tpu_torch.ops import resample

MAX_POINTS = 8
write_cascade = bbf_mod.write_cascade


@dataclasses.dataclass
class BbfTrainParams:
    """ccv_bbf_new_param_t twin (subset)."""

    size: Tuple[int, int] = (24, 24)
    pos_crit: float = 0.995
    neg_crit: float = 0.5
    population: int = 256         # genetic population per round
    generations: int = 4
    max_features_per_stage: int = 16
    n_stages: int = 4
    seed: int = 0
    threshold_slack: float = 0.5


def _pyramid_dims(size):
    w, h = size
    return [(h, w), (h // 2, w // 2), (h // 4, w // 4)]


def flatten_pyramids(patches, size,
                     device: _device.DeviceLike = None) -> torch.Tensor:
    """(N, H, W[, C]) uint8 -> (N, D) int32 on ``device`` (default: where a
    tensor is, else the card): the concatenated 3-level pyramids, channel
    0, by the ``sample_down`` chain of ``detectors.bbf``."""
    x = torch.as_tensor(patches)
    dev = _device.resolve(device, x if isinstance(patches, torch.Tensor)
                          else None)
    x = x.to(dev)
    if x.dim() == 4:
        x = x[..., 0]
    l1 = resample.sample_down(x[..., None])
    l2 = resample.sample_down(l1)
    n = x.shape[0]
    return torch.cat([x.reshape(n, -1), l1.reshape(n, -1),
                      l2.reshape(n, -1)], 1).to(torch.int32)


def _point_index(px, py, pz, size):
    """Linear index of (x, y) on level z within the flattened pyramid;
    -1 points map to slot 0 (masked)."""
    dims = _pyramid_dims(size)
    offs = [0, dims[0][0] * dims[0][1],
            dims[0][0] * dims[0][1] + dims[1][0] * dims[1][1]]
    idx = np.zeros_like(px)
    for z in range(3):
        m = pz == z
        idx[m] = offs[z] + py[m] * dims[z][1] + px[m]
    idx[pz < 0] = 0
    return idx


def feature_responses(flat, px, py, pz, nx, ny, nz, size) -> np.ndarray:
    """(N, F) bool on the host: min(bright) > max(dark) for every feature
    on every example (_ccv_run_bbf_feature twin), one gather per point set
    on ``flat``'s device."""
    fl = flat if isinstance(flat, torch.Tensor) else torch.from_numpy(
        np.asarray(flat, np.int32))
    dev = fl.device

    def side(x, y, z, fill, reduce):
        idx = torch.from_numpy(_point_index(x, y, z, size).astype(np.int64))
        vals = fl[:, idx.to(dev)]                        # (N, F, 8)
        mask = torch.from_numpy(z >= 0).to(dev)
        return reduce(torch.where(mask[None], vals, fill), -1).values

    bmin = side(px, py, pz, 10 ** 6, torch.min)
    dmax = side(nx, ny, nz, -(10 ** 6), torch.max)
    return (bmin > dmax).cpu().numpy()


def _random_features(n, size, rng):
    """Random candidate point sets (like the reference's gene seeding); one
    size for both sets, as ccv_bbf_feature_t has."""
    dims = _pyramid_dims(size)
    px = np.full((n, MAX_POINTS), -1, np.int32)
    py = np.zeros((n, MAX_POINTS), np.int32)
    pz = np.full((n, MAX_POINTS), -1, np.int32)
    nx = np.full((n, MAX_POINTS), -1, np.int32)
    ny = np.zeros((n, MAX_POINTS), np.int32)
    nz = np.full((n, MAX_POINTS), -1, np.int32)
    for i in range(n):
        k = int(rng.integers(1, 4))
        for arrx, arry, arrz in ((px, py, pz), (nx, ny, nz)):
            for j in range(k):
                z = int(rng.integers(0, 3))
                arrz[i, j] = z
                arry[i, j] = int(rng.integers(0, dims[z][0]))
                arrx[i, j] = int(rng.integers(0, dims[z][1]))
    return px, py, pz, nx, ny, nz


def _mutate(feats, size, rng):
    """Point-level mutation (move / add / drop), the genetic step."""
    px, py, pz, nx, ny, nz = (a.copy() for a in feats)
    dims = _pyramid_dims(size)
    n = px.shape[0]
    for i in range(n):
        k = int((pz[i] >= 0).sum())
        op = int(rng.integers(0, 3))
        if op == 1 and k < MAX_POINTS:  # grow both sets by one point
            for arrx, arry, arrz in ((px, py, pz), (nx, ny, nz)):
                z = int(rng.integers(0, 3))
                arrz[i, k] = z
                arry[i, k] = int(rng.integers(0, dims[z][0]))
                arrx[i, k] = int(rng.integers(0, dims[z][1]))
        elif op == 2 and k > 1:  # shrink both sets (y is left as it was)
            for arrx, arry, arrz in ((px, py, pz), (nx, ny, nz)):
                arrz[i, k - 1] = -1
                arrx[i, k - 1] = -1
        else:  # move one point of each set
            j = int(rng.integers(0, k))
            for arrx, arry, arrz in ((px, py, pz), (nx, ny, nz)):
                z = int(arrz[i, j])
                arry[i, j] = int(np.clip(arry[i, j] + rng.integers(-2, 3),
                                         0, dims[z][0] - 1))
                arrx[i, j] = int(np.clip(arrx[i, j] + rng.integers(-2, 3),
                                         0, dims[z][1] - 1))
    return px, py, pz, nx, ny, nz


def train_cascade(positives, negatives,
                  params: Optional[BbfTrainParams] = None,
                  device: _device.DeviceLike = None,
                  timings: Optional[dict] = None) -> bbf_mod.BbfCascade:
    """ccv_bbf_classifier_cascade_new twin on in-memory gray patches
    (N, H, W[, C]) uint8; the pyramids and the responses on ``device``
    (default: the card). ``timings``, if a dict, gets each stage's seconds
    (``stage_s``), the generations run and their seconds
    (``generations``, ``generation_s``)."""
    params = params or BbfTrainParams()
    dev = _device.resolve(device)
    rng = np.random.default_rng(params.seed)
    pos = np.asarray(positives)
    neg = np.asarray(negatives)
    n_pos, n_neg = len(pos), len(neg)
    flat = flatten_pyramids(np.concatenate([pos, neg]), params.size, dev)
    y = np.concatenate([np.ones(n_pos, bool), np.zeros(n_neg, bool)])
    stage_s, generations, generation_s = [], 0, 0.0

    stage_of, thresholds, alphas = [], [], []
    F_px, F_py, F_pz, F_nx, F_ny, F_nz = [], [], [], [], [], []
    for s in range(params.n_stages):
        t_stage = time.perf_counter()
        w = np.where(y, 0.5 / n_pos, 0.5 / max(n_neg, 1))
        rates = np.zeros(n_pos + n_neg)
        for k in range(params.max_features_per_stage):
            # genetic search for the best feature under the current weights
            feats = _random_features(params.population, params.size, rng)
            best = None
            for gen in range(params.generations):
                t_gen = time.perf_counter()
                resp = feature_responses(flat, *feats, params.size)
                err = np.einsum("n,nf->f", w, resp != y[:, None])
                order = np.argsort(err)
                if best is None or err[order[0]] < best[0]:
                    best = (float(err[order[0]]),
                            tuple(a[order[0]].copy() for a in feats))
                # next generation: elite + mutations of the elite
                elite = tuple(a[order[: params.population // 2]]
                              for a in feats)
                mutated = _mutate(elite, params.size, rng)
                feats = tuple(np.concatenate([e, m]) for e, m in
                              zip(elite, mutated))
                generations += 1
                generation_s += time.perf_counter() - t_gen
            err0, ft = best
            err0 = min(max(err0, 1e-6), 0.49)
            resp = feature_responses(flat, *(a[None] for a in ft),
                                     params.size)[:, 0]
            a = 0.5 * np.log((1 - err0) / err0)
            alphas.append((-a, a))
            stage_of.append(s)
            F_px.append(ft[0]); F_py.append(ft[1]); F_pz.append(ft[2])
            F_nx.append(ft[3]); F_ny.append(ft[4]); F_nz.append(ft[5])
            rates += np.where(resp, a, -a)
            correct = resp == y
            w = w * np.exp(np.where(correct, -a, a))
            w /= w.sum()
            # stop early when the stage is already clean
            thr = rates[:n_pos].min() - params.threshold_slack
            fpr = (rates[n_pos:] > thr).mean() if n_neg else 0.0
            if fpr < params.neg_crit:
                break
        thr = float(rates[:n_pos].min()) - params.threshold_slack
        thresholds.append(thr)
        stage_s.append(time.perf_counter() - t_stage)
        # keep only negatives this stage passes (bootstrap analog)
        keep = rates[n_pos:] > thr
        if not keep.any() or s == params.n_stages - 1:
            break
        neg = neg[keep]
        rows = np.concatenate([np.arange(n_pos), n_pos + np.nonzero(keep)[0]])
        flat = flat[torch.from_numpy(rows).to(dev)]
        n_neg = len(neg)
        y = np.concatenate([np.ones(n_pos, bool), np.zeros(n_neg, bool)])
    if timings is not None:
        timings.update(stage_s=stage_s, generations=generations,
                       generation_s=generation_s)

    return bbf_mod.BbfCascade(
        width=params.size[0], height=params.size[1],
        stage_of=np.array(stage_of, np.int32), n_stages=len(thresholds),
        thresholds=np.array(thresholds, np.float32),
        alphas=np.array(alphas, np.float32),
        px=np.stack(F_px), py=np.stack(F_py), pz=np.stack(F_pz),
        nx=np.stack(F_nx), ny=np.stack(F_ny), nz=np.stack(F_nz))
