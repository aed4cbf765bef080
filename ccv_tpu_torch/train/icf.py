"""ICF cascade training, the icfcreate twin (counterpart of
ccv_tpu/train/icf.py; reference: lib/ccv_icf.c
ccv_icf_classifier_cascade_new, discrete AdaBoost over depth-2 trees of
random integral-channel features).

- ``random_features``: random (channel, box, alpha) pairs as
  _ccv_icf_randomize_feature (ccv_icf.c:423, at most 2 boxes), drawn from a
  ``np.random.Generator`` in ``ccv_tpu``'s order, so both packages draw the
  same features from one seed;
- ``precompute_feature_values``: every (example, feature) value at once,
  (N, F): the channel map of ``detectors.icf`` fed the uint8 patches (its
  integer sobel path, as the detector sees them), its zero-padded SAT
  (``core.algebra.sat``), the gathered box sums times alpha;
- ``_best_split``: the best (feature, threshold, polarity) over every
  feature at once: a stable argsort of each feature's values, the weighted
  label sums scanned in ``ccv_tpu``'s order (``associative_scan_add``),
  splits between equal values refused;
- ``train_cascade``: depth-2 trees (a root split, then each leaf's best
  split on its share of the weights), discrete AdaBoost's weights and votes
  (alpha = sqrt((1 - r) / r), weigh = +-log(r / (1 - r))), soft-cascade
  thresholds at the lowest positive running vote less a slack;
- ``write_cascade``: ``detectors.icf.write_cascade`` (the text format both
  packages' ``load_cascade`` read); ``optimize_soft_cascade``: icfoptimize's
  thresholds from validation positives.

No kernel of the port's own (``ccv_tpu``'s trainer is XLA ops; ICF has no
Pallas kernel). The values and the split search run on ``device``
(default: the card), in float32 as ``ccv_tpu``'s; the tree bookkeeping on
the host, in numpy, as ``ccv_tpu``'s.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ccv_tpu_torch import device as _device
from ccv_tpu_torch.core import algebra
from ccv_tpu_torch.detectors import icf as icf_mod

write_cascade = icf_mod.write_cascade
_CHUNK = 512   # examples a precompute pass


@dataclasses.dataclass
class IcfTrainParams:
    """ccv_icf_new_param_t twin (subset)."""

    size: Tuple[int, int] = (30, 60)      # (width, height) of the patch
    margin: Tuple[int, int, int, int] = (0, 0, 0, 0)
    feature_size: int = 2000              # random candidate pool
    weak_classifier: int = 32             # boosting rounds
    min_dimension: int = 2
    grayscale: bool = False
    seed: int = 0
    # soft-cascade threshold slack below the min positive cumulative rate
    # (the reference leaves thresholds loose and tightens them later with
    # icfoptimize on validation data)
    threshold_slack: float = 1.0


def random_features(params: IcfTrainParams, rng: np.random.Generator):
    """_ccv_icf_randomize_feature twin, vectorized: a dict of (F,) count,
    (F, 2) channel and alpha, and (F, 2, 2) sat0 / sat1 corners (x, y)."""
    F = params.feature_size
    W = params.size[0] + params.margin[0] + params.margin[2]
    H = params.size[1] + params.margin[1] + params.margin[3]
    nch = 8 if params.grayscale else 10
    md = params.min_dimension
    count = rng.integers(1, 3, F)
    channel = rng.integers(0, nch, (F, 2))
    sat0 = np.zeros((F, 2, 2), np.int32)
    sat1 = np.zeros((F, 2, 2), np.int32)
    alpha = np.zeros((F, 2), np.float32)
    for i in range(F):
        for q in range(count[i]):
            while True:
                x0, x1 = rng.integers(0, W, 2)
                y0, y1 = rng.integers(0, H, 2)
                w = abs(int(x0) - int(x1)) + 1
                h = abs(int(y0) - int(y1)) + 1
                if w * h >= (md + 1) ** 2 and w >= md and h >= md:
                    break
            sat0[i, q] = (min(x0, x1), min(y0, y1))
            sat1[i, q] = (max(x0, x1), max(y0, y1))
            alpha[i, q] = rng.random() / (w * h)
    return dict(count=count, channel=channel, alpha=alpha, sat0=sat0,
                sat1=sat1)


def _patch_sats(patches: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) uint8 -> (N, H+1, W+1, ch) channel-map SATs. The map is
    fed uint8 as ``detect_objects`` feeds it: training sees the numbers the
    detector will."""
    return algebra.sat(icf_mod.icf_channels(patches),
                       padding=algebra.PADDING_ZERO)


def precompute_feature_values(patches, feats,
                              device: _device.DeviceLike = None
                              ) -> torch.Tensor:
    """(N, F) float32 feature values on ``device`` (default: the card, or
    the patches' device when they are a tensor): the sum over a feature's
    boxes of alpha times the SAT box sum on its channel (beta is learned
    later), for (N, H, W[, C]) uint8 patches."""
    x = patches if isinstance(patches, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(patches))
    dev = _device.resolve(device, x if isinstance(patches, torch.Tensor)
                          else None)
    x = x.to(dev)
    if x.dim() == 3:
        x = x[..., None]

    def t(a, dtype=torch.int64):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)
    s0, s1, ch = t(feats["sat0"]), t(feats["sat1"]), t(feats["channel"])
    # SAT box sums with the +1 zero-padded convention of _ccv_icf_run_feature
    y0, x0 = s0[..., 1], s0[..., 0]
    y1, x1 = s1[..., 1] + 1, s1[..., 0] + 1
    scale = t(feats["alpha"], torch.float32) * (
        torch.arange(2, device=dev)[None, :]
        < t(feats["count"])[:, None])                       # (F, 2)
    out = torch.empty((x.shape[0], s0.shape[0]), dtype=torch.float32,
                      device=dev)
    for lo in range(0, x.shape[0], _CHUNK):
        sat = _patch_sats(x[lo:lo + _CHUNK])
        v = (sat[:, y1, x1, ch] - sat[:, y0, x1, ch] - sat[:, y1, x0, ch]
             + sat[:, y0, x0, ch])                          # (n, F, 2)
        out[lo:lo + _CHUNK] = (v * scale).sum(-1)
    return out


def _best_split(values: torch.Tensor, weights, y):
    """The best (feature, threshold, polarity) over every feature at once.

    values: (N, F) float32; weights: (N,) summing to 1; y: (N,) bool,
    True for a positive (both numpy or tensors; they go to ``values``'s
    device, the weights in float32 as ``ccv_tpu`` takes them). Returns
    (feature index, threshold, polarity, error): the decision
    polarity * (v - threshold) > 0 means positive."""
    dev = values.device
    w = torch.as_tensor(np.asarray(weights), dtype=torch.float32,
                        device=dev)
    yy = torch.as_tensor(np.asarray(y), dtype=torch.bool, device=dev)
    order = torch.argsort(values, dim=0, stable=True)        # (N, F)
    sv = torch.take_along_dim(values, order, dim=0)
    sw, sy = w[order], yy[order]
    W1 = (w * yy).sum()
    W0 = (w * ~yy).sum()
    cum1 = algebra.associative_scan_add(sw * sy, 0)
    cum0 = algebra.associative_scan_add(sw * ~sy, 0)
    # split after position j: the left side is [0 .. j]
    # polarity +1 (right side positive): err = cum1 + (W0 - cum0)
    # polarity -1 (left side positive):  err = cum0 + (W1 - cum1)
    err_p = cum1 + (W0 - cum0)
    err_n = cum0 + (W1 - cum1)
    # no split between equal neighbours
    tie = torch.cat([sv[1:] == sv[:-1],
                     torch.ones((1, values.shape[1]), dtype=torch.bool,
                                device=dev)], 0)
    big = torch.tensor(2.0, dtype=torch.float32, device=dev)
    err_p = torch.where(tie, big, err_p)
    err_n = torch.where(tie, big, err_n)
    err = torch.minimum(err_p, err_n)
    flat = int(torch.argmin(err))
    j, f = divmod(flat, err.shape[1])
    pol = 1.0 if bool(err_p[j, f] <= err_n[j, f]) else -1.0
    j1 = min(j + 1, values.shape[0] - 1)
    thr = float(0.5 * (sv[j, f] + sv[j1, f]))
    return f, thr, pol, float(err[j, f])


def train_cascade(positives, negatives,
                  params: Optional[IcfTrainParams] = None,
                  device: _device.DeviceLike = None) -> icf_mod.IcfCascade:
    """ccv_icf_classifier_cascade_new twin on in-memory (N, H, W[, C])
    uint8 patch sets; the values and the splits on ``device`` (default:
    the card)."""
    params = params or IcfTrainParams()
    rng = np.random.default_rng(params.seed)
    feats = random_features(params, rng)
    pos = np.asarray(positives)
    neg = np.asarray(negatives)
    n_pos, n_neg = len(pos), len(neg)
    values_t = precompute_feature_values(np.concatenate([pos, neg]), feats,
                                         _device.resolve(device))
    values = values_t.cpu().numpy()
    y = np.concatenate([np.ones(n_pos, bool), np.zeros(n_neg, bool)])
    weights = np.where(y, 0.5 / n_pos, 0.5 / n_neg)

    def feature_of(f, thr, pol):
        cnt = int(feats["count"][f])
        return dict(count=cnt,
                    beta=float(-pol * thr),
                    channel=feats["channel"][f, :cnt].tolist(),
                    alpha=(pol * feats["alpha"][f, :cnt]).tolist(),
                    sat0=feats["sat0"][f, :cnt].tolist(),
                    sat1=feats["sat1"][f, :cnt].tolist())

    def decide(f, thr, pol, subset=None):
        v = values[:, f] if subset is None else values[subset, f]
        return pol * (v - thr) > 0

    weaks: List[dict] = []
    rates = np.zeros(n_pos + n_neg)
    for _ in range(params.weak_classifier):
        f0, thr0, pol0, _err = _best_split(values_t, weights, y)
        root_pos = decide(f0, thr0, pol0)
        tree = dict(features=[feature_of(f0, thr0, pol0), None, None],
                    pass_bits=0)
        out = root_pos.copy()
        # leaf refinements: left (root said negative) and right (positive)
        for leaf, side in ((1, ~root_pos), (2, root_pos)):
            sub = np.nonzero(side)[0]
            wsub = weights[side]
            if len(sub) < 4 or len(np.unique(y[side])) < 2:
                continue
            wnorm = wsub / wsub.sum()
            rows = torch.from_numpy(sub).to(values_t.device)
            f1, thr1, pol1, err1 = _best_split(values_t[rows], wnorm,
                                               y[side])
            base_err = (wnorm * (y[side] != (leaf == 2))).sum()
            if err1 < base_err - 1e-9:
                tree["features"][leaf] = feature_of(f1, thr1, pol1)
                tree["pass_bits"] |= (0x2 if leaf == 1 else 0x1)
                out[sub] = decide(f1, thr1, pol1, sub)
        correct = out == y
        rate = float(weights[correct].sum())
        rate = min(max(rate, 1e-6), 1 - 1e-6)
        if rate <= 0.5:
            raise RuntimeError(f"weak classifier {len(weaks)}: weighted "
                               f"accuracy {rate} is no better than chance")
        a = np.sqrt((1 - rate) / rate)
        c = np.log(rate / (1 - rate))
        tree["weigh"] = (-c, c)
        weaks.append(tree)
        weights = weights * np.where(correct, a, 1.0 / a)
        weights /= weights.sum()
        rates += np.where(out, c, -c)
        # soft cascade threshold: keep every positive on the training set,
        # with slack for held-out data (tighten with optimize_soft_cascade)
        tree["threshold"] = float(rates[:n_pos].min()) \
            - params.threshold_slack
    return _pack(weaks, params)


def _pack(weaks: List[dict], params: IcfTrainParams) -> icf_mod.IcfCascade:
    """The detect-side cascade of the trained trees."""
    n = len(weaks)
    W = params.size[0] + params.margin[0] + params.margin[2]
    H = params.size[1] + params.margin[1] + params.margin[3]
    cas = icf_mod.IcfCascade(
        width=W, height=H, grayscale=int(params.grayscale),
        margin=tuple(params.margin), n_weak=n,
        pass_bits=np.zeros(n, np.uint32), weigh=np.zeros((n, 2), np.float32),
        thresholds=np.zeros(n, np.float32),
        channel=np.zeros((n, 3, 2), np.int32),
        alpha=np.zeros((n, 3, 2), np.float32),
        beta=np.zeros((n, 3), np.float32),
        sat0=np.zeros((n, 3, 2, 2), np.int32),
        sat1=np.zeros((n, 3, 2, 2), np.int32))
    for i, wk in enumerate(weaks):
        cas.pass_bits[i] = wk["pass_bits"]
        cas.weigh[i] = wk["weigh"]
        cas.thresholds[i] = wk["threshold"]
        for f in range(3):
            ft = wk["features"][f]
            if ft is None:
                continue
            cas.beta[i, f] = ft["beta"]
            for q in range(ft["count"]):
                cas.channel[i, f, q] = ft["channel"][q]
                cas.alpha[i, f, q] = ft["alpha"][q]
                cas.sat0[i, f, q] = ft["sat0"][q]
                cas.sat1[i, f, q] = ft["sat1"][q]
    return cas


def optimize_soft_cascade(cas: icf_mod.IcfCascade, validates,
                          min_accept: float = 0.98,
                          device: _device.DeviceLike = None) -> None:
    """icfoptimize twin (bin/icfoptimize.c + ccv_icf_classifier_cascade_
    soft): sets the per-tree thresholds in place so that at least
    ``min_accept`` of the validation positives (N, H, W[, C]) survive every
    prefix; the trees run on ``device`` (default: the card)."""
    vals = np.asarray(validates)
    n = len(vals)
    dev = _device.resolve(device)

    def tree_vals(f):
        feats = dict(count=(cas.alpha[:, f] != 0).sum(-1).clip(1, 2),
                     channel=cas.channel[:, f], alpha=cas.alpha[:, f],
                     sat0=cas.sat0[:, f], sat1=cas.sat1[:, f])
        return (precompute_feature_values(vals, feats, dev).cpu().numpy()
                + cas.beta[None, :, f])

    c0, c1, c2 = tree_vals(0), tree_vals(1), tree_vals(2)
    has2 = (cas.pass_bits & 1).astype(bool)
    has1 = (cas.pass_bits & 2).astype(bool)
    pos_branch = np.where(has2[None], c2 > 0, True)
    neg_branch = np.where(has1[None], c1 > 0, False)
    r = np.where(c0 > 0, pos_branch, neg_branch)
    contrib = np.where(r, cas.weigh[None, :, 1], cas.weigh[None, :, 0])
    csum = np.cumsum(contrib, axis=1)  # (n, n_weak)
    k = max(0, int((1.0 - min_accept) * n) - 1)
    thr = np.sort(csum, axis=0)[k] - 1e-6
    cas.thresholds[:] = thr.astype(np.float32)
