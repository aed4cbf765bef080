"""SCD cascade training, the scdcreate twin (counterpart of
ccv_tpu/train/scd.py; reference: lib/ccv_scd.c:1259
ccv_scd_classifier_cascade_new, gentle AdaBoost over SURF-box stumps).

- ``stump_features``: the reference's dense 4x1 / 1x4 / 2x2 box grids
  (_ccv_scd_stump_features, ccv_scd.c:608), as ``ccv_tpu`` lists them;
- ``precompute_feature_vectors``: every (example, feature) SURF vector at
  once, (N, F, 32): the first 8 channels of ``detectors.scd``'s map, their
  zero-padded SAT (``core.algebra.sat``, ``ccv_tpu``'s order of sums), the
  4-corner box sums, L2 normalised, clipped at theta, normalised again;
- ``_train_all_stumps``: the logistic stump of every feature at once on the
  weighted gentle-AdaBoost loss sum_n w_n (y_n - tanh(f / 2))^2 + C |W|_1,
  f = fv . W + B (the reference runs conjugate gradient per feature,
  ccv_scd.c:825), by ``ccv_tpu``'s Adam without bias correction. The
  gradient is written out (two batched products over the (F, N, 32) table
  a step) rather than taken by autograd;
- ``train_cascade``: the stages, the hit-rate thresholds, the AUC early
  stop and the negatives a stage rejects dropped, as ``ccv_tpu`` does;
- ``write_cascade``: the SQLite schema both packages' ``load_cascade``
  (and the reference's scddetect) read.

No kernel of the port's own: ``ccv_tpu``'s trainer is XLA ops, these are
torch ops. The feature table lives on ``device`` (default: the card):
at the published 40 x 40 patch F is 1,631, so 4,000 examples take 0.84 GB
in float32. ``ccv_tpu`` draws each round's starting W and B with
``jax.random``; the port draws them uniform(-1, 1) from a ``torch.Generator``
on the CPU seeded with ``params.seed`` (so the card and the CPU start
equal), or takes them from the caller (``init``).
"""

from __future__ import annotations

import dataclasses
import math
import sqlite3
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ccv_tpu_torch import device as _device
from ccv_tpu_torch.core import algebra
from ccv_tpu_torch.detectors import scd as scd_mod

_THETA = 2.0 / math.sqrt(32.0)  # L2Hys clamp
_CHUNK = 512                     # examples a precompute pass

# init(F) -> (W (F, 32), B (F,)): the starting stumps of one boosting round
Init = Callable[[int], Tuple[torch.Tensor, torch.Tensor]]


@dataclasses.dataclass
class ScdTrainParams:
    """ccv_scd_train_param_t twin (subset; stop criteria flattened)."""

    size: Tuple[int, int] = (40, 40)        # (width, height)
    feature_base: Tuple[int, int] = (8, 8)
    feature_range_through: int = 4
    feature_step_through: int = 4
    boosting: int = 4                        # max stages
    hit_rate: float = 0.995
    false_positive_rate: float = 0.5
    accu_false_positive_rate: float = 1e-3
    auc_crit: float = 1e-5
    maximum_feature: int = 16
    prune_stage: int = 3
    prune_feature: int = 4
    C: float = 0.002
    train_steps: int = 200                   # Adam steps per boosting round
    learning_rate: float = 0.05
    seed: int = 0


def stump_features(params: ScdTrainParams) -> np.ndarray:
    """_ccv_scd_stump_features twin: (F, 4 boxes, 4) int32 of (sx, sy, dx,
    dy) per box."""
    W, H = params.size
    base_w, base_h = params.feature_base
    rt, st = params.feature_range_through, params.feature_step_through
    out = []
    for w in range(base_w, W + 1, rt):
        if w % 4 == 0:  # 4x1
            h = w // 4
            for x in range(0, W - w + 1, st):
                for y in range(0, H - h + 1, st):
                    q = w // 4
                    out.append([(x + i * q, y, x + (i + 1) * q, y + h)
                                for i in range(4)])
    for h in range(base_h, H + 1, rt):
        if h % 4 == 0:  # 1x4
            w = h // 4
            for x in range(0, W - w + 1, st):
                for y in range(0, H - h + 1, st):
                    q = h // 4
                    out.append([(x, y + i * q, x + w, y + (i + 1) * q)
                                for i in range(4)])
    for w in range(base_w, W + 1, rt):
        for h in range(base_h, H + 1, rt):
            if w % 2 or h % 2:
                continue
            if not (w == h or w == h * 2 or w * 2 == h or w * 2 == h * 3
                    or w * 3 == h * 2):
                continue
            for x in range(0, W - w + 1, st):
                for y in range(0, H - h + 1, st):
                    hw, hh = w // 2, h // 2
                    out.append([(x, y, x + hw, y + hh),
                                (x, y + hh, x + hw, y + h),
                                (x + hw, y, x + w, y + hh),
                                (x + hw, y + hh, x + w, y + h)])
    return np.array(out, np.int32)  # (F, 4, (sx, sy, dx, dy))


def _patch_sats(patches: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) uint8 -> (N, H+1, W+1, 8) float32 zero-padded SATs of
    the 8 gradient channels of the SCD map."""
    maps = scd_mod.scd_map_cf8(patches).permute(0, 2, 3, 1)
    return algebra.sat(maps, padding=algebra.PADDING_ZERO)


def _normalise(surf: torch.Tensor) -> torch.Tensor:
    inv = 1.0 / (torch.sqrt((surf * surf).sum(-1, keepdim=True)) + 1e-6)
    return surf * inv


def precompute_feature_vectors(patches, feats: np.ndarray,
                               device: _device.DeviceLike = None
                               ) -> torch.Tensor:
    """(N examples, F features, 32) float32 normalised SURF vectors, the fv
    table of _ccv_scd_precompute_feature_vectors (ccv_scd.c:700), for
    (N, H, W[, C]) uint8 patches, on ``device`` (default: the card, or the
    patches' device when they are a tensor)."""
    x = patches if isinstance(patches, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(patches))
    dev = _device.resolve(device, x if isinstance(patches, torch.Tensor)
                          else None)
    x = x.to(dev)
    if x.dim() == 3:
        x = x[..., None]
    f = torch.as_tensor(np.asarray(feats), dtype=torch.int64, device=dev)
    sx, sy, dx, dy = f[..., 0], f[..., 1], f[..., 2], f[..., 3]
    n, nf = x.shape[0], f.shape[0]
    out = torch.empty((n, nf, 32), dtype=torch.float32, device=dev)
    for lo in range(0, n, _CHUNK):
        sats = _patch_sats(x[lo:lo + _CHUNK])
        box = (sats[:, dy, dx] - sats[:, sy, dx] - sats[:, dy, sx]
               + sats[:, sy, sx])                      # (n, F, 4, 8)
        surf = _normalise(box.reshape(box.shape[0], nf, 32))
        out[lo:lo + _CHUNK] = _normalise(surf.clamp(-_THETA, _THETA))
    return out


def _train_all_stumps(fvt: torch.Tensor, y: torch.Tensor,
                      weights: torch.Tensor, C: float, steps: int, lr: float,
                      init: Tuple[torch.Tensor, torch.Tensor]):
    """(W (F, 32), B (F,), werr (F,)): every feature's stump trained at
    once from ``init`` = (W, B) on the weighted gentle-AdaBoost loss
    (ccv_scd.c:757), werr the weighted squared error at the last step's
    parameters before its update (as ``ccv_tpu`` returns it).

    fvt: (F, N, 32) float32, the feature table feature-major so each
    step's products read it contiguously; y: (N,) of +-1; weights: (N,)
    summing to 1; all on one device."""
    W, B = (t.to(fvt.device, torch.float32).clone() for t in init)
    mW, vW = torch.zeros_like(W), torch.zeros_like(W)
    mB, vB = torch.zeros_like(B), torch.zeros_like(B)
    yw, werr = y[:, None], None
    wts = weights[:, None]
    for _ in range(steps):
        logit = torch.bmm(fvt, W[:, :, None])[..., 0].T + B   # (N, F)
        h = torch.tanh(0.5 * logit)
        r = yw - h
        wr = wts * r
        werr = (wr * r).sum(0)
        # d/dlogit of w (y - h)^2 = -2 w (y - h) * (1 - h^2) / 2
        g = -wr * (1.0 - h * h)
        gW = torch.bmm(g.T[:, None, :], fvt)[:, 0] + C * torch.sign(W)
        gB = g.sum(0)
        for p, m, v, gr in ((W, mW, vW, gW), (B, mB, vB, gB)):
            m.mul_(0.9).add_(0.1 * gr)
            v.mul_(0.999).add_(0.001 * gr * gr)
            p.sub_(lr * m / (torch.sqrt(v) + 1e-8))
    return W, B, werr


def uniform_init(seed: int) -> Init:
    """The port's starting stumps: each round draws W (F, 32) and then B
    (F,) uniform in [-1, 1) from one CPU ``torch.Generator`` seeded with
    ``seed``, so any device starts from the same values."""
    gen = torch.Generator().manual_seed(seed)

    def draw(nf: int):
        w = torch.empty((nf, 32), dtype=torch.float32).uniform_(
            -1.0, 1.0, generator=gen)
        b = torch.empty((nf,), dtype=torch.float32).uniform_(
            -1.0, 1.0, generator=gen)
        return w, b
    return draw


def _auc(s, n_pos):
    """_ccv_scd_auc twin."""
    pos = np.asarray(s[:n_pos])
    neg = np.asarray(s[n_pos:])
    order = np.concatenate([pos, neg])
    labels = np.concatenate([np.ones_like(pos), np.zeros_like(neg)])
    idx = np.argsort(-order, kind="stable")
    labels = labels[idx]
    tp = np.cumsum(labels)
    fp = np.cumsum(1 - labels)
    tpr = tp / max(len(pos), 1)
    fpr = fp / max(len(neg), 1)
    return float(np.trapezoid(tpr, fpr))


def _threshold_at_hit_rate(s, n_pos, hit_rate):
    """_ccv_scd_threshold_at_hit_rate twin: the largest threshold keeping
    `hit_rate` of positives; returns (threshold, tpr, fpr)."""
    pos = np.sort(np.asarray(s[:n_pos]))
    neg = np.asarray(s[n_pos:])
    k = int((1.0 - hit_rate) * n_pos)
    threshold = pos[min(k, n_pos - 1)] - 1e-6
    tpr = float((pos > threshold).mean())
    fpr = float((neg > threshold).mean()) if len(neg) else 0.0
    return threshold, tpr, fpr


def _labels(n_pos: int, n_neg: int, dev) -> torch.Tensor:
    return torch.cat([torch.ones(n_pos), -torch.ones(n_neg)]).to(dev)


def train_cascade(positives, negatives,
                  params: Optional[ScdTrainParams] = None,
                  device: _device.DeviceLike = None,
                  init: Optional[Init] = None,
                  timings: Optional[dict] = None
                  ) -> scd_mod.ScdClassifierCascade:
    """ccv_scd_classifier_cascade_new twin on in-memory patch sets.

    positives / negatives: (N, H, W[, C]) uint8 patches of params.size.
    The feature table and the stump training live on ``device`` (default:
    the card), in float32 as ``ccv_tpu``'s. ``init`` gives each boosting
    round's
    starting stumps (default ``uniform_init(params.seed)``). ``timings``,
    if given, receives "stage_s" (seconds of each stage, host clock) and
    "adam_steps" (steps run). Returns a ScdClassifierCascade that
    ``detectors.scd.detect`` and ``write_cascade`` take."""
    params = params or ScdTrainParams()
    dev = _device.resolve(device)
    init = init or uniform_init(params.seed)
    feats = stump_features(params)
    pos = np.asarray(positives)
    neg = np.asarray(negatives)
    n_pos, n_neg = len(pos), len(neg)
    fv = precompute_feature_vectors(np.concatenate([pos, neg]), feats, dev)
    fvt = fv.transpose(0, 1).contiguous()     # (F, N, 32)
    del fv
    y = _labels(n_pos, n_neg, dev)
    stage_s: List[float] = []
    steps = 0

    stages: List[dict] = []
    accu_fp = 1.0
    for t in range(params.boosting):
        t0 = time.perf_counter()
        pw = np.full(n_pos, 0.5 / n_pos)
        nw = np.full(n_neg, 0.5 / n_neg)
        s = np.zeros(n_pos + n_neg)
        chosen: List[dict] = []
        auc_prev = 0.0
        max_feat = (params.prune_feature if t < params.prune_stage
                    else params.maximum_feature)
        for k in range(max_feat):
            weights = torch.from_numpy(np.concatenate([pw, nw]).astype(
                np.float32)).to(dev)
            W, B, werr = _train_all_stumps(
                fvt, y, weights, params.C, params.train_steps,
                params.learning_rate, init(fvt.shape[0]))
            steps += params.train_steps
            best = int(torch.argmin(werr))
            w_best, b_best = W[best], float(B[best])
            logit = (fvt[best] @ w_best).cpu().numpy() + b_best
            h = np.tanh(0.5 * logit)
            s = s + h
            auc = _auc(s, n_pos)
            chosen.append(dict(feat=feats[best], w=w_best.cpu().numpy(),
                               bias=b_best))
            _, tpr, fpr = _threshold_at_hit_rate(s, n_pos, params.hit_rate)
            if (auc - auc_prev < params.auc_crit
                    and fpr < params.false_positive_rate):
                auc_prev = auc
                break
            auc_prev = auc
            # gentle AdaBoost re-weighting (ccv_scd.c:1340-1357)
            pw = pw * np.exp(-h[:n_pos])
            nw = nw * np.exp(h[n_pos:])
            pw *= 0.5 / pw.sum()
            nw *= 0.5 / max(nw.sum(), 1e-12)
        threshold, tpr, fpr = _threshold_at_hit_rate(s, n_pos,
                                                     params.hit_rate)
        stages.append(dict(features=chosen, threshold=float(threshold)))
        accu_fp *= fpr
        stage_s.append(time.perf_counter() - t0)
        # drop the negatives this stage rejects (the in-memory analog of
        # the reference's hard mining: keep only surviving negatives)
        keep = np.asarray(s[n_pos:]) > threshold
        if accu_fp < params.accu_false_positive_rate or not keep.any():
            break
        neg = neg[keep]
        rows = torch.from_numpy(np.concatenate(
            [np.arange(n_pos), n_pos + np.flatnonzero(keep)])).to(dev)
        fvt = fvt[:, rows].contiguous()
        n_neg = len(neg)
        y = _labels(n_pos, n_neg, dev)
    if timings is not None:
        timings.update(stage_s=stage_s, adam_steps=steps)
    return _pack(stages, params)


def _pack(stages: List[dict], params: ScdTrainParams
          ) -> scd_mod.ScdClassifierCascade:
    """The detect-side cascade struct of the trained stages."""
    sx, sy, dx, dy, bias, w, stage_of, counts, thresholds = \
        [], [], [], [], [], [], [], [], []
    for si, stage in enumerate(stages):
        counts.append(len(stage["features"]))
        thresholds.append(stage["threshold"])
        for f in stage["features"]:
            boxes = f["feat"]  # (4, (sx, sy, dx, dy))
            sx.append(boxes[:, 0])
            sy.append(boxes[:, 1])
            dx.append(boxes[:, 2])
            dy.append(boxes[:, 3])
            bias.append(f["bias"])
            w.append(f["w"])
            stage_of.append(si)
    W_, H_ = params.size
    return scd_mod.ScdClassifierCascade(
        width=W_, height=H_, margin=(0, 0, 0, 0),
        stage_counts=np.array(counts, np.int32),
        thresholds=np.array(thresholds, np.float32),
        sx=np.stack(sx).astype(np.int32), sy=np.stack(sy).astype(np.int32),
        dx=np.stack(dx).astype(np.int32), dy=np.stack(dy).astype(np.int32),
        bias=np.array(bias, np.float32), w=np.stack(w).astype(np.float32),
        stage_of=np.array(stage_of, np.int32))


def write_cascade(cascade: scd_mod.ScdClassifierCascade, path: str) -> None:
    """ccv_scd_classifier_cascade_write twin (ccv_scd.c:1451): the SQLite
    schema ``detectors.scd.load_cascade`` (and the reference's scddetect)
    read."""
    con = sqlite3.connect(path)
    try:
        con.executescript(
            "CREATE TABLE IF NOT EXISTS cascade_params (id INTEGER PRIMARY"
            " KEY ASC, count INTEGER, margin_left INTEGER, margin_top"
            " INTEGER, margin_right INTEGER, margin_bottom INTEGER,"
            " size_width INTEGER, size_height INTEGER);"
            "CREATE TABLE IF NOT EXISTS classifier_params (classifier"
            " INTEGER PRIMARY KEY ASC, count INTEGER, threshold REAL);"
            "CREATE TABLE IF NOT EXISTS feature_params (classifier INTEGER,"
            " id INTEGER, sx_0 INTEGER, sy_0 INTEGER, dx_0 INTEGER, dy_0"
            " INTEGER, sx_1 INTEGER, sy_1 INTEGER, dx_1 INTEGER, dy_1"
            " INTEGER, sx_2 INTEGER, sy_2 INTEGER, dx_2 INTEGER, dy_2"
            " INTEGER, sx_3 INTEGER, sy_3 INTEGER, dx_3 INTEGER, dy_3"
            " INTEGER, bias REAL, w BLOB, UNIQUE (classifier, id));")
        con.execute(
            "REPLACE INTO cascade_params VALUES (0, ?, ?, ?, ?, ?, ?, ?)",
            (cascade.n_stages, *cascade.margin, cascade.width,
             cascade.height))
        for si in range(cascade.n_stages):
            con.execute("REPLACE INTO classifier_params VALUES (?, ?, ?)",
                        (si, int(cascade.stage_counts[si]),
                         float(cascade.thresholds[si])))
        fid = {}
        for i in range(cascade.n_features):
            si = int(cascade.stage_of[i])
            j = fid.get(si, 0)
            fid[si] = j + 1
            vals = [si, j]
            for b in range(4):
                vals += [int(cascade.sx[i, b]), int(cascade.sy[i, b]),
                         int(cascade.dx[i, b]), int(cascade.dy[i, b])]
            vals += [float(cascade.bias[i]),
                     cascade.w[i].astype(np.float32).tobytes()]
            con.execute(
                "REPLACE INTO feature_params VALUES"
                " (?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?)", vals)
        con.commit()
    finally:
        con.close()
