"""SCD (SURF-cascade) face detector (counterpart of ccv_tpu/detectors/scd.py;
reference: lib/ccv_scd.c).

The main path, per image:

1. host: plan the pyramid levels (``_level_specs``);
2. per octave, on the device, per level: INTER_AREA resample, margin pad,
   the 8-channel gradient map (``scd_map_cf8``) and its zero-padded SAT
   (``_sat_cf8``), stacked into one ``(L, 8, H1, W1)`` tensor;
3. one launch of the cascade kernel K1 per octave over every stride-4
   window of every level (ops/kernels/scd_cascade.py);
4. ``sample_down`` to the next octave;
5. host: one device->host copy of the per-level ``passed`` / ``conf``
   planes, windows -> rects in window order (``_comps_from_levels``), then
   ``merge_detections``.

``detect_async`` queues steps 1-4 without waiting for the device;
``detect_collect`` does step 5. Cascade files are the reference's SQLite
format (ccv_scd.c:1547), read with Python's sqlite3.
"""

from __future__ import annotations

import dataclasses
import math
import sqlite3
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ccv_tpu_torch import device as _device
from ccv_tpu_torch.core.dense_matrix import as_array
from ccv_tpu_torch.detectors.common import Comp, merge_detections
from ccv_tpu_torch.ops import basic, resample
from ccv_tpu_torch.ops.kernels import scd_cascade


@dataclasses.dataclass
class ScdClassifierCascade:
    """Loaded cascade: feature tables flattened across stages."""

    width: int
    height: int
    margin: tuple  # (left, top, right, bottom)
    stage_counts: np.ndarray      # (n_stages,)
    thresholds: np.ndarray        # (n_stages,)
    sx: np.ndarray                # (n_features, 4)
    sy: np.ndarray
    dx: np.ndarray
    dy: np.ndarray
    bias: np.ndarray              # (n_features,)
    w: np.ndarray                 # (n_features, 32)
    stage_of: np.ndarray          # (n_features,) stage index per feature

    @property
    def n_stages(self):
        return len(self.stage_counts)

    @property
    def n_features(self):
        return len(self.bias)


@dataclasses.dataclass
class ScdParams:
    """ccv_scd_default_params twin (ccv_scd.c:20)."""

    interval: int = 5
    min_neighbors: int = 1
    step_through: int = 4
    size: tuple = (48, 48)  # (width, height)


def load_cascade(path: str) -> ScdClassifierCascade:
    con = sqlite3.connect(path)
    try:
        count, ml, mt, mr, mb, w_, h_ = con.execute(
            "SELECT count, margin_left, margin_top, margin_right,"
            " margin_bottom, size_width, size_height FROM cascade_params"
            " WHERE id = 0").fetchone()
        stage_counts, thresholds = [], []
        for _, cnt, th in con.execute(
                "SELECT classifier, count, threshold FROM classifier_params"
                " ORDER BY classifier"):
            stage_counts.append(cnt)
            thresholds.append(th)
        rows = con.execute(
            "SELECT classifier, id, sx_0, sy_0, dx_0, dy_0, sx_1, sy_1, dx_1,"
            " dy_1, sx_2, sy_2, dx_2, dy_2, sx_3, sy_3, dx_3, dy_3, bias, w"
            " FROM feature_params ORDER BY classifier, id").fetchall()
    finally:
        con.close()
    sx, sy, dx, dy, bias, w, stage_of = [], [], [], [], [], [], []
    for r in rows:
        stage_of.append(r[0])
        sx.append([r[2], r[6], r[10], r[14]])
        sy.append([r[3], r[7], r[11], r[15]])
        dx.append([r[4], r[8], r[12], r[16]])
        dy.append([r[5], r[9], r[13], r[17]])
        bias.append(r[18])
        w.append(np.frombuffer(r[19], dtype=np.float32, count=32))
    return ScdClassifierCascade(
        width=w_, height=h_, margin=(ml, mt, mr, mb),
        stage_counts=np.array(stage_counts, np.int32),
        thresholds=np.array(thresholds, np.float32),
        sx=np.array(sx, np.int32), sy=np.array(sy, np.int32),
        dx=np.array(dx, np.int32), dy=np.array(dy, np.int32),
        bias=np.array(bias, np.float32), w=np.stack(w).astype(np.float32),
        stage_of=np.array(stage_of, np.int32))


def cascade_from_numpy(fields: dict) -> ScdClassifierCascade:
    """A cascade from the numpy fields of a ``ccv_tpu`` ScdClassifierCascade
    (width, height, margin, stage_counts, thresholds, sx, sy, dx, dy, bias,
    w, stage_of); the arrays are copied."""
    ints = ("stage_counts", "sx", "sy", "dx", "dy", "stage_of")
    floats = ("thresholds", "bias", "w")
    return ScdClassifierCascade(
        width=int(fields["width"]), height=int(fields["height"]),
        margin=tuple(int(m) for m in fields["margin"]),
        **{k: np.array(fields[k], np.int32) for k in ints},
        **{k: np.array(fields[k], np.float32) for k in floats})


def cascade_tables(cascade: ScdClassifierCascade
                   ) -> scd_cascade.CascadeTables:
    """The kernel's tables for ``cascade``, built once and kept on it."""
    tabs = getattr(cascade, "_tables", None)
    if tabs is None:
        tabs = scd_cascade.build_tables(
            cascade.thresholds, cascade.sx, cascade.sy, cascade.dx,
            cascade.dy, cascade.bias, cascade.w, cascade.stage_of)
        cascade._tables = tabs
    return tabs


# ---------------------------------------------------------------------------
# feature map and SAT
# ---------------------------------------------------------------------------

def scd_map_cf8(img: torch.Tensor) -> torch.Tensor:
    """Channels-first (8, H, W) float32 gradient map: the first 8 scd_map
    channels [dx, dy, du, dv, |dx|, |dy|, |du|, |dv|], the only ones the
    cascade features read (ccv_scd.c:325, :445). blur(0.5) -> four 3-tap
    sobels -> per-pixel strongest channel for color images."""
    blurred = basic.blur(img, sigma=0.5)
    grads = [basic.sobel(blurred, 1, 0), basic.sobel(blurred, 0, 1),
             basic.sobel(blurred, 1, 1), basic.sobel(blurred, -1, 1)]
    color = img.dim() == 3 and img.shape[-1] == 3
    chans = []
    for gim in grads:
        gf = gim.to(torch.float32)
        if color:
            # strongest channel by |value|; strict-greater keeps the first
            # channel on ties, as the reference does
            g0, g1, g2 = gf[..., 0], gf[..., 1], gf[..., 2]
            a0, a1, a2 = g0.abs(), g1.abs(), g2.abs()
            v = torch.where(a1 > a0, g1, g0)
            gf = torch.where(a2 > torch.maximum(a0, a1), g2, v)
        elif gf.dim() == 3:
            gf = gf[..., 0]
        chans.append(gf)
    return torch.stack(chans + [c.abs() for c in chans], dim=0)


def _sat_cf8(x: torch.Tensor) -> torch.Tensor:
    """Zero-padded summed-area table of a channels-first (C, H, W) map:
    (C, H+1, W+1) float32, summed along W then H as ccv_tpu does."""
    C, H, W = x.shape
    out = x.new_zeros((C, H + 1, W + 1), dtype=torch.float32)
    out[:, 1:, 1:] = torch.cumsum(torch.cumsum(x.to(torch.float32), dim=2),
                                  dim=1)
    return out


# ---------------------------------------------------------------------------
# the pyramid plan and its device prolog
# ---------------------------------------------------------------------------

def _level_specs(H: int, W: int, cascade: ScdClassifierCascade,
                 params: ScdParams):
    """Host-side plan: one (octave, k, rows, cols, ny, nx, scale) per level."""
    eff_h = cascade.height - cascade.margin[1] - cascade.margin[3]
    eff_w = cascade.width - cascade.margin[0] - cascade.margin[2]
    scale_upto = max(1, int(math.log2(min(H / eff_h, W / eff_w))) + 1)
    scale_ratio = 2.0 ** (1.0 / (params.interval + 1))
    specs = []
    oh, ow = H, W
    for octave in range(scale_upto):
        scale = 1.0
        for k in range(params.interval + 1):
            rows = int(oh / scale + 0.5)
            cols = int(ow / scale + 0.5)
            if rows >= cascade.height and cols >= cascade.width:
                mrows = rows + cascade.margin[1] + cascade.margin[3]
                mcols = cols + cascade.margin[0] + cascade.margin[2]
                step = params.step_through
                ny = max(0, -(-(mrows - cascade.height) // step))
                nx = max(0, -(-(mcols - cascade.width) // step))
                if ny and nx:
                    specs.append((octave, k, rows, cols, ny, nx, scale))
            scale *= scale_ratio
        oh, ow = oh // 2, ow // 2
    return tuple(specs), scale_upto


def _octave_sats(src: torch.Tensor, lspecs, margin) -> torch.Tensor:
    """(L, 8, H1, W1) SAT stack of one octave's levels, zero-padded to the
    largest: per level, INTER_AREA resample of the octave source -> margin
    pad -> scd_map_cf8 -> _sat_cf8."""
    sats = []
    for (k, rows, cols, _ny, _nx) in lspecs:
        image = src if k == 0 else resample.resample(
            src, rows=rows, cols=cols, rows_scale=rows / src.shape[0],
            cols_scale=cols / src.shape[1], interp=resample.INTER_AREA)
        if any(margin):
            image = F.pad(image, (0, 0, margin[0], margin[2], margin[1],
                                  margin[3]))
        sats.append(_sat_cf8(scd_map_cf8(image)))
    H1 = max(s.shape[1] for s in sats)
    W1 = max(s.shape[2] for s in sats)
    if len(sats) == 1:
        return sats[0][None]
    out = sats[0].new_zeros((len(sats), 8, H1, W1))
    for i, s in enumerate(sats):
        out[i, :, :s.shape[1], :s.shape[2]] = s
    return out


def octave_sats(img, cascade: ScdClassifierCascade,
                params: Optional[ScdParams] = None,
                device: _device.DeviceLike = None):
    """The host plan and device prolog of ``detect``: returns (specs, it),
    where ``it`` yields (lspecs, sat_l, dims) for every octave that has
    levels, lspecs = (k, rows, cols, ny, nx) per level and dims the (L, 2)
    int64 array of their window grids. Each SAT stack is made only when the
    iterator reaches it."""
    params = params or ScdParams()
    a = _image(img, cascade, params, device)
    specs, scale_upto = _level_specs(a.shape[0], a.shape[1], cascade, params)
    return specs, _octaves(a, specs, scale_upto, cascade.margin)


def _octaves(src: torch.Tensor, specs, scale_upto: int, margin):
    by_octave: dict = {}
    for (octave, k, rows, cols, ny, nx, _scale) in specs:
        by_octave.setdefault(octave, []).append((k, rows, cols, ny, nx))
    for octave in range(scale_upto):
        lspecs = by_octave.get(octave, [])
        if lspecs:
            dims = np.array([(ny, nx) for (*_r, ny, nx) in lspecs], np.int64)
            yield lspecs, _octave_sats(src, lspecs, margin), dims
        if octave < scale_upto - 1:
            src = resample.sample_down(src)


def _image(img, cascade: ScdClassifierCascade, params: ScdParams,
           device: _device.DeviceLike) -> torch.Tensor:
    a = as_array(img, device)
    if a.dim() == 2:
        a = a[..., None]
    size_w, size_h = params.size
    up_ratio = max(1.0, cascade.width / size_w, cascade.height / size_h)
    if up_ratio - 1.0 > 1e-4:
        raise NotImplementedError(
            f"up-scaling by {up_ratio} (INTER_CUBIC) is not ported yet: "
            f"use params.size >= the cascade's {cascade.width}x"
            f"{cascade.height}")
    return a


# ---------------------------------------------------------------------------
# detect
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Pending:
    """A detect_async dispatch: the packed planes on their way to the host."""

    host: torch.Tensor            # flat float32, per octave (2, L, NY, NX)
    ready: Optional[torch.cuda.Event]
    layout: list                  # per octave (offset, L, NY, NX)
    specs: tuple
    eff_w: int
    eff_h: int
    params: ScdParams


def detect_async(img, cascade: ScdClassifierCascade,
                 params: Optional[ScdParams] = None,
                 device: _device.DeviceLike = None,
                 evaluate: Optional[Callable] = None) -> _Pending:
    """Queue the pyramid and one cascade launch per octave without waiting
    for the device; returns a handle for detect_collect. ``img`` is
    (H, W[, C]) on ``device`` (default: where a tensor is, else the default
    device). ``evaluate`` replaces the cascade evaluator (same signature as
    ``scd_cascade.cascade_eval_levels``) to compare it with another."""
    params = params or ScdParams()
    evaluate = evaluate or scd_cascade.cascade_eval_levels
    tabs = cascade_tables(cascade)
    last_count = float(cascade.stage_counts[-1])
    specs, octaves = octave_sats(img, cascade, params, device)
    pieces, layout, offset = [], [], 0
    for _lspecs, sat_l, dims in octaves:
        conf, passed = evaluate(sat_l, tabs, params.step_through, dims)
        conf = conf / last_count + (cascade.n_stages - 1)
        pieces.append(torch.stack([passed.to(torch.float32), conf]).reshape(-1))
        layout.append((offset,) + tuple(conf.shape))
        offset += pieces[-1].numel()
    eff_h = cascade.height - cascade.margin[1] - cascade.margin[3]
    eff_w = cascade.width - cascade.margin[0] - cascade.margin[2]
    if not pieces:
        return _Pending(torch.zeros(0), None, [], specs, eff_w, eff_h, params)
    packed = torch.cat(pieces) if len(pieces) > 1 else pieces[0]
    ready = None
    if packed.device.type == "cuda":
        # start the one device->host copy now, into pinned memory, so a
        # caller pipelining images overlaps it with the next dispatch
        host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
        host.copy_(packed, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(packed.device))
    else:
        host = packed
    return _Pending(host, ready, layout, specs, eff_w, eff_h, params)


def _comps_from_levels(outs, specs, eff_w: int, eff_h: int,
                       step: int) -> List[Comp]:
    """Host edge: per-level (passed, conf) planes -> Comp list, levels in
    ``specs`` order and windows in row-major order within a level. The
    rect arithmetic is ccv_tpu's, vectorised: float64 then truncation
    toward zero, as Python's int() does."""
    comps: List[Comp] = []
    for spec, (passed, conf) in zip(specs, outs):
        (octave, _k, _rows, _cols, _ny, nx, scale) = spec
        sc = scale * (1 << octave)
        idx = np.flatnonzero(passed)
        wy, wx = np.divmod(idx, nx)
        xs = ((wx * step + 0.5) * sc - 0.5).astype(np.int64).tolist()
        ys = ((wy * step + 0.5) * sc - 0.5).astype(np.int64).tolist()
        width, height = int(eff_w * sc), int(eff_h * sc)
        comps.extend(
            Comp(x=x, y=y, width=width, height=height, confidence=c,
                 classification_id=1)
            for x, y, c in zip(xs, ys, conf.reshape(-1)[idx].tolist()))
    return comps


def level_planes(handle: _Pending):
    """Wait for a dispatch; per level in specs order, (passed (ny, nx) bool,
    conf (ny, nx) float32) numpy planes."""
    if handle.ready is not None:
        handle.ready.synchronize()
    arr = handle.host.numpy()
    outs = []
    for offset, L, NY, NX in handle.layout:
        grid = arr[offset:offset + 2 * L * NY * NX].reshape(2, L, NY, NX)
        outs.extend(grid[:, li] for li in range(L))
    return [(g[0, :ny, :nx] != 0.0, g[1, :ny, :nx])
            for g, (*_r, ny, nx, _s) in zip(outs, handle.specs)]


def detect_collect(handle: _Pending) -> List[Comp]:
    """Wait for a detect_async dispatch and run the host-edge grouping."""
    comps = _comps_from_levels(level_planes(handle), handle.specs,
                               handle.eff_w, handle.eff_h,
                               handle.params.step_through)
    return merge_detections(comps, handle.params.min_neighbors)


def detect(img, cascade: ScdClassifierCascade,
           params: Optional[ScdParams] = None,
           device: _device.DeviceLike = None,
           evaluate: Optional[Callable] = None) -> List[Comp]:
    """ccv_scd_detect_objects twin (ccv_scd.c:1653) for a single cascade."""
    return detect_collect(detect_async(img, cascade, params, device,
                                       evaluate))
