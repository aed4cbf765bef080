"""SCD (SURF-cascade) face detector (counterpart of ccv_tpu/detectors/scd.py;
reference: lib/ccv_scd.c).

The main path, per image or per batch of same-shape images:

1. where the cascade is larger than ``params.size``, an INTER_CUBIC
   up-scale of the image on the device (``_image``, not for a batch); host:
   plan the pyramid levels (``_level_specs``);
2. per octave, on the device, per level: INTER_AREA resample, margin pad,
   the 8-channel gradient map (``scd_map_cf8``) and its zero-padded SAT
   (``_sat_cf8``), stacked into one ``(B*L, 8, H1, W1)`` tensor: a batch's
   levels ride the kernels' level axis;
3. per octave, the cascade over every stride-4 window of every level, in
   one of two forms (``form=``):
   - ``"pallas_full"`` (the default): one launch of the full-cascade kernel
     K1 (ops/kernels/scd_cascade.py);
   - ``"pallas"``: the staged cascade (``_staged_eval``, ccv_tpu's
     ``_eval_level``): phase A, the leading stages, and phase B1, the next
     block of stages, each over every window in one launch of kernel K3
     (ops/kernels/scd_phase.py) off one copy of the octave's phase planes;
     one compaction to the first K2 survivors in window order; phase B2,
     the rest, on them as torch ops;
4. ``sample_down`` to the next octave;
5. host: one device->host copy for the image or batch, windows -> rects in
   window order (``_comps_from_levels``), then ``merge_detections``. In the
   staged form a level with more survivors than K2 is run again from its
   octave's source at full capacity (the overflow rerun).

``detect_async`` queues steps 1-4 without waiting for the device;
``detect_collect`` does step 5; ``detect_batch`` does both for a batch.
ccv_tpu's other staged forms (``slices``, ``xla``, ``matmul``) and its
autotuned choice between forms are not ported. Cascade files are the
reference's SQLite format (ccv_scd.c:1547), read with Python's sqlite3.
"""

from __future__ import annotations

import dataclasses
import math
import sqlite3
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ccv_tpu_torch import device as _device
from ccv_tpu_torch.core.dense_matrix import as_array
from ccv_tpu_torch.detectors.common import Comp, merge_detections
from ccv_tpu_torch.device import to_device
from ccv_tpu_torch.ops import basic, resample
from ccv_tpu_torch.ops.kernels import scd_cascade, scd_phase
from ccv_tpu_torch.ops.kernels.scd_cascade import CascadeTables

FORMS = ("pallas_full", "pallas")

# levels of the staged form run again at full capacity because more windows
# survived phases A and B1 than K2 holds (the overflow rerun)
RERUNS = 0


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


def cascade_tables(cascade: ScdClassifierCascade) -> CascadeTables:
    """The kernel's tables for ``cascade``, built once and kept on it."""
    tabs = getattr(cascade, "_tables", None)
    if tabs is None:
        tabs = scd_cascade.build_tables(
            cascade.thresholds, cascade.sx, cascade.sy, cascade.dx,
            cascade.dy, cascade.bias, cascade.w, cascade.stage_of)
        cascade._tables = tabs
    return tabs


# ---------------------------------------------------------------------------
# the staged cascade's phases and capacities
# ---------------------------------------------------------------------------

_EARLY_FEATS = 16  # stages up to this cumulative feature count: phase A
_MID_FEATS = 64    # the next stage block's feature budget: phase B1


def phase_split(stage_counts) -> Tuple[int, int]:
    """(split, split2): phase A is stages [0, split), B1 [split, split2),
    B2 the rest. Phase A holds at least stage 0, even past _EARLY_FEATS
    features, and B1 at least one stage when any is left."""
    counts = [int(c) for c in stage_counts]
    split, cum = 0, 0
    while split < len(counts) and cum + counts[split] <= _EARLY_FEATS:
        cum += counts[split]
        split += 1
    split = max(1, split)
    split2, cum2 = split, 0
    while split2 < len(counts) and cum2 + counts[split2] <= _MID_FEATS:
        cum2 += counts[split2]
        split2 += 1
    return split, max(split + 1, split2)


@dataclasses.dataclass
class StagedTables:
    """The staged cascade's per-phase tables; B1 or B2 is None when no
    stage is left for it."""

    phase_a: CascadeTables
    phase_b1: Optional[CascadeTables]
    phase_b2: Optional[CascadeTables]
    n_stages: int
    last_count: float             # the last stage's feature count


def staged_tables(cascade: ScdClassifierCascade) -> StagedTables:
    """The staged form's tables for ``cascade``, built once and kept on it
    (apart from the full-cascade tables of ``cascade_tables``)."""
    tabs = getattr(cascade, "_staged", None)
    if tabs is None:
        split, split2 = phase_split(cascade.stage_counts)
        S = cascade.n_stages

        def phase(s0, s1):
            if s0 >= min(s1, S):
                return None
            return scd_phase.phase_tables(
                cascade.thresholds, cascade.sx, cascade.sy, cascade.dx,
                cascade.dy, cascade.bias, cascade.w, cascade.stage_of, s0,
                min(s1, S))

        tabs = StagedTables(phase_a=phase(0, split),
                            phase_b1=phase(split, split2),
                            phase_b2=phase(split2, S), n_stages=S,
                            last_count=float(cascade.stage_counts[-1]))
        cascade._staged = tabs
    return tabs


def _level_capacity(nwin: int) -> int:
    """ccv_tpu's phase-B1 buffer size (~1.3x the worst phase-A survivor rate
    it observed). The staged form here runs B1 densely and needs it only to
    bound K2."""
    return int(min(nwin, max(128, nwin // 14)))


def _level_capacity2(nwin: int) -> int:
    """K2, the phase-B2 buffer size: ~2x the worst post-B1 survivor rate
    ccv_tpu observed (~1%). More survivors make the host rerun the level at
    full capacity."""
    return int(min(_level_capacity(nwin), max(64, nwin // 48)))


def _out_len(tabs: StagedTables, nwin: int, K2: int) -> int:
    """Rows a level gives in the staged form: every window when there is no
    phase B2 (phases A and B1 are dense), else the K2 compacted ones."""
    return nwin if tabs.phase_b2 is None else K2


# ---------------------------------------------------------------------------
# feature map and SAT
# ---------------------------------------------------------------------------

def _gradient_channels(img: torch.Tensor) -> List[torch.Tensor]:
    """The 8 gradient channels of scd_map, each (..., H, W) float32:
    [dx, dy, du, dv, |dx|, |dy|, |du|, |dv|] (ccv_scd.c:325). blur(0.5) ->
    four 3-tap sobels -> per-pixel strongest channel for color images."""
    blurred = basic.blur(img, sigma=0.5)
    grads = [basic.sobel(blurred, 1, 0), basic.sobel(blurred, 0, 1),
             basic.sobel(blurred, 1, 1), basic.sobel(blurred, -1, 1)]
    color = img.dim() >= 3 and img.shape[-1] == 3
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
        elif gf.dim() >= 3:
            gf = gf[..., 0]
        chans.append(gf)
    return chans + [c.abs() for c in chans]


def scd_map_cf8(img: torch.Tensor) -> torch.Tensor:
    """Channels-first (8, H, W) float32 gradient map: the first 8 scd_map
    channels, the only ones the cascade features read (ccv_scd.c:445).
    ``img`` is (H, W), (H, W, C), or a batch (B, H, W, C) -> (B, 8, H, W)."""
    return torch.stack(_gradient_channels(img), dim=-3)


# cube_root[i] = cbrt(i / 2047): the reference's 2048-entry LUT
_CBRT_LUT = np.cbrt(np.arange(2048) / 2047.0).astype(np.float32)


def _luv(rgb01: torch.Tensor):
    """RGB in [0, 1] (..., 3) float32 -> the scaled (L, U, V) channels of
    _ccv_rgb_to_luv (ccv_scd.c:298), with its cube-root LUT quantization."""
    r, g, b = rgb01[..., 0], rgb01[..., 1], rgb01[..., 2]
    x = 0.412453 * r + 0.35758 * g + 0.180423 * b
    y = 0.212671 * r + 0.71516 * g + 0.072169 * b
    z = 0.019334 * r + 0.119193 * g + 0.950227 * b
    x_n, y_n = 0.312713, 0.329016
    uv_n_div = -2.0 * x_n + 12.0 * y_n + 3.0
    u_n = 4.0 * x_n / uv_n_div
    v_n = 9.0 * y_n / uv_n_div
    uv_div = torch.clamp(x + 15.0 * y + 3.0 * z, min=1.1920929e-07)
    u = 4.0 * x / uv_div
    v = 9.0 * y / uv_div
    yi = torch.floor(y * 2047.0).clamp(0, 2047).to(torch.int64)
    y_cbrt = to_device(_CBRT_LUT, rgb01.device)[yi]
    l = torch.clamp(116.0 * y_cbrt - 16.0, min=0.0)
    uu = 13.0 * l * (u - u_n)
    vv = 13.0 * l * (v - v_n)
    return (l * (255.0 / 100.0),
            (uu + 134.0) * (255.0 / (220.0 + 134.0)),
            (vv + 140.0) * (255.0 / (122.0 + 140.0)))


def scd_map(img: torch.Tensor) -> torch.Tensor:
    """ccv_scd twin (ccv_scd.c:325): the (H, W, 11) float32 feature map,
    [dx, dy, du, dv, |dx|, |dy|, |du|, |dv|, L, U, V]; a gray image gives
    [gray / 255, 0, 0] in the last three."""
    out = _gradient_channels(img)
    if img.dim() == 3 and img.shape[-1] == 3:
        out += list(_luv(img.to(torch.float32) / 255.0))
    else:
        gray = (img[..., 0] if img.dim() == 3 else img).to(
            torch.float32) / 255.0
        out += [gray, torch.zeros_like(gray), torch.zeros_like(gray)]
    return torch.stack(out, dim=-1)


def _sat_cf8(x: torch.Tensor) -> torch.Tensor:
    """Zero-padded summed-area table of a channels-first (..., C, H, W) map:
    (..., C, H+1, W+1) float32, summed along W then H as ccv_tpu does."""
    H, W = x.shape[-2:]
    out = x.new_zeros(x.shape[:-2] + (H + 1, W + 1), dtype=torch.float32)
    out[..., 1:, 1:] = torch.cumsum(torch.cumsum(x.to(torch.float32), dim=-1),
                                    dim=-2)
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
    """(B*L, 8, H1, W1) SAT stack of one octave's levels for a (B, H, W, C)
    batch of octave sources, image-major and zero-padded to the largest
    level: per level, INTER_AREA resample -> margin pad -> scd_map_cf8 ->
    _sat_cf8, each over the whole batch."""
    B, H, W = src.shape[:3]
    sats = []
    for (k, rows, cols, _ny, _nx) in lspecs:
        image = src if k == 0 else resample.resample(
            src, rows=rows, cols=cols, rows_scale=rows / H,
            cols_scale=cols / W, interp=resample.INTER_AREA)
        if any(margin):
            image = F.pad(image, (0, 0, margin[0], margin[2], margin[1],
                                  margin[3]))
        sats.append(_sat_cf8(scd_map_cf8(image)))      # (B, 8, h1, w1)
    H1 = max(s.shape[2] for s in sats)
    W1 = max(s.shape[3] for s in sats)
    if len(sats) == 1:
        return sats[0]
    out = sats[0].new_zeros((B, len(sats), 8, H1, W1))
    for i, s in enumerate(sats):
        out[:, i, :, :s.shape[2], :s.shape[3]] = s
    return out.reshape(B * len(sats), 8, H1, W1)


def octave_sats(img, cascade: ScdClassifierCascade,
                params: Optional[ScdParams] = None,
                device: _device.DeviceLike = None):
    """The host plan and device prolog of ``detect``: returns (specs, it),
    where ``it`` yields (lspecs, sat_l, dims) for every octave that has
    levels, lspecs = (k, rows, cols, ny, nx) per level and dims the (L, 2)
    int64 array of their window grids. Each SAT stack is made only when the
    iterator reaches it."""
    params = params or ScdParams()
    a = _image(img, cascade, params, device)[None]
    specs, scale_upto = _level_specs(a.shape[1], a.shape[2], cascade, params)
    return specs, ((lspecs, sat_l, dims) for _o, _src, lspecs, sat_l, dims
                   in _octaves(a, specs, scale_upto, cascade.margin))


def _octaves(src: torch.Tensor, specs, scale_upto: int, margin):
    """Yields (octave, source, lspecs, sat_l, dims) for every octave of a
    (B, H, W, C) batch that has levels; dims is per image, (L, 2)."""
    by_octave: dict = {}
    for (octave, k, rows, cols, ny, nx, _scale) in specs:
        by_octave.setdefault(octave, []).append((k, rows, cols, ny, nx))
    for octave in range(scale_upto):
        lspecs = by_octave.get(octave, [])
        if lspecs:
            dims = np.array([(ny, nx) for (*_r, ny, nx) in lspecs], np.int64)
            yield octave, src, lspecs, _octave_sats(src, lspecs, margin), dims
        if octave < scale_upto - 1:
            src = resample.sample_down(src)


def up_ratio(cascade: ScdClassifierCascade, params: ScdParams) -> float:
    """How far ``detect`` scales an image up so the cascade finds objects
    down to ``params.size`` (1.0: not at all)."""
    size_w, size_h = params.size
    return max(1.0, cascade.width / size_w, cascade.height / size_h)


def _image(img, cascade: ScdClassifierCascade, params: ScdParams,
           device: _device.DeviceLike, batch: bool = False) -> torch.Tensor:
    """(H, W, C), or (B, H, W, C) with ``batch``, on the device; a single
    image scaled up by ``up_ratio`` with INTER_CUBIC where that is more than
    1 + 1e-4 (ccv_tpu's detect_async), which ``detect_batch`` refuses, as
    ccv_tpu's does."""
    a = as_array(img, device)
    if a.dim() == (3 if batch else 2):
        a = a[..., None]
    if a.dim() != (4 if batch else 3):
        want = "(B, H, W[, C])" if batch else "(H, W[, C])"
        raise ValueError(f"expected {want} images, got {tuple(a.shape)}")
    ratio = up_ratio(cascade, params)
    if ratio - 1.0 <= 1e-4:
        return a
    if batch:
        raise NotImplementedError(
            f"detect_batch does not scale up (by {ratio}): use "
            f"params.size >= the cascade's {cascade.width}x{cascade.height}"
            f", or detect")
    H, W = a.shape[:2]
    return resample.resample(a, rows=int(H * ratio + 0.5),
                             cols=int(W * ratio + 0.5), rows_scale=ratio,
                             cols_scale=ratio, interp=resample.INTER_CUBIC)


# ---------------------------------------------------------------------------
# the staged cascade (ccv_tpu's _eval_level, accelerator branch)
# ---------------------------------------------------------------------------

# SAT floats gathered per chunk of phase-B2 features: 128 MB
_GATHER_FLOATS = 1 << 25


def _stage_sums_at(sat_l: torch.Tensor, tables: CascadeTables, step: int,
                   wy: torch.Tensor, wx: torch.Tensor) -> torch.Tensor:
    """(Lb, S, K) stage sums of ``tables`` at windows ``(wy, wx)``, each
    (Lb, K), of every level: each feature's 16 SAT corners gathered per
    window and its box sums taken as ``c0 - c1 - c2 + c3`` (no corner
    matrix product: SAT values reach ~1e6 at 1080p), then K1's per-feature
    math as tensor ops. Features go in chunks that bound the gather."""
    Lb, C, H1, W1 = sat_l.shape
    K, F = wy.shape[1], tables.n_features
    dev = sat_l.device
    b = tables.boxes.astype(np.int64)      # (F, 4, 4): sy, sx, dy, dx
    sy, sx, dy, dx = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    off = to_device(np.stack([sy * W1 + sx, sy * W1 + dx, dy * W1 + sx,
                              dy * W1 + dx], axis=-1).reshape(F, 16), dev)
    feats = tables.on(dev)["feats"]
    w = feats[:, :32].reshape(F, 4, C).permute(2, 0, 1)   # (C, F, 4)
    base = (wy * (step * W1) + wx * step).to(torch.int64)
    flat = sat_l.reshape(Lb, C, H1 * W1)
    chunk = max(1, _GATHER_FLOATS // (Lb * C * K * 16))
    resp = []
    for f0 in range(0, F, chunk):
        f1 = min(F, f0 + chunk)
        idx = (base[:, :, None] + off[f0:f1].reshape(1, 1, -1)).reshape(
            Lb, 1, -1)
        g = flat.gather(2, idx.expand(Lb, C, idx.shape[2])).reshape(
            Lb, C, K, f1 - f0, 4, 4)
        box = ((g[..., 0] - g[..., 1]) - g[..., 2]) + g[..., 3]
        # squares summed over boxes, then over channels
        inv = 1.0 / (torch.sqrt((box * box).sum(-1).sum(1)) + 1e-6)
        u = torch.clamp(box * inv[:, None, :, :, None], -scd_cascade.THETA,
                        scd_cascade.THETA)
        inv2 = 1.0 / (torch.sqrt((u * u).sum(-1).sum(1)) + 1e-6)
        dot = (u * w[None, :, None, f0:f1]).sum(-1).sum(1)  # (Lb, K, Fc)
        resp.append(torch.tanh(0.5 * (dot * inv2 + feats[f0:f1, 32])))
    resp = torch.cat(resp, dim=-1)
    return torch.stack([resp[..., f0:f1].sum(-1)
                        for f0, f1 in tables.stage_ranges], dim=1)


def _dense_rows(passed: torch.Tensor, conf: torch.Tensor, dims):
    """Per level, (ny*nx, 3) rows [window index, passed, conf] of every
    window of its grid, in window order."""
    rows = []
    for li, (ny, nx) in enumerate(dims):
        n = int(ny) * int(nx)
        rows.append(torch.stack([
            torch.arange(n, dtype=torch.float32, device=conf.device),
            passed[li, :ny, :nx].reshape(n).to(torch.float32),
            conf[li, :ny, :nx].reshape(n)], dim=1))
    return rows


def _staged_eval(sat_l: torch.Tensor, dims, tabs: StagedTables, step: int,
                 caps, phase_a: Callable):
    """The staged cascade over every window of every level of ``sat_l``:
    phases A and B1 over every window (``phase_a`` on each phase's tables,
    kernel K3 on the card, both launches reading one copy of the phase
    planes), then ONE compaction of the A&B1 survivors to the first
    ``caps[l]`` in window order (a stable sort: ``argsort(~alive)``) and
    phase B2 on them. No step waits for the device.

    Returns (rows, counts): per level a float32 (n, 3) tensor of rows
    [window index (wy * nx + wx), passed, conf], n = ``_out_len``, and the
    (Lb, 2) survivor counts of phase A and of A&B1 (0 without B2)."""
    dev = sat_l.device
    Lb = sat_l.shape[0]
    NX = int(dims[:, 1].max())
    planes = None
    if dev.type == "cuda":  # one copy for phase A's and B1's launch
        planes = scd_cascade.kernel_planes(sat_l, tabs.phase_a, step, dims,
                                           tabs.phase_b1 or tabs.phase_a)
    conf_a, alive = phase_a(sat_l, tabs.phase_a, step, dims, planes=planes)
    count_a = alive.sum(dim=(1, 2))
    zero = torch.zeros_like(count_a)

    def norm(v):
        return v / tabs.last_count + (tabs.n_stages - 1)

    if tabs.phase_b1 is None:
        return (_dense_rows(alive, norm(conf_a), dims),
                torch.stack([count_a, zero], 1).to(torch.float32))
    conf_b1, pass_b1 = phase_a(sat_l, tabs.phase_b1, step, dims,
                               planes=planes)
    alive = alive & pass_b1
    if tabs.phase_b2 is None:
        return (_dense_rows(alive, norm(conf_b1), dims),
                torch.stack([count_a, zero], 1).to(torch.float32))
    count_b1 = alive.sum(dim=(1, 2))
    K = max(caps)
    flat = alive.reshape(Lb, -1)
    order = torch.sort((~flat).to(torch.uint8), dim=1,
                       stable=True).indices[:, :K]
    wy, wx = order // NX, order % NX
    vs2 = _stage_sums_at(sat_l, tabs.phase_b2, step, wy, wx)
    th2 = tabs.phase_b2.on(dev)["thresholds"]
    cap = to_device(np.asarray(caps, np.int64), dev)
    # padding slots past the survivors hold dead windows: masked
    valid = ((torch.arange(K, device=dev)[None]
              < torch.minimum(count_b1, cap)[:, None])
             & flat.gather(1, order))
    passed = (vs2 > th2[None, :, None]).all(dim=1) & valid
    nx = to_device(np.asarray(dims[:, 1], np.int64), dev)
    rows = torch.stack([(wy * nx[:, None] + wx).to(torch.float32),
                        passed.to(torch.float32), norm(vs2[:, -1])], dim=-1)
    return ([rows[li, :c] for li, c in enumerate(caps)],
            torch.stack([count_a, count_b1], 1).to(torch.float32))


def staged_level(src: torch.Tensor, spec, cascade: ScdClassifierCascade,
                 params: ScdParams, evaluate: Optional[Callable] = None):
    """One level of the staged form from its octave's (H, W, C) source, at
    the capacity of every window, as the overflow rerun runs it. Waits for
    the device; returns numpy (idx, passed, conf, count2)."""
    (_octave, k, rows, cols, ny, nx, _scale) = spec
    sat = _octave_sats(src[None], [(k, rows, cols, ny, nx)], cascade.margin)
    out, counts = _staged_eval(
        sat, np.array([[ny, nx]], np.int64), staged_tables(cascade),
        params.step_through, [ny * nx], evaluate or scd_phase.phase_a)
    arr = out[0].cpu().numpy()
    return (arr[:, 0].astype(np.int64), arr[:, 1] != 0.0, arr[:, 2],
            counts[0].cpu().numpy())


# ---------------------------------------------------------------------------
# detect
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Pending:
    """A detect_async / detect_batch dispatch: the packed results of every
    image on their way to the host."""

    host: torch.Tensor            # (B, N) float32: per image, per octave
    ready: Optional[torch.cuda.Event]
    layout: list                  # per octave (offset, L, NY, NX) for
    #   "pallas_full" (passed and conf planes), (offset, lens) for "pallas"
    #   (rows, then the count pairs)
    specs: tuple
    cascade: ScdClassifierCascade
    params: ScdParams
    form: str
    evaluate: Callable
    pyr: dict                     # "pallas": octave -> its (B, H, W, C)
    #   source on the device, for the overflow rerun


def _dispatch(a: torch.Tensor, cascade: ScdClassifierCascade,
              params: ScdParams, form: str,
              evaluate: Optional[Callable]) -> _Pending:
    """Queue a (B, H, W, C) batch: per octave one launch of K1 or K3 for
    every level of every image, then one copy of the packed results to
    pinned host memory, all without waiting for the device."""
    if form not in FORMS:
        raise ValueError(f"form must be one of {FORMS}, got {form!r}")
    B, H, W = a.shape[:3]
    step = params.step_through
    specs, scale_upto = _level_specs(H, W, cascade, params)
    if form == "pallas_full":
        tabs = cascade_tables(cascade)
        evaluate = evaluate or scd_cascade.cascade_eval_levels
    else:
        tabs = staged_tables(cascade)
        evaluate = evaluate or scd_phase.phase_a
    pieces, layout, pyr, offset = [], [], {}, 0
    for octave, src, lspecs, sat_l, dims in _octaves(a, specs, scale_upto,
                                                      cascade.margin):
        L, dims_b = len(lspecs), np.tile(dims, (B, 1))
        if form == "pallas_full":
            conf, passed = evaluate(sat_l, tabs, step, dims_b)
            conf = (conf / float(cascade.stage_counts[-1])
                    + (cascade.n_stages - 1))
            piece = torch.stack([passed.to(torch.float32), conf]).reshape(
                2, B, -1).transpose(0, 1).reshape(B, -1)
            layout.append((offset, L) + tuple(conf.shape[1:]))
        else:
            caps = [_level_capacity2(int(ny) * int(nx)) for ny, nx in dims]
            rows, counts = _staged_eval(sat_l, dims_b, tabs, step, caps * B,
                                        evaluate)
            piece = torch.cat([torch.cat(rows).reshape(B, -1),
                               counts.reshape(B, -1)], dim=1)
            layout.append((offset, tuple(
                _out_len(tabs, int(ny) * int(nx), cap)
                for (ny, nx), cap in zip(dims, caps))))
            pyr[octave] = src
        pieces.append(piece)
        offset += piece.shape[1]
    ready = None
    if not pieces:
        host = torch.zeros((B, 0))
    else:
        packed = torch.cat(pieces, dim=1) if len(pieces) > 1 else pieces[0]
        if packed.device.type == "cuda":
            # start the one device->host copy now, into pinned memory, so a
            # caller pipelining images overlaps it with the next dispatch
            host = torch.empty(packed.shape, dtype=packed.dtype,
                               pin_memory=True)
            host.copy_(packed, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(packed.device))
        else:
            host = packed
    return _Pending(host, ready, layout, specs, cascade, params, form,
                    evaluate, pyr)


def detect_async(img, cascade: ScdClassifierCascade,
                 params: Optional[ScdParams] = None,
                 device: _device.DeviceLike = None,
                 evaluate: Optional[Callable] = None,
                 form: str = "pallas_full") -> _Pending:
    """Queue the pyramid and one kernel launch per octave without waiting
    for the device; returns a handle for detect_collect. ``img`` is
    (H, W[, C]) on ``device`` (default: where a tensor is, else the default
    device). ``form`` is "pallas_full" (kernel K1, the whole cascade) or
    "pallas" (the staged cascade, kernel K3 for phases A and B1).
    ``evaluate`` replaces the form's kernel (same signature as
    ``scd_cascade.cascade_eval_levels`` or ``scd_phase.phase_a``, which the
    staged form calls with ``planes=``) to compare it with another."""
    params = params or ScdParams()
    return _dispatch(_image(img, cascade, params, device)[None], cascade,
                     params, form, evaluate)


def _comps_from_levels(outs, specs, ratio: float, eff_w: int, eff_h: int,
                       step: int) -> List[Comp]:
    """Host edge: per level in ``specs`` order, (idx, conf) of its passed
    windows in window order (idx = wy * nx + wx) -> Comp list, in the
    coordinates of the image before its up-scale by ``ratio``. The rect
    arithmetic is ccv_tpu's, vectorised: float64 then truncation toward
    zero, as Python's int() does."""
    comps: List[Comp] = []
    for spec, (idx, conf) in zip(specs, outs):
        (octave, _k, _rows, _cols, _ny, nx, scale) = spec
        sc = (scale / ratio) * (1 << octave)
        wy, wx = np.divmod(np.asarray(idx, np.int64), nx)
        xs = ((wx * step + 0.5) * sc - 0.5).astype(np.int64).tolist()
        ys = ((wy * step + 0.5) * sc - 0.5).astype(np.int64).tolist()
        width, height = int(eff_w * sc), int(eff_h * sc)
        comps.extend(
            Comp(x=x, y=y, width=width, height=height, confidence=c,
                 classification_id=1)
            for x, y, c in zip(xs, ys, np.asarray(conf).tolist()))
    return comps


def _host(handle: _Pending, b: int) -> np.ndarray:
    if handle.ready is not None:
        handle.ready.synchronize()
    return handle.host[b].numpy()


def level_planes(handle: _Pending, b: int = 0):
    """Wait for a "pallas_full" dispatch; per level of image ``b`` in specs
    order, (passed (ny, nx) bool, conf (ny, nx) float32) numpy planes."""
    if handle.form != "pallas_full":
        raise ValueError(f"level_planes reads a pallas_full dispatch, not "
                         f"{handle.form!r}: use level_rows")
    arr = _host(handle, b)
    outs = []
    for offset, L, NY, NX in handle.layout:
        grid = arr[offset:offset + 2 * L * NY * NX].reshape(2, L, NY, NX)
        outs.extend(grid[:, li] for li in range(L))
    return [(g[0, :ny, :nx] != 0.0, g[1, :ny, :nx])
            for g, (*_r, ny, nx, _s) in zip(outs, handle.specs)]


def level_rows(handle: _Pending, b: int = 0):
    """Wait for a "pallas" dispatch; per level of image ``b`` in specs
    order, numpy (idx, passed, conf, count2) as the device left them (no
    overflow rerun)."""
    if handle.form != "pallas":
        raise ValueError(f"level_rows reads a pallas dispatch, not "
                         f"{handle.form!r}: use level_planes")
    arr = _host(handle, b)
    outs = []
    for offset, lens in handle.layout:
        n = sum(lens)
        rows = arr[offset:offset + 3 * n].reshape(n, 3)
        counts = arr[offset + 3 * n:offset + 3 * n + 2 * len(lens)].reshape(
            -1, 2)
        starts = np.cumsum((0,) + lens)
        outs.extend((rows[s:e, 0].astype(np.int64), rows[s:e, 1] != 0.0,
                     rows[s:e, 2], counts[li])
                    for li, (s, e) in enumerate(zip(starts[:-1], starts[1:])))
    return outs


def _collect(handle: _Pending, b: int) -> List[Comp]:
    """Image ``b`` of a dispatch: its passed windows (rerunning any level
    whose survivors overflowed K2) -> rects -> merge_detections."""
    global RERUNS
    cascade, params = handle.cascade, handle.params
    outs = []
    if handle.form == "pallas_full":
        for passed, conf in level_planes(handle, b):
            idx = np.flatnonzero(passed)
            outs.append((idx, conf.reshape(-1)[idx]))
    else:
        for spec, (idx, passed, conf, count2) in zip(
                handle.specs, level_rows(handle, b)):
            if count2[1] > _level_capacity2(spec[4] * spec[5]):
                RERUNS += 1
                idx, passed, conf, _ = staged_level(
                    handle.pyr[spec[0]][b], spec, cascade, params,
                    evaluate=handle.evaluate)
            outs.append((idx[passed], conf[passed]))
    eff_h = cascade.height - cascade.margin[1] - cascade.margin[3]
    eff_w = cascade.width - cascade.margin[0] - cascade.margin[2]
    comps = _comps_from_levels(outs, handle.specs,
                               up_ratio(cascade, params), eff_w, eff_h,
                               params.step_through)
    return merge_detections(comps, params.min_neighbors)


def detect_collect(handle: _Pending) -> List[Comp]:
    """Wait for a detect_async dispatch and run the host-edge grouping."""
    return _collect(handle, 0)


def detect(img, cascade: ScdClassifierCascade,
           params: Optional[ScdParams] = None,
           device: _device.DeviceLike = None,
           evaluate: Optional[Callable] = None,
           form: str = "pallas_full") -> List[Comp]:
    """ccv_scd_detect_objects twin (ccv_scd.c:1653) for a single cascade."""
    return detect_collect(detect_async(img, cascade, params, device,
                                       evaluate, form))


def detect_batch(imgs, cascade: ScdClassifierCascade,
                 params: Optional[ScdParams] = None,
                 device: _device.DeviceLike = None,
                 form: str = "pallas_full") -> List[List[Comp]]:
    """``detect`` for a (B, H, W[, C]) batch of same-shape images: one
    kernel launch per octave for the whole batch (its B*L levels on the
    kernel's level axis) and one device->host copy; a level that overflows
    K2 is rerun for its image alone."""
    params = params or ScdParams()
    handle = _dispatch(_image(imgs, cascade, params, device, batch=True),
                       cascade, params, form, None)
    return [_collect(handle, b) for b in range(handle.host.shape[0])]
