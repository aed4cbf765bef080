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

``form="auto"`` is ccv_tpu's measured per-octave choice (``nn.autotune``,
op ``scd_octave_exact``, ccv_tpu's ``_octave_extra`` key): on the card the
whole octave program of each of K1's form and K3's form is timed on zeros
of the octave source's shape, the winner is kept and run; a batch reuses
the single image's record. Only kernel forms compete: a plain torch form
never stands in for a kernel on the card, and a form that failed to run
there raises rather than losing quietly. On a CPU tensor ``auto`` measures
nothing and takes ``"pallas_full"``.

ccv_tpu's other staged forms are explicit choices, plain torch ops on both
devices (``_form_level``, ccv_tpu's ``_make_level_body`` and
``_eval_level``): ``"slices"`` (box sums from phase-plane corner slices),
``"xla"`` (the corners stacked as rows, box sums by four row takes) and
``"matmul"`` (the first-corner-centred corner matrix product, float32 with
TF32 off). Phase B1 is dense on the card and, on a CPU tensor, ccv_tpu's
sparse B1 (the first K1 phase-A survivors by a stable sort). Cascade files
are the reference's SQLite format (ccv_scd.c:1547), read with Python's
sqlite3.
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

FORMS = ("pallas_full", "pallas")          # the kernel forms (K1, K3)
PLAIN_FORMS = ("slices", "xla", "matmul")  # ccv_tpu's other staged forms
AUTO_FORMS = FORMS                         # what form="auto" measures
ALL_FORMS = FORMS + PLAIN_FORMS + ("auto",)
OCTAVE_OP = "scd_octave_exact"             # form="auto"'s autotune op

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
# ccv_tpu's other staged forms: "slices", "xla", "matmul" (plain torch)
# ---------------------------------------------------------------------------

def _corner_phase(cascade: ScdClassifierCascade, feats: np.ndarray) -> dict:
    """ccv_tpu's ``_phase_tables`` for the features ``feats``: the corner
    matrix M (F*4 boxes, nd distinct corners), the corners (nd, 2) as (oy,
    ox), each box's four corner rows ``cidx`` (F*4, 4) in the order (sy,sx),
    (sy,dx), (dy,sx), (dy,dx) with signs +, -, -, +, and the weights,
    biases, stage one-hot (F, S') and thresholds."""
    sy, dy = cascade.sy[feats], cascade.dy[feats]
    sx, dx = cascade.sx[feats], cascade.dx[feats]
    ys = np.stack([sy, sy, dy, dy], axis=-1)
    xs = np.stack([sx, dx, sx, dx], axis=-1)
    F_ = len(feats)
    pairs = np.stack([ys, xs], axis=-1).reshape(-1, 2)
    uniq, inv = np.unique(pairs, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    M = np.zeros((F_ * 4, len(uniq)), np.float32)
    np.add.at(M, (np.repeat(np.arange(F_ * 4), 4), inv),
              np.tile(np.array([1.0, -1.0, -1.0, 1.0], np.float32), F_ * 4))
    stages = np.unique(cascade.stage_of[feats])
    onehot = np.zeros((F_, len(stages)), np.float32)
    for si, st in enumerate(stages):
        onehot[cascade.stage_of[feats] == st, si] = 1.0
    return dict(M=M, offsets=uniq.astype(np.int64),
                cidx=inv.reshape(F_ * 4, 4).astype(np.int64),
                w=cascade.w[feats].astype(np.float32),
                bias=cascade.bias[feats].astype(np.float32), onehot=onehot,
                thresholds=cascade.thresholds[stages].astype(np.float32))


def form_tables(cascade: ScdClassifierCascade) -> dict:
    """The plain staged forms' tables (ccv_tpu's ``_cascade_tables``): per
    phase (``phase_split``) a ``_corner_phase`` dict or None, every phase's
    corners (``all_off``), the stage count and the last stage's feature
    count; built once and kept on the cascade."""
    tabs = getattr(cascade, "_form_tables", None)
    if tabs is None:
        split, split2 = phase_split(cascade.stage_counts)
        so = cascade.stage_of
        phases = {}
        for name, sel in (("phase_a", so < split),
                          ("phase_b1", (so >= split) & (so < split2)),
                          ("phase_b2", so >= split2)):
            feats = np.nonzero(sel)[0]
            phases[name] = _corner_phase(cascade, feats) if len(feats) \
                else None
        tabs = dict(phases, n_stages=cascade.n_stages,
                    last_count=float(cascade.stage_counts[-1]),
                    all_off=np.concatenate([p["offsets"] for p in
                                            phases.values() if p]))
        cascade._form_tables = tabs
    return tabs


def _tiled_phase(tabs: dict, name: str, step: int) -> Optional[dict]:
    """tabs[name] with its corners moved onto the per-window tile layout
    of ``_tiles_at`` (ccv_tpu's ``_tiled_phase`` / ``_tile_selector``): tile
    position ((oy%step*step + ox%step)*th + oy//step)*tw + ox//step. The
    tile-layout M is made when the matmul form first asks for it."""
    phase = tabs[name]
    if phase is None:
        return None
    got = tabs.get(("tiled", name, step))
    if got is None:
        all_off = tabs["all_off"]
        th = int(all_off[:, 0].max()) // step + 1
        tw = int(all_off[:, 1].max()) // step + 1
        off = phase["offsets"]
        lin = ((((off[:, 0] % step) * step + off[:, 1] % step) * th
                + off[:, 0] // step) * tw + off[:, 1] // step)
        got = {k: v for k, v in phase.items() if k != "_dev"}
        got.update(cidx=lin[phase["cidx"]], lin=lin,
                   width=step * step * th * tw)
        tabs[("tiled", name, step)] = got
    return got


def _phase_on(phase: dict, dev: torch.device, matmul: bool) -> dict:
    """Device copies of a phase's tables, made once per device (M, and the
    tile layout's M, only for the matmul form)."""
    cache = phase.setdefault("_dev", {})
    key = str(dev)
    d = cache.get(key)
    if d is None:
        d = {k: to_device(phase[k], dev)
             for k in ("cidx", "w", "bias", "onehot", "thresholds")}
        cache[key] = d
    if matmul and "M" not in d:
        M = phase["M"]
        if "lin" in phase:  # the tile layout: column j moves to lin[j]
            M = np.zeros((M.shape[0], phase["width"]), np.float32)
            M[:, phase["lin"]] = phase["M"]
        d["M"] = to_device(M, dev)
    return d


def _surf_eval_f4n8(box: torch.Tensor, ph: dict):
    """(stage sums (n, S'), passed (n,)) from box sums (F, 4, n, 8): the
    L2Hys normalise, clip and renormalise and the stump dot
    (ccv_scd.c:502-533) reduced over boxes and channels in place (ccv_tpu's
    ``_surf_eval_f4n8``)."""
    F_, n = box.shape[0], box.shape[2]
    inv = 1.0 / (torch.sqrt((box * box).sum(dim=(1, 3))) + 1e-6)
    surf = torch.clamp(box * inv[:, None, :, None], -scd_cascade.THETA,
                       scd_cascade.THETA)
    inv2 = 1.0 / (torch.sqrt((surf * surf).sum(dim=(1, 3))) + 1e-6)
    dot = (surf * ph["w"].reshape(F_, 4, 1, 8)).sum(dim=(1, 3))   # (F, n)
    resp = torch.tanh(0.5 * (dot * inv2 + ph["bias"][:, None]))
    v = resp.T @ ph["onehot"]                                      # (n, S')
    return v, (v > ph["thresholds"]).all(dim=-1)


def _box_from_Dt(Dt: torch.Tensor, ph: dict, form: str) -> torch.Tensor:
    """Box sums (F*4, n*8) from the corner rows Dt (nd, n*8): the matmul
    form's corner matrix product on first-corner-centred rows (every box
    row of M sums to zero), any other form's four row takes c0 - c1 - c2 +
    c3."""
    if form == "matmul":
        return ph["M"] @ (Dt - Dt[0:1])
    ci = ph["cidx"]
    return ((Dt[ci[:, 0]] - Dt[ci[:, 1]]) - Dt[ci[:, 2]]) + Dt[ci[:, 3]]


def _plane_planes(sat8: torch.Tensor, ny: int, nx: int, max_oy: int,
                  max_ox: int, step: int):
    """(planes (step, step, Hp/step, Wp/step, 8), th, tw): the (H1, W1, 8)
    SAT zero-padded or cut to Hp = (ny + th) * step rows and Wp columns and
    split into step x step phase planes (ccv_tpu's ``_phase_planes``), so
    every stride-``step`` corner is a unit-stride slice of one plane."""
    th, tw = max_oy // step + 1, max_ox // step + 1
    Hp, Wp = (ny + th) * step, (nx + tw) * step
    H1, W1 = sat8.shape[:2]
    s = F.pad(sat8, (0, 0, 0, max(0, Wp - W1), 0, max(0, Hp - H1)))[:Hp, :Wp]
    return (s.reshape(Hp // step, step, Wp // step, step, 8)
            .permute(1, 3, 0, 2, 4), th, tw)


def _dense_phase(planes: torch.Tensor, phase: dict, ny: int, nx: int,
                 step: int, form: str):
    """One phase over every window of the grid: (stage sums, passed)."""
    n = ny * nx
    ph = _phase_on(phase, planes.device, form == "matmul")
    cache: dict = {}

    def corner(j: int) -> torch.Tensor:                # (n, 8)
        got = cache.get(j)
        if got is None:
            oy, ox = (int(v) for v in phase["offsets"][j])
            got = planes[oy % step, ox % step, oy // step:oy // step + ny,
                         ox // step:ox // step + nx].reshape(n, 8)
            cache[j] = got
        return got

    F_ = phase["w"].shape[0]
    if form == "slices":
        # box sums straight off the plane slices: no corner rows, no take
        box = torch.stack([((corner(a) - corner(b)) - corner(c)) + corner(d)
                           for a, b, c, d in phase["cidx"].tolist()])
    else:
        Dt = torch.stack([corner(j).reshape(n * 8)
                          for j in range(len(phase["offsets"]))])
        box = _box_from_Dt(Dt, ph, form)
    return _surf_eval_f4n8(box.reshape(F_, 4, n, 8), ph)


def _tiles_at(planes: torch.Tensor, sel: torch.Tensor, nx: int, th: int,
              tw: int) -> torch.Tensor:
    """(K, step*step*th*tw, 8): each selected window's tile of the phase
    planes in the tile layout of ``_tiled_phase``."""
    pl = planes.permute(2, 3, 0, 1, 4)                 # (Hs, Ws, s, s, 8)
    ry = (sel // nx)[:, None] + torch.arange(th, device=sel.device)
    rx = (sel % nx)[:, None] + torch.arange(tw, device=sel.device)
    t = pl[ry[:, :, None], rx[:, None, :]]             # (K, th, tw, s, s, 8)
    return t.permute(0, 3, 4, 1, 2, 5).reshape(sel.shape[0], -1, 8)


def _phase_at(planes: torch.Tensor, sel: torch.Tensor, nx: int, th: int,
              tw: int, phase: dict, form: str):
    """A tiled phase at the windows ``sel``: (stage sums (K, S'), passed
    (K,)), from their tiles (``_tiles_at``) in chunks of at most
    _GATHER_FLOATS tile floats."""
    ph = _phase_on(phase, planes.device, form == "matmul")
    chunk = max(1, _GATHER_FLOATS // (phase["width"] * 8))
    vs, ps = [], []
    for s0 in range(0, sel.shape[0], chunk):
        D = _tiles_at(planes, sel[s0:s0 + chunk], nx, th, tw)
        n = D.shape[0]
        Dt = D.permute(1, 0, 2).reshape(D.shape[1], n * 8)
        box = _box_from_Dt(Dt, ph, form)
        v, p = _surf_eval_f4n8(box.reshape(phase["w"].shape[0], 4, n, 8), ph)
        vs.append(v)
        ps.append(p)
    return torch.cat(vs), torch.cat(ps)


def _first(mask: torch.Tensor, K: int) -> torch.Tensor:
    """The positions of mask's set entries first, in order, then the rest
    (a stable sort of ~mask), cut to K."""
    return torch.sort((~mask).to(torch.uint8), stable=True).indices[:K]


def _form_level(sat8: torch.Tensor, tabs: dict, ny: int, nx: int,
                step: int, form: str, K2: int, K1: Optional[int] = None):
    """One level of a plain staged form (ccv_tpu's ``_eval_level``) from its
    zero-padded (H1, W1, 8) SAT: phase A over every window; on the card
    phase B1 over every window too, then ONE compaction of the A & B1
    survivors to the first K2 and phase B2 on their tiles; on a CPU tensor
    ccv_tpu's sparse B1, phase B1 on the tiles of the first K1 phase-A
    survivors (default ``_level_capacity``), then B2 on the first K2 of
    those that pass. Returns (idx, passed, conf, counts (2,)): counts are the
    survivors of A and of A & B1, for the host's overflow test."""
    all_off = tabs["all_off"]
    planes, th, tw = _plane_planes(sat8, ny, nx, int(all_off[:, 0].max()),
                                   int(all_off[:, 1].max()), step)
    dev = sat8.device
    n = ny * nx
    last, S = tabs["last_count"], tabs["n_stages"]
    v_a, pass_a = _dense_phase(planes, tabs["phase_a"], ny, nx, step, form)
    idx = torch.arange(n, device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    count_a = pass_a.sum()
    if tabs["phase_b1"] is None:
        return (idx, pass_a, v_a[:, -1] / last + (S - 1),
                torch.stack([count_a, zero]))
    b1 = _tiled_phase(tabs, "phase_b1", step)
    b2 = _tiled_phase(tabs, "phase_b2", step)
    if dev.type != "cuda":
        K1 = _level_capacity(n) if K1 is None else K1
        idx1 = _first(pass_a, K1)
        v_b1, pass_b1 = _phase_at(planes, idx1, nx, th, tw, b1, form)
        valid1 = ((torch.arange(K1, device=dev) < torch.clamp(count_a,
                                                               max=K1))
                  & pass_a[idx1])
        alive1 = pass_b1 & valid1
        if b2 is None:
            return (idx1, alive1, v_b1[:, -1] / last + (S - 1),
                    torch.stack([count_a, zero]))
        count_b1 = alive1.sum()
        r2 = _first(alive1, K2)
        v_b2, pass_b2 = _phase_at(planes, idx1[r2], nx, th, tw, b2, form)
        valid2 = ((torch.arange(K2, device=dev) < torch.clamp(count_b1,
                                                               max=K2))
                  & alive1[r2])
        return (idx1[r2], pass_b2 & valid2, v_b2[:, -1] / last + (S - 1),
                torch.stack([count_a, count_b1]))
    v_b1, pass_b1 = _dense_phase(planes, tabs["phase_b1"], ny, nx, step,
                                 form)
    alive1 = pass_a & pass_b1
    if b2 is None:
        return (idx, alive1, v_b1[:, -1] / last + (S - 1),
                torch.stack([count_a, zero]))
    count_b1 = alive1.sum()
    idx2 = _first(alive1, K2)
    v_b2, pass_b2 = _phase_at(planes, idx2, nx, th, tw, b2, form)
    valid2 = ((torch.arange(K2, device=dev) < torch.clamp(count_b1, max=K2))
              & alive1[idx2])
    return (idx2, pass_b2 & valid2, v_b2[:, -1] / last + (S - 1),
            torch.stack([count_a, count_b1]))


def _form_out_len(tabs: dict, nwin: int, K2: int, sparse: bool) -> int:
    """Rows a level gives in a plain form (ccv_tpu's ``_out_len``)."""
    if tabs["phase_b1"] is None:
        return nwin
    if tabs["phase_b2"] is None:
        return _level_capacity(nwin) if sparse else nwin
    return K2


def _form_eval(sat_l: torch.Tensor, lspecs, B: int, tabs: dict, step: int,
               form: str, caps):
    """Every level of every image of an octave's (B*L, 8, H1, W1) SAT stack
    in a plain form: per level a float32 (n, 3) tensor of rows [window,
    passed, conf] and the (B*L, 2) survivor counts."""
    rows, counts = [], []
    L = len(lspecs)
    for b in range(B):
        for li, (_k, _r, _c, ny, nx) in enumerate(lspecs):
            idx, passed, conf, c2 = _form_level(
                sat_l[b * L + li].permute(1, 2, 0), tabs, ny, nx, step, form,
                caps[li])
            rows.append(torch.stack([idx.to(torch.float32),
                                     passed.to(torch.float32),
                                     conf.to(torch.float32)], dim=1))
            counts.append(c2.to(torch.float32))
    return rows, torch.stack(counts)


def form_level(src: torch.Tensor, spec, cascade: ScdClassifierCascade,
               params: ScdParams, form: str, capacity: Optional[int] = None):
    """One level of a plain staged form from its octave's (H, W, C) source,
    at ``capacity`` (default: every window, as the overflow rerun runs it;
    K1 and K2 both). Waits for the device; returns numpy (idx, passed,
    conf, count2)."""
    if form not in PLAIN_FORMS:
        raise ValueError(f"form must be one of {PLAIN_FORMS}, got {form!r}")
    (_octave, k, rows, cols, ny, nx, _scale) = spec
    sat = _octave_sats(src[None], [(k, rows, cols, ny, nx)], cascade.margin)
    K = ny * nx if capacity is None else capacity
    out = _form_level(sat[0].permute(1, 2, 0), form_tables(cascade), ny, nx,
                      params.step_through, form, K, K)
    idx, passed, conf, count2 = (t.cpu().numpy() for t in out)
    return (idx.astype(np.int64), passed.astype(bool),
            conf.astype(np.float32), count2.astype(np.float32))


# ---------------------------------------------------------------------------
# detect
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Pending:
    """A detect_async / detect_batch dispatch: the packed results of every
    image on their way to the host."""

    host: torch.Tensor            # (B, N) float32: per image, per octave
    ready: Optional[torch.cuda.Event]
    layout: list                  # per octave (form, offset, ...):
    #   ("pallas_full", offset, L, NY, NX): passed and conf planes;
    #   (form, offset, lens, sparse) for the staged forms: rows, then the
    #   count pairs; sparse: the CPU's sparse phase B1 (plain forms)
    specs: tuple
    cascade: ScdClassifierCascade
    params: ScdParams
    form: str
    evaluate: Callable
    pyr: dict                     # staged forms: octave -> its (B, H, W, C)
    #   source on the device, for the overflow rerun


def _octave_extra(lspecs, cascade: ScdClassifierCascade, step: int,
                  batch: bool) -> str:
    """ccv_tpu's ``_octave_extra``: the autotune key's extra field for an
    octave's level geometry, so both packages name an octave alike."""
    geom = "o" + ";".join(f"{r}x{c}g{ny}x{nx}"
                          for (_k, r, c, ny, nx) in lspecs)
    return f"{geom}s{step}n{len(cascade.stage_counts)}b{int(batch)}v5"


def _octave_piece(form: str, sat_l: torch.Tensor, lspecs, B: int,
                  cascade: ScdClassifierCascade, step: int,
                  evaluate: Optional[Callable]):
    """One octave of a (B*L, 8, H1, W1) SAT stack in ``form``: (piece (B, N)
    float32, its layout entry without the offset)."""
    dims = np.array([(ny, nx) for (*_r, ny, nx) in lspecs], np.int64)
    L, dims_b = len(lspecs), np.tile(dims, (B, 1))
    if form == "pallas_full":
        conf, passed = (evaluate or scd_cascade.cascade_eval_levels)(
            sat_l, cascade_tables(cascade), step, dims_b)
        conf = (conf / float(cascade.stage_counts[-1])
                + (cascade.n_stages - 1))
        piece = torch.stack([passed.to(torch.float32), conf]).reshape(
            2, B, -1).transpose(0, 1).reshape(B, -1)
        return piece, (L,) + tuple(conf.shape[1:])
    caps = [_level_capacity2(int(ny) * int(nx)) for ny, nx in dims]
    if form == "pallas":
        tabs = staged_tables(cascade)
        rows, counts = _staged_eval(sat_l, dims_b, tabs, step, caps * B,
                                    evaluate or scd_phase.phase_a)
        lens = tuple(_out_len(tabs, int(ny) * int(nx), cap)
                     for (ny, nx), cap in zip(dims, caps))
        sparse = False
    else:
        tabs = form_tables(cascade)
        rows, counts = _form_eval(sat_l, lspecs, B, tabs, step, form, caps)
        sparse = sat_l.device.type != "cuda"
        lens = tuple(_form_out_len(tabs, int(ny) * int(nx), cap, sparse)
                     for (ny, nx), cap in zip(dims, caps))
    piece = torch.cat([torch.cat(rows).reshape(B, -1),
                       counts.reshape(B, -1)], dim=1)
    return piece, (lens, sparse)


def _octave_program(form: str, lspecs, cascade: ScdClassifierCascade,
                    step: int) -> Callable:
    """The whole octave in ``form`` from its (H, W, C) source, the unit
    ``form="auto"`` times: prolog, then the form's evaluation. Takes
    (source, last stage's count) as ccv_tpu's octave programs do; the count
    is in the tables already."""
    def run(src: torch.Tensor, _last_count: torch.Tensor) -> torch.Tensor:
        sat_l = _octave_sats(src[None], lspecs, cascade.margin)
        return _octave_piece(form, sat_l, lspecs, 1, cascade, step, None)[0]
    return run


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def _auto_form(src: torch.Tensor, lspecs, cascade: ScdClassifierCascade,
               step: int) -> str:
    """form="auto" for one octave of a (B, H, W, C) source: "pallas_full" on
    a CPU tensor; on the card the single image's recorded choice, measured
    now on a miss (ccv_tpu's ``_get_octave_fn``, which a batch shares).
    Raises if a form recorded no time on the card: the rule that a form that
    cannot run never wins must not swap K1 and K3 quietly."""
    if not _on_card(src):
        return "pallas_full"
    from ccv_tpu_torch.nn import autotune

    args = (torch.zeros(tuple(src.shape[1:]), dtype=src.dtype,
                        device=src.device),
            torch.zeros((), dtype=torch.float32, device=src.device))
    extra = _octave_extra(lspecs, cascade, step, False)
    variants = {f: _octave_program(f, lspecs, cascade, step)
                for f in AUTO_FORMS}
    fn = autotune.choose(OCTAVE_OP, variants, args, default="pallas_full",
                         extra=extra)
    rec = autotune.decisions().get(autotune._key(OCTAVE_OP, args, extra))
    failed = sorted(k for k, ms in (rec or {}).get("ms", {}).items()
                    if ms is None)
    if failed:
        raise RuntimeError(
            f"form='auto': the {', '.join(failed)} form of octave {extra} "
            f"could not run on {autotune._kind(src.device)}: "
            f"{rec.get('errors', {})}")
    return next(name for name, f in variants.items() if f is fn)


def _dispatch(a: torch.Tensor, cascade: ScdClassifierCascade,
              params: ScdParams, form: str,
              evaluate: Optional[Callable]) -> _Pending:
    """Queue a (B, H, W, C) batch: per octave the prolog and the form's
    evaluation of every level of every image (one launch of K1 or two of K3
    on the card), then one copy of the packed results to pinned host
    memory, all without waiting for the device (``auto`` waits while it
    measures an octave it has no record of)."""
    if form not in ALL_FORMS:
        raise ValueError(f"form must be one of {ALL_FORMS}, got {form!r}")
    if evaluate is not None and form not in FORMS:
        raise ValueError(f"evaluate replaces the kernel of form "
                         f"'pallas_full' or 'pallas', not of {form!r}")
    B, H, W = a.shape[:3]
    step = params.step_through
    specs, scale_upto = _level_specs(H, W, cascade, params)
    pieces, layout, pyr, offset = [], [], {}, 0
    for octave, src, lspecs, sat_l, _dims in _octaves(a, specs, scale_upto,
                                                      cascade.margin):
        form_o = (_auto_form(src, lspecs, cascade, step) if form == "auto"
                  else form)
        piece, lay = _octave_piece(form_o, sat_l, lspecs, B, cascade, step,
                                   evaluate)
        layout.append((form_o, offset) + lay)
        if form_o != "pallas_full":
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
    device). ``form`` is "pallas_full" (kernel K1, the whole cascade),
    "pallas" (the staged cascade, kernel K3 for phases A and B1), "auto"
    (the measured choice between those two per octave on the card), or one
    of the plain staged forms "slices", "xla", "matmul". ``evaluate``
    replaces the kernel of "pallas_full" or "pallas" (same signature as
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


def _octave_levels(handle: _Pending, b: int):
    """Per octave of image ``b``: (form, sparse, per level of it either
    (passed (ny, nx) bool, conf (ny, nx) float32) planes for "pallas_full",
    or numpy (idx, passed, conf, count2) rows as the device left them)."""
    arr = _host(handle, b)
    specs = iter(handle.specs)
    out = []
    for entry in handle.layout:
        form, offset = entry[:2]
        if form == "pallas_full":
            L, NY, NX = entry[2:]
            grid = arr[offset:offset + 2 * L * NY * NX].reshape(2, L, NY, NX)
            levels = []
            for li in range(L):
                (*_r, ny, nx, _s) = next(specs)
                levels.append((grid[0, li, :ny, :nx] != 0.0,
                               grid[1, li, :ny, :nx]))
            out.append((form, False, levels))
            continue
        lens, sparse = entry[2:]
        n = sum(lens)
        rows = arr[offset:offset + 3 * n].reshape(n, 3)
        counts = arr[offset + 3 * n:offset + 3 * n + 2 * len(lens)].reshape(
            -1, 2)
        starts = np.cumsum((0,) + lens)
        out.append((form, sparse, [
            (rows[s:e, 0].astype(np.int64), rows[s:e, 1] != 0.0, rows[s:e, 2],
             counts[li])
            for li, (s, e) in enumerate(zip(starts[:-1], starts[1:]))]))
        for _ in lens:
            next(specs)
    return out


def level_planes(handle: _Pending, b: int = 0):
    """Wait for a "pallas_full" dispatch; per level of image ``b`` in specs
    order, (passed (ny, nx) bool, conf (ny, nx) float32) numpy planes."""
    octs = _octave_levels(handle, b)
    if any(form != "pallas_full" for form, _s, _l in octs):
        raise ValueError(f"level_planes reads a pallas_full dispatch, not "
                         f"{handle.form!r}: use level_rows")
    return [lv for _f, _s, levels in octs for lv in levels]


def level_rows(handle: _Pending, b: int = 0):
    """Wait for a dispatch of a staged form; per level of image ``b`` in
    specs order, numpy (idx, passed, conf, count2) as the device left them
    (no overflow rerun)."""
    octs = _octave_levels(handle, b)
    if any(form == "pallas_full" for form, _s, _l in octs):
        raise ValueError(f"level_rows reads a dispatch of a staged form, "
                         f"not {handle.form!r}: use level_planes")
    return [lv for _f, _s, levels in octs for lv in levels]


def _collect(handle: _Pending, b: int) -> List[Comp]:
    """Image ``b`` of a dispatch: its passed windows (rerunning any level
    whose survivors overflowed a capacity) -> rects -> merge_detections."""
    global RERUNS
    cascade, params = handle.cascade, handle.params
    outs = []
    specs = iter(handle.specs)
    for form, sparse, levels in _octave_levels(handle, b):
        for level in levels:
            spec = next(specs)
            if form == "pallas_full":
                passed, conf = level
                idx = np.flatnonzero(passed)
                outs.append((idx, conf.reshape(-1)[idx]))
                continue
            idx, passed, conf, count2 = level
            nwin = spec[4] * spec[5]
            over = count2[1] > _level_capacity2(nwin)
            if sparse and form_tables(cascade)["phase_b1"] is not None:
                over = over or count2[0] > _level_capacity(nwin)
            if over:
                RERUNS += 1
                src = handle.pyr[spec[0]][b]
                if form == "pallas":
                    idx, passed, conf, _ = staged_level(
                        src, spec, cascade, params,
                        evaluate=handle.evaluate)
                else:
                    idx, passed, conf, _ = form_level(src, spec, cascade,
                                                      params, form)
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
    """ccv_scd_detect_objects twin (ccv_scd.c:1653) for a single cascade;
    ``form`` as ``detect_async``'s."""
    return detect_collect(detect_async(img, cascade, params, device,
                                       evaluate, form))


def detect_batch(imgs, cascade: ScdClassifierCascade,
                 params: Optional[ScdParams] = None,
                 device: _device.DeviceLike = None,
                 form: str = "pallas_full") -> List[List[Comp]]:
    """``detect`` for a (B, H, W[, C]) batch of same-shape images: one
    kernel launch per octave for the whole batch (its B*L levels on the
    kernel's level axis) and one device->host copy; a level that overflows
    K2 is rerun for its image alone. ``form="auto"`` reuses the single
    image's recorded choice for each octave (measuring it on a miss)."""
    params = params or ScdParams()
    handle = _dispatch(_image(imgs, cascade, params, device, batch=True),
                       cascade, params, form, None)
    return [_collect(handle, b) for b in range(handle.host.shape[0])]
