"""ICF pedestrian detector (counterpart of ccv_tpu/detectors/icf.py;
reference: lib/ccv_icf.c).

The main path of ``detect_objects``, per image:

1. on the device, the octave pyramid (``sample_down``); per octave and
   cascade, per level: INTER_AREA resample, gray conversion for a gray
   cascade, margin pad, the channel map (``icf_channels``: LUV or gray,
   gradient magnitude and 6 soft orientation bins, ccv_icf.c:316) and its
   zero-padded SAT (``core.algebra.sat``), the levels stacked into one
   zero-padded tensor;
2. on the device, the soft cascade of depth-2 trees over every window of
   every level of the octave at once (``_octave_eval``), staged as in
   ccv_tpu: phase A, the first 64 trees, on every window; the survivors
   compact in window order to the first K1; phase B1, trees 64-319, on
   those; a second compaction to K2; phase B2, the rest. The reference's
   early exit at the first tree whose running sum falls below its
   threshold (ccv_icf.c:1999) is "every prefix sum >= its threshold",
   the prefix sums taken by JAX's associative scan as in ccv_tpu;
3. one copy of every octave's rows (window, passed, confidence) and
   survivor counts to the host; an octave whose survivors overflowed K1 or
   K2 runs again at full capacity (no window is lost), then windows ->
   rects, grouping and the inclusion filters (``_group_and_filter``).

Tree nodes sum boxes of SAT corners gathered per window. ccv_tpu's fused
accelerator forms (``slices``: exact corner row-takes of the phase planes;
``matmul``: the corner-matrix product) are TPU layouts of the same cascade
and are not ported. Type-B multiscale cascades (``detect_multiscale``) run
the whole cascade on every window of each octave's single channel map.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ccv_tpu_torch.core import algebra
from ccv_tpu_torch.core.dense_matrix import as_array
from ccv_tpu_torch.detectors.common import Comp, group, merge_detections
from ccv_tpu_torch.detectors.scd import _luv  # LUV of ccv_scd.c:298
from ccv_tpu_torch.device import to_device
from ccv_tpu_torch.ops import basic, resample


@dataclasses.dataclass
class IcfParams:
    """ccv_icf_default_params twin (ccv_icf.c:14)."""

    min_neighbors: int = 2
    threshold: float = 0.0
    step_through: int = 2
    interval: int = 8


@dataclasses.dataclass
class IcfCascade:
    """A type-A cascade: flattened depth-2 trees. Each of a tree's 3 nodes
    holds up to 2 boxes (alpha 0 pads), in the window's SAT coordinates.
    The device tables are built once per device from these arrays: change a
    cascade with ``dataclasses.replace``, not in place."""

    width: int
    height: int
    grayscale: int
    margin: tuple  # (left, top, right, bottom)
    n_weak: int
    pass_bits: np.ndarray       # (n,) bit 1: node 1 exists, bit 0: node 2
    weigh: np.ndarray           # (n, 2) vote when the tree says no / yes
    thresholds: np.ndarray      # (n,) soft-cascade threshold of the prefix
    channel: np.ndarray         # (n, 3, 2)
    alpha: np.ndarray           # (n, 3, 2)
    beta: np.ndarray            # (n, 3)
    sat0: np.ndarray            # (n, 3, 2, 2) x0, y0
    sat1: np.ndarray            # (n, 3, 2, 2) x1, y1


_FIELDS = ("pass_bits", "weigh", "thresholds", "channel", "alpha", "beta",
           "sat0", "sat1")
_DTYPES = dict(pass_bits=np.uint32, weigh=np.float32, thresholds=np.float32,
               channel=np.int32, alpha=np.float32, beta=np.float32,
               sat0=np.int32, sat1=np.int32)


def load_cascade(path: str) -> IcfCascade:
    """ccv_icf_read_classifier_cascade twin (text, %a hex floats)."""
    with open(path) as f:
        toks = f.read().split()
    pos = 0

    def rd(n=1):
        nonlocal pos
        out = toks[pos:pos + n]
        pos += n
        return out

    count, w, h, gray = (int(t) for t in rd(4))
    ml, mt, mr, mb = (int(t) for t in rd(4))
    arr = {k: np.zeros(s, _DTYPES[k]) for k, s in (
        ("pass_bits", count), ("weigh", (count, 2)), ("thresholds", count),
        ("channel", (count, 3, 2)), ("alpha", (count, 3, 2)),
        ("beta", (count, 3)), ("sat0", (count, 3, 2, 2)),
        ("sat1", (count, 3, 2, 2)))}

    def read_feature(i, f):
        cnt = int(rd(1)[0])
        arr["beta"][i, f] = float.fromhex(rd(1)[0])
        for q in range(cnt):
            ch_, al, x0, y0, x1, y1 = rd(6)
            arr["channel"][i, f, q] = int(ch_)
            arr["alpha"][i, f, q] = float.fromhex(al)
            arr["sat0"][i, f, q] = (int(x0), int(y0))
            arr["sat1"][i, f, q] = (int(x1), int(y1))

    for i in range(count):
        p, w0, w1, th = rd(4)
        arr["pass_bits"][i] = int(p)
        arr["weigh"][i] = (float.fromhex(w0), float.fromhex(w1))
        arr["thresholds"][i] = float.fromhex(th)
        read_feature(i, 0)
        if arr["pass_bits"][i] & 0x2:
            read_feature(i, 1)
        if arr["pass_bits"][i] & 0x1:
            read_feature(i, 2)
    return IcfCascade(width=w, height=h, grayscale=gray,
                      margin=(ml, mt, mr, mb), n_weak=count, **arr)


def write_cascade(cas: IcfCascade, path: str) -> None:
    """ccv_icf_write_classifier_cascade twin (text, %a hex floats; the copy
    of ccv_tpu/train/icf.py's writer)."""
    with open(path, "w") as w:
        w.write(f"{cas.n_weak} {cas.width} {cas.height} {cas.grayscale}\n")
        w.write(" ".join(str(m) for m in cas.margin) + "\n")
        for i in range(cas.n_weak):
            w.write(f"{int(cas.pass_bits[i])} "
                    f"{float(cas.weigh[i, 0]).hex()} "
                    f"{float(cas.weigh[i, 1]).hex()} "
                    f"{float(cas.thresholds[i]).hex()}\n")
            for f in range(3):
                if f == 1 and not (cas.pass_bits[i] & 0x2):
                    continue
                if f == 2 and not (cas.pass_bits[i] & 0x1):
                    continue
                cnt = int((cas.alpha[i, f] != 0).sum()) or 1
                w.write(f"{cnt} {float(cas.beta[i, f]).hex()}\n")
                for q in range(cnt):
                    w.write(f"{int(cas.channel[i, f, q])} "
                            f"{float(cas.alpha[i, f, q]).hex()}\n"
                            f"{int(cas.sat0[i, f, q, 0])} "
                            f"{int(cas.sat0[i, f, q, 1])} "
                            f"{int(cas.sat1[i, f, q, 0])} "
                            f"{int(cas.sat1[i, f, q, 1])}\n")


def cascade_from_jax(c) -> IcfCascade:
    """The port's cascade from a ``ccv_tpu`` IcfCascade (numpy fields, read
    by name; the arrays are copied)."""
    return IcfCascade(
        width=int(c.width), height=int(c.height), grayscale=int(c.grayscale),
        margin=tuple(int(m) for m in c.margin), n_weak=int(c.n_weak),
        **{k: np.array(getattr(c, k), _DTYPES[k]) for k in _FIELDS})


def icf_channels(img: torch.Tensor) -> torch.Tensor:
    """ccv_icf twin: the (H, W, 10) float32 map of a colour (H, W, 3) image,
    [L, U, V, |grad|, 6 orientation bins], or (H, W, 8) of a gray one,
    [gray, |grad|, 6 bins]. A colour pixel takes the gradient of its
    strongest channel, the first on ties (ccv_icf.c:370-380). A batch
    (N, H, W, 3) or (N, H, W, 1) gives (N, H, W, 10) or (N, H, W, 8)."""
    color = img.dim() >= 3 and img.shape[-1] == 3
    theta, mag = basic.gradient(img)
    if color:
        m0, m1, m2 = mag.unbind(-1)
        a0, a1, a2 = theta.unbind(-1)
        pick1 = m1 > m0
        pick2 = m2 > torch.maximum(m0, m1)
        mg = torch.where(pick2, m2, torch.where(pick1, m1, m0))
        ag = torch.where(pick2, a2, torch.where(pick1, a1, a0))
    else:
        mg = mag if mag.dim() == 2 else mag[..., 0]
        ag = theta if theta.dim() == 2 else theta[..., 0]
    mg = mg * (1.0 / math.sqrt(2.0))
    # ccv_tpu writes "/ 180.0 * 6.0" and "/ 255.0"; XLA compiles a division
    # by a constant to a product with its reciprocal and folds the two
    # constants, so these are the products ccv_tpu computes, bit for bit
    agr = torch.clamp(torch.where(ag <= 180.0, ag, ag - 180.0), 0,
                      179.99) * (6.0 / 180.0)
    ag0 = agr.to(torch.int64)
    ag1 = torch.where(ag0 < 5, ag0 + 1, 0)
    frac = agr - ag0
    hog = (F.one_hot(ag0, 6).to(torch.float32) * (mg * (1 - frac))[..., None]
           + F.one_hot(ag1, 6).to(torch.float32) * (mg * frac)[..., None])
    if color:
        l, u, v = _luv(img.to(torch.float32) * (1.0 / 255.0))
        head = [l[..., None], u[..., None], v[..., None]]
    else:
        head = [(img if img.dim() == 2 else img[..., 0]).to(
            torch.float32)[..., None]]
    return torch.cat(head + [mg[..., None], hog], dim=-1)


# ---------------------------------------------------------------------------
# the staged soft cascade
# ---------------------------------------------------------------------------

_ICF_PHASE_A = 64     # trees on every window
_ICF_PHASE_B1 = 320   # trees up to the end of phase B1

# gathered SAT values per chunk of windows (and as many int64 indices)
GATHER_CHUNK = 1 << 24


def _icf_capacity1(nwin: int) -> int:
    """Phase-B1 rows: ~2x the worst survivor rate after phase A seen on
    pedestrian.png (ccv_tpu's sizing); more survivors rerun the octave at
    full capacity (open thresholds always do)."""
    return int(min(nwin, max(64, nwin // 5)))


def _icf_capacity2(nwin: int) -> int:
    """Phase-B2 rows (survival after B1 was measured at 0.02%)."""
    return int(min(_icf_capacity1(nwin), max(32, nwin // 32)))


def _cuts(c: IcfCascade):
    """Tree ranges [lo, hi) of phases A, B1 and B2 (None where empty)."""
    cuts = (0, min(_ICF_PHASE_A, c.n_weak), min(_ICF_PHASE_B1, c.n_weak),
            c.n_weak)
    return [(lo, hi) if hi > lo else None
            for lo, hi in zip(cuts[:-1], cuts[1:])]


def _tree_tables(c: IcfCascade, lo: int, hi: int, dev: torch.device):
    """Device tables of trees [lo, hi): the corners of every box in (tree,
    node, box, corner) order as (y, x, channel), and the node and vote
    arithmetic."""
    x0, y0 = c.sat0[lo:hi, ..., 0], c.sat0[lo:hi, ..., 1]
    x1, y1 = c.sat1[lo:hi, ..., 0] + 1, c.sat1[lo:hi, ..., 1] + 1
    xs = np.stack([x0, x1, x0, x1], -1)
    ys = np.stack([y0, y0, y1, y1], -1)
    ch = np.broadcast_to(c.channel[lo:hi, ..., None], xs.shape)
    t = {k: to_device(np.ascontiguousarray(v, np.int64).reshape(-1), dev)
         for k, v in (("ys", ys), ("xs", xs), ("ch", ch))}
    t.update((k, to_device(np.ascontiguousarray(v, np.float32), dev))
             for k, v in (("alpha", c.alpha[lo:hi].reshape(-1)),
                          ("beta", c.beta[lo:hi]),
                          ("w0", c.weigh[lo:hi, 0]), ("w1", c.weigh[lo:hi, 1]),
                          ("thresholds", c.thresholds[lo:hi])))
    t.update((k, to_device(np.ascontiguousarray(v), dev))
             for k, v in (("has1", (c.pass_bits[lo:hi] & 2) != 0),
                          ("has2", (c.pass_bits[lo:hi] & 1) != 0)))
    return t


def _tables(c: IcfCascade, dev: torch.device):
    """Per-phase device tables (None for an empty phase) and the whole
    cascade's, built once per device."""
    cache = c.__dict__.setdefault("_device_tables", {})
    key = str(dev)
    if key not in cache:
        cache[key] = dict(
            phases=[None if p is None else _tree_tables(c, *p, dev)
                    for p in _cuts(c)],
            full=_tree_tables(c, 0, c.n_weak, dev))
    return cache[key]


def _gather(flat: torch.Tensor, base: torch.Tensor, tabs: dict,
            sat_cols: int, channels: int) -> torch.Tensor:
    """SAT corner values (n, T*24) of windows at linear offsets ``base``."""
    off = (tabs["ys"] * sat_cols + tabs["xs"]) * channels + tabs["ch"]
    return flat[base[:, None] + off[None, :]]


def _node_votes(g: torch.Tensor, tabs: dict) -> torch.Tensor:
    """Depth-2 tree votes (n, T) from corner values (n, T*24)
    (_ccv_icf_run_weak_classifier as selects): box sums TL - TR - BL + BR in
    that order, times alpha, the node's two boxes summed, plus beta."""
    n = g.shape[0]
    q = g.reshape(n, -1, 4)
    box = ((q[..., 0] - q[..., 1]) - q[..., 2]) + q[..., 3]
    fval = (box * tabs["alpha"]).reshape(n, -1, 3, 2).sum(-1) + tabs["beta"]
    c0, c1, c2 = fval.unbind(-1)
    pos = torch.where(tabs["has2"], c2 > 0, True)
    neg = torch.where(tabs["has1"], c1 > 0, False)
    return torch.where(torch.where(c0 > 0, pos, neg), tabs["w1"], tabs["w0"])


def _phase(flat: torch.Tensor, base: torch.Tensor, prior: torch.Tensor,
           tabs: dict, sat_cols: int, channels: int):
    """One block of trees on windows ``base`` entering with running sums
    ``prior``: (alive (n,), the block's last running sum (n,)), alive where
    every prefix sum is at least its tree's threshold. Chunked over windows
    so at most GATHER_CHUNK corners are gathered at once."""
    per = tabs["ys"].numel()
    step = max(1, GATHER_CHUNK // per)
    alive, last = [], []
    for s in range(0, base.numel(), step):
        g = _gather(flat, base[s:s + step], tabs, sat_cols, channels)
        csum = (algebra.associative_scan_add(_node_votes(g, tabs), -1)
                + prior[s:s + step, None])
        alive.append(torch.all(csum >= tabs["thresholds"], dim=-1))
        last.append(csum[:, -1])
    if not alive:
        return (torch.zeros(0, dtype=torch.bool, device=flat.device),
                prior.new_zeros(0))
    return torch.cat(alive), torch.cat(last)


def _compact(alive: torch.Tensor, K: int):
    """The first K set positions of ``alive`` in order, without reading the
    device: (rows (K,), valid (K,), count) where rows past the count are 0
    and invalid."""
    n = alive.numel()
    pos = torch.cumsum(alive.to(torch.int64), 0) - 1
    count = pos[-1] + 1 if n else pos.new_zeros(())
    dst = torch.where(alive & (pos < K), pos, K)
    rows = torch.zeros(K + 1, dtype=torch.int64, device=alive.device)
    rows.scatter_(0, dst, torch.arange(n, device=alive.device))
    valid = torch.arange(K, device=alive.device) < torch.clamp(count, max=K)
    return rows[:K], valid, count


def _octave_eval(flat: torch.Tensor, base: torch.Tensor, phases, K1: int,
                 K2: int, sat_cols: int, channels: int):
    """The staged cascade over windows ``base`` of one octave: rows (K, 3)
    float64 [window, passed, conf] and counts (2,) float64 [survivors of
    phase A, of phase B1] for the overflow test."""
    pa, pb1, pb2 = phases
    ntot = base.numel()
    zero = base.new_zeros(())
    alive_a, sum_a = _phase(flat, base, torch.zeros(
        ntot, dtype=torch.float32, device=base.device), pa, sat_cols,
        channels)
    if pb1 is None:
        rows = (torch.arange(ntot, device=base.device), alive_a, sum_a)
        counts = (alive_a.sum(), zero)
    else:
        idx1, valid1, count_a = _compact(alive_a, K1)
        alive_b1, sum_b1 = _phase(flat, base[idx1], sum_a[idx1], pb1,
                                  sat_cols, channels)
        alive1 = alive_b1 & valid1
        if pb2 is None:
            rows = (idx1, alive1, sum_b1)
            counts = (count_a, zero)
        else:
            r2, valid2, count_b1 = _compact(alive1, K2)
            alive_b2, sum_b2 = _phase(flat, base[idx1[r2]], sum_b1[r2], pb2,
                                      sat_cols, channels)
            rows = (idx1[r2], alive_b2 & valid2, sum_b2)
            counts = (count_a, count_b1)
    return (torch.stack([r.to(torch.float64) for r in rows], 1),
            torch.stack([c.to(torch.float64) for c in counts]))


def _gray_u8(image: torch.Tensor) -> torch.Tensor:
    """core.io.rgb_to_gray_u8 on the device (libjpeg's coefficients), as
    float32, as ccv_tpu's in-graph twin."""
    r, g, b = (image[..., i].to(torch.int32) for i in range(3))
    return ((r * 6969 + g * 23434 + b * 2365) >> 15).to(torch.float32)


def _level_sat(src: torch.Tensor, casc: IcfCascade, rows: int, cols: int,
               is_base: bool) -> torch.Tensor:
    """Zero-padded SAT (rows+mt+mb+1, cols+ml+mr+1, C) of one level of an
    (H, W, C) octave source: resample, gray for a gray cascade, margin pad,
    channel map."""
    ml, mt, mr, mb = casc.margin
    image = src if is_base else resample.resample(
        src, rows=rows, cols=cols, rows_scale=rows / src.shape[0],
        cols_scale=cols / src.shape[1], interp=resample.INTER_AREA)
    if casc.grayscale and image.shape[-1] == 3:
        image = _gray_u8(image)[..., None]
    image = F.pad(image, (0, 0, ml, mr, mt, mb))
    chans = icf_channels(image[..., 0] if casc.grayscale else image)
    return algebra.sat(chans, algebra.PADDING_ZERO)


def _octave_windows(src: torch.Tensor, casc: IcfCascade, lvls, step: int):
    """(flat SAT stack, window offsets, sat_cols, channels) of one octave's
    levels: every level's SAT in one zero-padded (L, H1, W1, C) stack, the
    windows of level after level in window order (wy * nx + wx)."""
    sats = [_level_sat(src, casc, rows, cols, k == 0)
            for (k, _scale, rows, cols, _ny, _nx) in lvls]
    H1 = max(s.shape[0] for s in sats)
    W1 = max(s.shape[1] for s in sats)
    C = sats[0].shape[2]
    stack = sats[0].new_zeros((len(sats), H1, W1, C))
    bases = []
    dev = src.device
    for li, (s, (_k, _sc, _r, _c, ny, nx)) in enumerate(zip(sats, lvls)):
        stack[li, :s.shape[0], :s.shape[1]] = s
        iy = torch.arange(ny, device=dev) * step
        ix = torch.arange(nx, device=dev) * step
        bases.append((li * H1 * W1 + iy[:, None] * W1 + ix[None, :]).reshape(
            -1) * C)
    return stack.reshape(-1), torch.cat(bases), W1, C


def _octave_levels(shape, casc: IcfCascade, params: IcfParams):
    """(k, scale, rows, cols, ny, nx) of every level of an octave source of
    ``shape`` that has windows."""
    ml, mt, mr, mb = casc.margin
    scale_ratio = 2.0 ** (1.0 / (params.interval + 1))
    step = params.step_through
    scale, lvls = 1.0, []
    for k in range(params.interval + 1):
        rows = int(shape[0] / scale + 0.5)
        cols = int(shape[1] / scale + 0.5)
        if rows < casc.height or cols < casc.width:
            break
        ny = max(0, -(-(rows + mt + mb - casc.height) // step))
        nx = max(0, -(-(cols + ml + mr - casc.width) // step))
        if ny and nx:
            lvls.append((k, scale, rows, cols, ny, nx))
        scale *= scale_ratio
    return tuple(lvls)


@dataclasses.dataclass
class _Pending:
    """A detect_async dispatch: the packed rows and counts of every octave
    on their way to the host."""

    host: torch.Tensor            # (N,) float64
    ready: Optional[torch.cuda.Event]
    specs: list                   # (ci, octave, lvls, K1, K2, offset, nrows)
    pyr: list                     # octave sources on the device
    cascades: list
    params: IcfParams


def detect_async(a, cascades, params: Optional[IcfParams] = None,
                 device=None) -> _Pending:
    """Queue the pyramid and the staged cascades of every octave without
    waiting for the device; ``detect_collect`` finishes. ``a`` is (H, W[,
    C]) uint8 on ``device`` (default: where a tensor is, else the card);
    ``cascades`` an IcfCascade or a list of them."""
    params = params or IcfParams()
    cascades = (list(cascades) if isinstance(cascades, (list, tuple))
                else [cascades])
    img = as_array(a, device)
    if img.dim() == 2:
        img = img[..., None]
    H, W = img.shape[:2]
    scale_upto = 1
    for c in cascades:
        eff_h = c.height - c.margin[1] - c.margin[3]
        eff_w = c.width - c.margin[0] - c.margin[2]
        scale_upto = max(scale_upto,
                         int(math.log2(min(H / eff_h, W / eff_w))) + 1)
    pyr = [img]
    for _ in range(1, scale_upto):
        pyr.append(resample.sample_down(pyr[-1]))
    specs, pieces, offset = [], [], 0
    for octave, level in enumerate(pyr):
        for ci, casc in enumerate(cascades):
            lvls = _octave_levels(level.shape, casc, params)
            if not lvls:
                continue
            ntot = sum(ny * nx for (*_r, ny, nx) in lvls)
            K1, K2 = _icf_capacity1(ntot), _icf_capacity2(ntot)
            flat, base, W1, C = _octave_windows(level, casc, lvls,
                                                params.step_through)
            rows, counts = _octave_eval(flat, base,
                                        _tables(casc, img.device)["phases"],
                                        K1, K2, W1, C)
            specs.append((ci, octave, lvls, K1, K2, offset, rows.shape[0]))
            pieces += [rows.reshape(-1), counts]
            offset += rows.numel() + 2
    ready = None
    if not pieces:
        host = torch.zeros(0, dtype=torch.float64)
    else:
        packed = torch.cat(pieces)
        if packed.device.type == "cuda":
            host = torch.empty(packed.shape, dtype=packed.dtype,
                               pin_memory=True)
            host.copy_(packed, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(packed.device))
        else:
            host = packed
    return _Pending(host, ready, specs, pyr, cascades, params)


# octaves run again at full capacity because survivors overflowed K1 or K2
RERUNS = 0


def detect_collect(handle: _Pending) -> List[Comp]:
    """Wait for detect_async: rerun any octave that overflowed, windows ->
    rects, then the grouping of ``_group_and_filter``."""
    global RERUNS
    if handle.ready is not None:
        handle.ready.synchronize()
    arr = handle.host.numpy()
    params = handle.params
    step = params.step_through
    comps_all: List[List[Comp]] = [[] for _ in handle.cascades]
    for (ci, octave, lvls, K1, K2, off, nrows) in handle.specs:
        casc = handle.cascades[ci]
        rows = arr[off:off + 3 * nrows].reshape(nrows, 3)
        count_a, count_b1 = arr[off + 3 * nrows:off + 3 * nrows + 2]
        phases = _tables(casc, handle.pyr[0].device)["phases"]
        if ((phases[1] is not None and count_a > K1)
                or (phases[2] is not None and count_b1 > K2)):
            RERUNS += 1
            ntot = sum(ny * nx for (*_r, ny, nx) in lvls)
            flat, base, W1, C = _octave_windows(handle.pyr[octave], casc,
                                                lvls, step)
            full, _ = _octave_eval(flat, base, phases, ntot, ntot, W1, C)
            rows = full.cpu().numpy()
        hit = rows[rows[:, 1] != 0]
        bounds = np.cumsum([0] + [ny * nx for (*_r, ny, nx) in lvls])
        ml, mt, mr, mb = casc.margin
        for g, conf in zip(hit[:, 0].astype(np.int64).tolist(),
                           hit[:, 2].tolist()):
            lv = int(np.searchsorted(bounds, g, side="right")) - 1
            (_k, scale, _rows, _cols, _ny, nx) = lvls[lv]
            wy, wx = divmod(g - int(bounds[lv]), nx)
            sc = scale * (1 << octave)
            comps_all[ci].append(Comp(
                x=int((wx * step + 0.5) * sc - 0.5),
                y=int((wy * step + 0.5) * sc - 0.5),
                width=int((casc.width - ml - mr) * sc),
                height=int((casc.height - mt - mb) * sc),
                confidence=conf, classification_id=ci + 1))
    return _group_and_filter(comps_all, params)


def detect_objects(a, cascades, params: Optional[IcfParams] = None,
                   device=None) -> List[Comp]:
    """ccv_icf_detect_objects twin (type-A cascades, ccv_icf.c:2178)."""
    return detect_collect(detect_async(a, cascades, params, device))


def _group_and_filter(comps_all: List[List[Comp]],
                      params: IcfParams) -> List[Comp]:
    """Grouping and the inclusion filters (ccv_icf.c:2184-2286)."""
    result: List[Comp] = []
    for comps in comps_all:
        if params.min_neighbors == 0:
            result += comps
            continue
        if not comps:
            continue

        def same(r1, r2):
            d = int(min(r1.width, r1.height) * 0.25 + 0.5)
            return (r2.classification_id == r1.classification_id
                    and r1.x - d <= r2.x <= r1.x + d
                    and r1.y - d <= r2.y <= r1.y + d
                    and r2.width <= int(r1.width * 1.5 + 0.5)
                    and int(r2.width * 1.5 + 0.5) >= r1.width
                    and r2.height <= int(r1.height * 1.5 + 0.5)
                    and int(r2.height * 1.5 + 0.5) >= r1.height)

        idx = group(comps, same)
        ng = max(idx) + 1
        best: List[Optional[Comp]] = [None] * ng
        counts = [0] * ng
        for cmp_, g in zip(comps, idx):
            counts[g] += 1
            if best[g] is None or cmp_.confidence > best[g].confidence:
                best[g] = cmp_
        seq2 = [dataclasses.replace(b, neighbors=n)
                for b, n in zip(best, counts) if n >= params.min_neighbors]
        # mutual inclusion (ccv_icf.c:2228-2283): first mute large rects
        # holding a better smaller one (muted rects still contain others in
        # the second pass, like the reference's negated ids)
        muted = [False] * len(seq2)
        for i, r2 in enumerate(seq2):
            d = int(min(r2.width, r2.height) * 0.25 + 0.5)
            for j, r1 in enumerate(seq2):
                if i == j:
                    continue
                if (r1.x >= r2.x - d and r1.y >= r2.y - d
                        and r1.x + r1.width <= r2.x + r2.width + d
                        and r1.y + r1.height <= r2.y + r2.height + d
                        and r2.confidence <= r1.confidence
                        and r2.neighbors < r1.neighbors):
                    muted[i] = True
                    break
        for i, r1 in enumerate(seq2):
            if muted[i]:
                continue
            flag = True
            for j, r2 in enumerate(seq2):
                d = int(min(r2.width, r2.height) * 0.25 + 0.5)
                if (i != j and r1.x >= r2.x - d and r1.y >= r2.y - d
                        and r1.x + r1.width <= r2.x + r2.width + d
                        and r1.y + r1.height <= r2.y + r2.height + d
                        and (r2.confidence > r1.confidence
                             or r2.neighbors >= r1.neighbors)):
                    flag = False
                    break
            if flag:
                result.append(r1)
    return result


# ---------------------------------------------------------------------------
# type-B multiscale cascades (ccv_icf_multiscale_classifier_cascade_t)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class IcfMultiscaleCascade:
    """ccv_icf_multiscale_classifier_cascade_t twin: per-scale type-A
    cascades covering one octave; the pyramid needs only sample_down
    between octaves (no INTER_AREA levels)."""

    octave: int
    grayscale: int
    cascades: List[IcfCascade]

    @property
    def count(self):
        return len(self.cascades)


def load_multiscale_cascade(directory: str) -> IcfMultiscaleCascade:
    """ccv_icf_read_multiscale_classifier_cascade twin (a directory with a
    ``multiscale`` file and cascade-N files, ccv_icf.c:1893)."""
    with open(os.path.join(directory, "multiscale")) as f:
        octave, count, grayscale = (int(t) for t in f.read().split()[:3])
    cascades = [load_cascade(os.path.join(directory, f"cascade-{i + 1}"))
                for i in range(count)]
    return IcfMultiscaleCascade(octave=octave, grayscale=grayscale,
                                cascades=cascades)


def write_multiscale_cascade(ms: IcfMultiscaleCascade,
                             directory: str) -> None:
    """ccv_icf_write_multiscale_classifier_cascade twin."""
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "multiscale"), "w") as f:
        f.write(f"{ms.octave} {ms.count} {ms.grayscale}\n")
    for i, cas in enumerate(ms.cascades):
        write_cascade(cas, os.path.join(directory, f"cascade-{i + 1}"))


def _eval_dense(flat: torch.Tensor, base: torch.Tensor, tabs: dict,
                sat_cols: int, channels: int):
    """The whole cascade on windows ``base``, no staging: (passed, conf),
    the running sums by ccv_tpu's cumsum (XLA's tiled order)."""
    per = tabs["ys"].numel()
    step = max(1, GATHER_CHUNK // per)
    passed, conf = [], []
    for s in range(0, base.numel(), step):
        g = _gather(flat, base[s:s + step], tabs, sat_cols, channels)
        csum = algebra.tiled_cumsum(_node_votes(g, tabs), -1)
        passed.append(torch.all(csum >= tabs["thresholds"], dim=-1))
        conf.append(csum[:, -1])
    return torch.cat(passed), torch.cat(conf)


def detect_multiscale(a, ms: IcfMultiscaleCascade,
                      params: Optional[IcfParams] = None,
                      device=None) -> List[Comp]:
    """Type-B detection (ccv_icf.c:2055): one channel map and SAT per
    octave, every per-scale cascade over every window of it (the per-scale
    training replaces type A's per-interval resampling)."""
    params = params or IcfParams()
    img = as_array(a, device)
    if img.dim() == 2:
        img = img[..., None]
    H, W = img.shape[:2]
    min_h = min(c.height for c in ms.cascades)
    min_w = min(c.width for c in ms.cascades)
    scale_upto = max(1, int(math.log2(min(H / min_h, W / min_w))) + 1)
    pyr = [img]
    for _ in range(1, scale_upto):
        pyr.append(resample.sample_down(pyr[-1]))
    comps: List[Comp] = []
    step = params.step_through
    for octave, level in enumerate(pyr):
        sat = algebra.sat(icf_channels(level[..., 0] if ms.grayscale
                                       else level), algebra.PADDING_ZERO)
        H1, W1, C = sat.shape
        for casc in ms.cascades:
            ny = max(0, -(-(H1 - 1 - casc.height) // step))
            nx = max(0, -(-(W1 - 1 - casc.width) // step))
            if ny == 0 or nx == 0:
                continue
            iy = torch.arange(ny, device=img.device) * step
            ix = torch.arange(nx, device=img.device) * step
            base = (iy[:, None] * W1 + ix[None, :]).reshape(-1) * C
            passed, conf = _eval_dense(sat.reshape(-1), base,
                                       _tables(casc, img.device)["full"],
                                       W1, C)
            widx = torch.nonzero(passed).squeeze(1)
            hits = zip(widx.cpu().tolist(), conf[widx].cpu().tolist())
            sc = float(1 << octave)
            for w_, c_ in hits:
                wy, wx = divmod(w_, nx)
                comps.append(Comp(
                    x=int((wx * step + 0.5) * sc - 0.5),
                    y=int((wy * step + 0.5) * sc - 0.5),
                    width=int(casc.width * sc), height=int(casc.height * sc),
                    confidence=c_, classification_id=1))
    if params.min_neighbors == 0:
        return comps
    return merge_detections(comps, params.min_neighbors)
