"""Kernel K1: the full SCD cascade over every window of an octave.

Counterpart of ccv_tpu/ops/pallas/scd_cascade.py. Four pieces:

- ``build_tables``: the whole cascade (every feature, stage-ordered) as
  host arrays, with each feature's distinct box corners and its layout
  (``LAYOUTS``), and device copies made once per device;
- ``cascade_eval_levels_ref``: the plain PyTorch version, vectorised over
  windows, in the op order of the kernel (the twin of the NumPy oracle in
  tests/test_scd_kernel.py);
- ``phase_planes`` / ``kernel_planes``: the SAT stack as step x step phase
  planes, the layout the kernel reads (ccv_tpu's ``_planes_cf``), and with
  it K3 (ops/kernels/scd_phase.py);
- ``cascade_eval_levels``: the wrapper. On a CPU tensor it runs the plain
  version; on a CUDA tensor it makes the phase planes and launches the
  hand-written kernel (csrc/scd_cascade.cu) or raises. ``LAUNCHES`` counts
  its launches.

Input is the channels-first SAT stack of one octave, ``(L, 8, H1, W1)``
float32, zero-padded to the octave's largest level; ``dims`` holds each
level's real ``(ny, nx)`` window grid. Window ``(wy, wx)`` reads corner
``(oy, ox)`` at ``sat[l, c, wy*step + oy, wx*step + ox]``. Outputs are
``conf`` float32 and ``passed`` bool, both ``(L, NY, NX)`` with
``NY, NX = dims.max(0)``; entries outside a level's grid are not passed.
``conf`` is the sum of the last stage a window reached and is meaningful
only where ``passed``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ccv_tpu_torch.device import to_device
from ccv_tpu_torch.ops.kernels import _build

THETA = 2.0 / math.sqrt(32.0)  # L2Hys clip
CHANNELS = 8

# Box layouts, compiled into the kernel from here (layout_flags): for the 4
# boxes in order, and in each the corners (sy,sx), (sy,dx), (dy,sx),
# (dy,dx), the index of the corner among the feature's distinct corners in
# order of first appearance. They are the three layouts of SCD's feature
# generator. A feature of any other layout is layout 0: the kernel reads its
# 16 box corners one by one.
LAYOUTS = {1: (0, 1, 2, 3, 2, 3, 4, 5, 4, 5, 6, 7, 6, 7, 8, 9),   # 1x4
           2: (0, 1, 2, 3, 1, 4, 3, 5, 4, 6, 5, 7, 6, 8, 7, 9),   # 4x1
           3: (0, 1, 2, 3, 2, 3, 4, 5, 1, 6, 3, 7, 3, 7, 5, 8)}   # 2x2
BOX_ORDER = tuple(range(16))  # layout 0


def layout_flags() -> Tuple[str, ...]:
    """The nvcc flag that compiles LAYOUTS into csrc/scd_planes.cuh, the
    header of both SCD kernels (K1 and K3): SCD_LAYOUT_SLOTS, SCD_SLOT(code)
    for each layout of 1.. in order, the code its 16 slots of 4 bits, slot 0
    lowest."""
    codes = [sum(s << (4 * i) for i, s in enumerate(LAYOUTS[k]))
             for k in range(1, len(LAYOUTS) + 1)]
    return ("-DSCD_LAYOUT_SLOTS="
            + "".join(f"SCD_SLOT({c:#018x}ull)" for c in codes),)

# kernel launches made by cascade_eval_levels (CUDA tensors only)
LAUNCHES = 0


@dataclasses.dataclass
class CascadeTables:
    """A whole cascade, features in stage order.

    boxes[f, b] = (sy, sx, dy, dx) of box b of feature f; w[f, b*8 + c] is
    the weight of box b, channel c. corners[f, :n_corners[f]] are the
    distinct (oy, ox) corners of feature f, in order of first appearance
    over its boxes' corners (sy,sx), (sy,dx), (dy,sx), (dy,dx); cidx[f, b]
    are box b's four corners in that order as indices into them; layout[f]
    is the feature's key in LAYOUTS, or 0."""

    stage_ranges: Tuple[Tuple[int, int], ...]  # (f0, f1) per stage
    thresholds: np.ndarray                     # (S,) float32
    boxes: np.ndarray                          # (F, 4, 4) int32
    w: np.ndarray                              # (F, 32) float32
    bias: np.ndarray                           # (F,) float32
    corners: np.ndarray                        # (F, 16, 2) int32
    n_corners: np.ndarray                      # (F,) int32
    cidx: np.ndarray                           # (F, 4, 4) int32
    layout: np.ndarray                         # (F,) int32
    _on: Dict[str, Dict[str, torch.Tensor]] = dataclasses.field(
        default_factory=dict, repr=False)

    @property
    def n_stages(self) -> int:
        return len(self.stage_ranges)

    @property
    def n_features(self) -> int:
        return len(self.bias)

    @property
    def extent(self) -> Tuple[int, int]:
        """(largest corner row offset, largest corner column offset)."""
        ys = self.boxes[:, :, [0, 2]]
        xs = self.boxes[:, :, [1, 3]]
        return int(ys.max()), int(xs.max())

    def on(self, device: torch.device) -> Dict[str, torch.Tensor]:
        """The kernel's device buffers, made once per device."""
        key = str(device)
        got = self._on.get(key)
        if got is None:
            ends = np.array([f1 for _f0, f1 in self.stage_ranges], np.int32)
            feats = np.concatenate([self.w, self.bias[:, None]], axis=1)
            got = dict(
                stage_end=to_device(ends, device),
                thresholds=to_device(self.thresholds.astype(np.float32),
                                     device),
                feats=to_device(feats.astype(np.float32), device))
            self._on[key] = got
        return got

    def corner_planes(self, step: int) -> np.ndarray:
        """(F, 16, 3) int32: each distinct corner as (phase plane
        (oy % step) * step + ox % step, row offset oy // step, column
        offset ox // step); rows past n_corners are 0."""
        oy, ox = self.corners[..., 0], self.corners[..., 1]
        return np.stack([(oy % step) * step + ox % step, oy // step,
                         ox // step], axis=-1).astype(np.int32)

    def records(self, step: int, hs: int, ws: int) -> np.ndarray:
        """(F, 17) int32, the kernel's per-feature corner records for
        phase planes of (hs, ws): the layout, then the float offset in a
        level's planes (plane * 8 * hs * ws + row * ws + column) of each
        corner the layout's slots name, corner k being the box corner of
        the first slot k (layouts 1..: the distinct corners; layout 0: the
        16 box corners in box order); unused entries 0."""
        cp = self.corner_planes(step).astype(np.int64)
        off = cp[..., 0] * (CHANNELS * hs * ws) + cp[..., 1] * ws + cp[..., 2]
        box = np.take_along_axis(off, self.cidx.reshape(-1, 16), axis=1)
        first = np.full((len(LAYOUTS) + 1, 16), -1)
        for key, slots in {0: BOX_ORDER, **LAYOUTS}.items():
            first[key, :max(slots) + 1] = [slots.index(k)
                                           for k in range(max(slots) + 1)]
        pick = first[self.layout]
        rec = np.where(pick >= 0, np.take_along_axis(
            box, np.maximum(pick, 0), axis=1), 0)
        return np.concatenate([self.layout[:, None], rec],
                              axis=1).astype(np.int32)

    def records_on(self, device: torch.device, step: int, hs: int,
                   ws: int) -> torch.Tensor:
        """``records`` on ``device``, made once per device and shape."""
        key = f"records {device} {step} {hs} {ws}"
        got = self._on.get(key)
        if got is None:
            got = to_device(self.records(step, hs, ws), device)
            self._on[key] = got
        return got


def build_tables(thresholds, sx, sy, dx, dy, bias, w,
                 stage_of) -> CascadeTables:
    """CascadeTables from per-feature arrays (ScdClassifierCascade fields).

    Each stage's features must be one contiguous run, stages in order: the
    kernel walks features f0..f1 per stage. Raises ValueError otherwise."""
    stage_of = np.asarray(stage_of)
    n_features = len(stage_of)
    ranges = []
    start = 0
    for s in range(len(thresholds)):
        idx = np.nonzero(stage_of == s)[0]
        if (len(idx) == 0 or idx[0] != start
                or idx[-1] - idx[0] + 1 != len(idx)):
            raise ValueError(
                f"stage {s}: features are not one contiguous run after "
                f"feature {start} (the cascade evaluator walks stages in "
                f"feature order)")
        ranges.append((int(idx[0]), int(idx[-1]) + 1))
        start = int(idx[-1]) + 1
    if start != n_features:
        raise ValueError(f"features {start}..{n_features} belong to no stage")
    boxes = np.stack([np.asarray(sy), np.asarray(sx), np.asarray(dy),
                      np.asarray(dx)], axis=-1).astype(np.int32)
    return CascadeTables(
        stage_ranges=tuple(ranges),
        thresholds=np.asarray(thresholds, np.float32).copy(),
        boxes=boxes,
        w=np.asarray(w, np.float32).reshape(n_features, 32).copy(),
        bias=np.asarray(bias, np.float32).copy(),
        **_corner_tables(boxes))


def _corner_tables(boxes: np.ndarray) -> Dict[str, np.ndarray]:
    """corners, n_corners, cidx and layout (CascadeTables) of (F, 4, 4)
    (sy, sx, dy, dx) boxes."""
    n_features = boxes.shape[0]
    sy, sx, dy, dx = (boxes[..., i] for i in range(4))
    slots = np.stack([np.stack([sy, sx], -1), np.stack([sy, dx], -1),
                      np.stack([dy, sx], -1), np.stack([dy, dx], -1)],
                     axis=2).reshape(n_features, 16, 2)
    corners = np.zeros((n_features, 16, 2), np.int32)
    n_corners = np.zeros(n_features, np.int32)
    cidx = np.zeros((n_features, 16), np.int32)
    layout = np.zeros(n_features, np.int32)
    by_slots = {v: k for k, v in LAYOUTS.items()}
    for f in range(n_features):
        seen: Dict[Tuple[int, int], int] = {}
        for j, (y, x) in enumerate(slots[f].tolist()):
            cidx[f, j] = seen.setdefault((y, x), len(seen))
        corners[f, :len(seen)] = list(seen)
        n_corners[f] = len(seen)
        layout[f] = by_slots.get(tuple(cidx[f].tolist()), 0)
    return dict(corners=corners, n_corners=n_corners,
                cidx=cidx.reshape(n_features, 4, 4), layout=layout)


def _check(sat_l: torch.Tensor, tables: CascadeTables, step: int,
           dims) -> np.ndarray:
    if sat_l.dtype != torch.float32:
        raise TypeError(f"sat_l must be float32, got {sat_l.dtype}")
    if sat_l.dim() != 4 or sat_l.shape[1] != CHANNELS:
        raise ValueError(f"sat_l must be (L, 8, H1, W1), got "
                         f"{tuple(sat_l.shape)}")
    if not sat_l.is_contiguous():
        raise ValueError("sat_l must be contiguous")
    if step < 1:
        raise ValueError(f"step must be >= 1, got {step}")
    L, _, H1, W1 = sat_l.shape
    dims = np.asarray(dims, np.int64).reshape(-1, 2)
    if dims.shape[0] != L:
        raise ValueError(f"dims has {dims.shape[0]} levels, sat_l has {L}")
    if (dims < 1).any():
        raise ValueError(f"every level needs ny, nx >= 1, got {dims}")
    ey, ex = tables.extent
    NY, NX = (int(v) for v in dims.max(axis=0))
    if (NY - 1) * step + ey >= H1 or (NX - 1) * step + ex >= W1:
        raise ValueError(
            f"window grid ({NY}, {NX}) at step {step} with corner extent "
            f"({ey}, {ex}) reads outside the ({H1}, {W1}) SAT")
    return dims


def valid_windows(dims: np.ndarray, NY: int, NX: int,
                  device: torch.device) -> torch.Tensor:
    """(L, NY, NX) bool on ``device``: the windows inside each level's
    grid."""
    d = to_device(dims, device)
    rows = torch.arange(NY, device=device)[None, :, None]
    cols = torch.arange(NX, device=device)[None, None, :]
    return (rows < d[:, 0, None, None]) & (cols < d[:, 1, None, None])


def _finish(vs: torch.Tensor, tables: CascadeTables, dims: np.ndarray):
    """Stage sums (L, S, NY, NX) -> (conf, passed) with the early exit's
    meaning: conf is the sum of the first failing stage, or of the last."""
    L, S, NY, NX = vs.shape
    th = to_device(tables.thresholds, vs.device)
    ok = (vs > th[None, :, None, None]).to(torch.int32)
    n_ok = torch.cumprod(ok, dim=1).sum(dim=1)             # stages in a row
    conf = vs.gather(1, n_ok.clamp(max=S - 1)[:, None]).squeeze(1)
    valid = valid_windows(dims, NY, NX, vs.device)
    passed = (n_ok == S) & valid
    return torch.where(valid, conf, torch.zeros_like(conf)), passed


def cascade_stage_sums_ref(sat_l: torch.Tensor, tables: CascadeTables,
                           step: int, dims) -> torch.Tensor:
    """Every stage's response sum for every window, (L, S, NY, NX) float32,
    with no early exit. Plain PyTorch in the kernel's op order."""
    dims = _check(sat_l, tables, step, dims)
    NY, NX = (int(v) for v in dims.max(axis=0))
    L = sat_l.shape[0]
    ylen, xlen = (NY - 1) * step + 1, (NX - 1) * step + 1

    def corner(oy: int, ox: int) -> torch.Tensor:      # (L, 8, NY, NX)
        return sat_l[:, :, oy:oy + ylen:step, ox:ox + xlen:step]

    w = to_device(tables.w.reshape(-1, 4, CHANNELS), sat_l.device)
    vs = sat_l.new_zeros((L, tables.n_stages, NY, NX))
    for s, (f0, f1) in enumerate(tables.stage_ranges):
        acc = None
        for f in range(f0, f1):
            vals = []
            for b in range(4):
                sy, sx, dy, dx = (int(v) for v in tables.boxes[f, b])
                vals.append(corner(sy, sx) - corner(sy, dx)
                            - corner(dy, sx) + corner(dy, dx))
            # squares summed over boxes, then over channels
            sq = vals[0] * vals[0]
            for v in vals[1:]:
                sq = sq + v * v
            inv = 1.0 / (torch.sqrt(sq.sum(dim=1, keepdim=True)) + 1e-6)
            sq2 = acc_w = None
            for b, v in enumerate(vals):
                u = torch.clamp(v * inv, -THETA, THETA)
                t = u * w[f, b][None, :, None, None]
                sq2 = u * u if sq2 is None else sq2 + u * u
                acc_w = t if acc_w is None else acc_w + t
            inv2 = 1.0 / (torch.sqrt(sq2.sum(dim=1)) + 1e-6)
            logit = acc_w.sum(dim=1) * inv2 + float(tables.bias[f])
            resp = torch.tanh(0.5 * logit)
            acc = resp if acc is None else acc + resp
        vs[:, s] = acc
    return vs


def cascade_eval_levels_ref(sat_l: torch.Tensor, tables: CascadeTables,
                            step: int, dims):
    """Plain PyTorch version of the kernel: (conf, passed), (L, NY, NX)."""
    vs = cascade_stage_sums_ref(sat_l, tables, step, dims)
    return _finish(vs, tables, np.asarray(dims, np.int64).reshape(-1, 2))


# FP32 operations of one feature at one window, counted off
# csrc/scd_feature.cuh's feature_response: 96 for the 32 box sums (3 each),
# 64 for the squares and their sums, 224 for the clipped normalisation and
# the dot (7 for each of 32 box-channel values), 16 for their sums over
# channels, 11 for the two norms (sqrt, add, division each), the logit, the
# tanh and the add to the stage sum: 411, each sqrt, division and tanh
# counted as one operation.
FEATURE_FLOP = 411


def io_bytes(sat_l: torch.Tensor, tables: CascadeTables, dims) -> int:
    """Bytes K1 and K3 must move: the SAT stack and the tables read once,
    conf (f32) and passed (u8) written once for every grid entry."""
    dims = np.asarray(dims, np.int64).reshape(-1, 2)
    NY, NX = (int(v) for v in dims.max(axis=0))
    tab = tables.n_features * 4 * (16 + 33) + tables.n_stages * 8
    return sat_l.numel() * 4 + tab + sat_l.shape[0] * NY * NX * 5


def cascade_work(sat_l: torch.Tensor, tables: CascadeTables, step: int,
                 dims, vs: Optional[torch.Tensor] = None
                 ) -> Tuple[int, int]:
    """(FP32 operations, bytes) that K1 needs on these inputs. A window
    evaluates every stage it reaches: stage 0, and each later stage while
    all the stages before it passed, read off the plain stage sums ``vs``
    (``cascade_stage_sums_ref``, computed when not given) against the
    thresholds; each feature of a reached stage costs FEATURE_FLOP."""
    dims = _check(sat_l, tables, step, dims)
    if vs is None:
        vs = cascade_stage_sums_ref(sat_l, tables, step, dims)
    L, S, NY, NX = vs.shape
    ok = (vs.cpu() > torch.from_numpy(tables.thresholds)[None, :, None, None])
    reached = torch.ones_like(ok)
    reached[:, 1:] = torch.cumprod(ok[:, :-1].to(torch.int32), dim=1).bool()
    counts = torch.tensor([f1 - f0 for f0, f1 in tables.stage_ranges])
    feats = (reached.to(torch.int64) * counts[None, :, None, None]).sum(1)
    n = int(feats[valid_windows(dims, NY, NX, feats.device)].sum())
    return n * FEATURE_FLOP, io_bytes(sat_l, tables, dims)


def phase_planes(sat_l: torch.Tensor, step: int, rows: Optional[int] = None,
                 cols: Optional[int] = None) -> torch.Tensor:
    """The (L, 8, H1, W1) SAT stack as (L, step*step, 8, rows, cols) phase
    planes: planes[l, py*step + px, c, h, w] = sat[l, c, h*step + py,
    w*step + px], zero past the SAT (ccv_tpu.detectors.scd._planes_cf per
    level, with hs_pad = rows, ws_pad = cols). rows and cols default to
    ceil(H1 / step) and ceil(W1 / step). One copy, or two where the planes
    reach past the SAT."""
    L, C, H1, W1 = sat_l.shape
    rows = -(-H1 // step) if rows is None else rows
    cols = -(-W1 // step) if cols is None else cols
    hp, wp = rows * step, cols * step
    if hp > H1 or wp > W1:
        sat_l = torch.nn.functional.pad(
            sat_l, (0, max(0, wp - W1), 0, max(0, hp - H1)))
    return (sat_l[:, :, :hp, :wp].reshape(L, C, rows, step, cols, step)
            .permute(0, 3, 5, 1, 2, 4).contiguous()
            .view(L, step * step, C, rows, cols))


def planes_extent(tables: Sequence[CascadeTables], step: int,
                  dims) -> Tuple[int, int]:
    """(rows, cols) of the phase planes that the windows of ``dims`` read
    under each of ``tables``: window (wy, wx) reads row wy + oy // step and
    column wx + ox // step for its corners (oy, ox)."""
    NY, NX = (int(v) for v in np.asarray(dims).reshape(-1, 2).max(axis=0))
    ey = max(t.extent[0] for t in tables)
    ex = max(t.extent[1] for t in tables)
    return NY + ey // step, NX + ex // step


def kernel_planes(sat_l: torch.Tensor, tables: CascadeTables, step: int,
                  dims, *more: CascadeTables) -> torch.Tensor:
    """The phase planes K1 or K3 reads for these windows: the rows and
    columns that the window grid's corners reach under ``tables`` and any
    ``more`` tables, so one copy serves a launch for each (no padding where
    the SAT covers them)."""
    return phase_planes(sat_l, step, *planes_extent((tables, *more), step,
                                                    dims))


def check_planes(planes: torch.Tensor, sat_l: torch.Tensor,
                 tables: CascadeTables, step: int, dims) -> None:
    """Raises ValueError unless ``planes`` can stand for ``sat_l``'s phase
    planes in a launch over the windows of ``dims`` with ``tables``: float32,
    contiguous, on sat_l's device, (L, step*step, 8, rows, cols) with at
    least the rows and columns the windows' corners reach. That they hold
    sat_l's values is the caller's word."""
    rows, cols = planes_extent((tables,), step, dims)
    want = (sat_l.shape[0], step * step, CHANNELS)
    if (planes.dtype != torch.float32 or planes.device != sat_l.device
            or not planes.is_contiguous() or planes.dim() != 5
            or tuple(planes.shape[:3]) != want or planes.shape[3] < rows
            or planes.shape[4] < cols):
        raise ValueError(
            f"planes {planes.dtype} {tuple(planes.shape)} on {planes.device} "
            f"are not contiguous float32 phase planes {want} + (>= {rows}, "
            f">= {cols}) on {sat_l.device}")


@functools.lru_cache(maxsize=256)
def _dims_on(device: str, shape: Tuple[int, ...], raw: bytes) -> torch.Tensor:
    arr = np.frombuffer(raw, np.int32).reshape(shape).copy()
    return to_device(arr, torch.device(device))


def dims_on(dims: np.ndarray, device: torch.device) -> torch.Tensor:
    """``dims`` as int32 on ``device``, copied there once per device and
    value, so a launch makes no host copy."""
    arr = np.ascontiguousarray(dims, np.int32)
    return _dims_on(str(device), arr.shape, arr.tobytes())


def _launch(fn, what: str, sat_l: torch.Tensor, planes: torch.Tensor,
            tables: CascadeTables, step: int, dims: np.ndarray):
    """(launch, conf, passed): ``launch()`` runs ``fn``, the C entry of K1
    or K3 (one interface), over ``planes`` on the current stream into the
    new (L, NY, NX) conf and passed, and raises if the launch fails."""
    dev = sat_l.device
    NY, NX = (int(v) for v in dims.max(axis=0))
    L, n_planes, _, hs, ws = planes.shape
    if n_planes * CHANNELS * hs * ws >= 2 ** 31:
        raise ValueError(f"a level's phase planes {tuple(planes.shape[1:])} "
                         f"are past the kernel's 32-bit offsets")
    tab = tables.on(dev)
    recs = tables.records_on(dev, step, hs, ws)
    conf = torch.empty((L, NY, NX), dtype=torch.float32, device=dev)
    passed = torch.empty((L, NY, NX), dtype=torch.uint8, device=dev)
    args = (sat_l.get_device(), planes.data_ptr(), L, n_planes, hs, ws,
            dims_on(dims, dev).data_ptr(), NY, NX,
            tab["stage_end"].data_ptr(), tab["thresholds"].data_ptr(),
            tables.n_stages, recs.data_ptr(), tables.n_features,
            tab["feats"].data_ptr(), conf.data_ptr(), passed.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)

    def launch():
        err = fn(*args)
        if err != 0:
            raise RuntimeError(f"{what} kernel launch failed: CUDA error "
                               f"{err}")
    return launch, conf, passed.view(torch.bool)


def _library() -> ctypes.CDLL:
    lib = _build.load_library("scd_cascade", ["scd_cascade.cu"],
                              layout_flags())
    fn = lib.scd_cascade_levels
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, i, i, i, i, p, i, i, p, p, i, p, i, p, p, p,
                       p]
        fn.restype = ctypes.c_int
    return lib


def build() -> None:
    """Compile (or find on disk) and load the kernel's library."""
    _library()


def cascade_eval_levels(sat_l: torch.Tensor, tables: CascadeTables,
                        step: int, dims: Sequence):
    """(conf, passed), each (L, NY, NX), for every window of every level.

    A CPU tensor goes through the plain PyTorch version; a CUDA tensor is
    made into phase planes (the rows and columns the windows read) and
    launches the CUDA kernel once for the whole stack, on the current
    stream, without synchronising."""
    global LAUNCHES
    dims = _check(sat_l, tables, step, dims)
    if sat_l.device.type == "cpu":
        return cascade_eval_levels_ref(sat_l, tables, step, dims)
    if sat_l.device.type != "cuda":
        raise ValueError(f"no cascade kernel for device {sat_l.device}")
    launch, conf, passed = _launch(
        _library().scd_cascade_levels, "scd_cascade", sat_l,
        kernel_planes(sat_l, tables, step, dims), tables, step, dims)
    launch()
    LAUNCHES += 1
    return conf, passed
