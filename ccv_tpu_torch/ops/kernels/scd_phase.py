"""Kernel K3: the leading stages of the SCD cascade (phase A) over every
window of an octave, with no early exit.

Counterpart of ccv_tpu/ops/pallas/scd_phase.py (``_get_phase_a_call``,
entry ``phase_a``), which the staged cascade of detectors/scd.py runs as its
phase A. Three pieces:

- ``phase_tables``: the tables of a run of stages (their features, boxes,
  weights, biases and thresholds) as a ``scd_cascade.CascadeTables``;
- ``phase_a_ref``: the plain PyTorch version, K1's stage sums
  (``scd_cascade.cascade_stage_sums_ref``, the kernel's op order) reduced
  to phase A's outputs;
- ``phase_a``: the wrapper. On a CPU tensor it runs the plain version; on a
  CUDA tensor it launches the hand-written kernel (csrc/scd_phase.cu) or
  raises. ``LAUNCHES`` counts its launches.

Input is K1's: the channels-first SAT stack of one octave ``(L, 8, H1,
W1)``, read at stride ``step``, and each level's ``(ny, nx)`` grid. The TPU
kernel's phase planes (``_phase_planes``, ``_planes_cf``), its corner
slices (``_grid_corner_slices(_T)``) and its tile selector were lane
layouts for the TPU and have no counterpart here. Outputs, ``(L, NY, NX)``:
``conf``, the LAST phase-A stage's sum for every window (K1's conf is the
sum of the first failing stage), 0 outside a level's grid; ``passed``, the
AND of ``sum > threshold`` over the phase's stages, false outside the grid.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np
import torch

from ccv_tpu_torch.device import to_device
from ccv_tpu_torch.ops.kernels import _build
from ccv_tpu_torch.ops.kernels import scd_cascade
from ccv_tpu_torch.ops.kernels.scd_cascade import CascadeTables

# kernel launches made by phase_a (CUDA tensors only)
LAUNCHES = 0

# the kernel stages the whole phase in shared memory: 16 ints + 33 floats
# per feature, 8 bytes per stage, within the 227 KB a block may have
MAX_FEATURES = 1024


def phase_tables(thresholds, sx, sy, dx, dy, bias, w, stage_of, s0: int,
                 s1: int) -> CascadeTables:
    """Tables of stages ``s0 .. s1-1`` (ScdClassifierCascade fields).

    The phase's features must be one contiguous run of the cascade and each
    stage's features a contiguous run within it; raises ValueError
    otherwise."""
    stage_of = np.asarray(stage_of)
    if not 0 <= s0 < s1 <= len(thresholds):
        raise ValueError(f"stages {s0}..{s1} are not a run of the cascade's "
                         f"{len(thresholds)}")
    feats = np.nonzero((stage_of >= s0) & (stage_of < s1))[0]
    if len(feats) == 0 or feats[-1] - feats[0] + 1 != len(feats):
        raise ValueError(f"stages {s0}..{s1}: features are not one "
                         f"contiguous run of the cascade")
    return scd_cascade.build_tables(
        np.asarray(thresholds)[s0:s1], np.asarray(sx)[feats],
        np.asarray(sy)[feats], np.asarray(dx)[feats], np.asarray(dy)[feats],
        np.asarray(bias)[feats], np.asarray(w)[feats], stage_of[feats] - s0)


def phase_a_ref(sat_l: torch.Tensor, tables: CascadeTables, step: int,
                dims):
    """Plain PyTorch version of the kernel: (conf, passed), (L, NY, NX)."""
    vs = scd_cascade.cascade_stage_sums_ref(sat_l, tables, step, dims)
    L, _S, NY, NX = vs.shape
    valid = scd_cascade.valid_windows(
        np.asarray(dims, np.int64).reshape(-1, 2), NY, NX, vs.device)
    th = to_device(tables.thresholds, vs.device)
    passed = (vs > th[None, :, None, None]).all(dim=1) & valid
    conf = torch.where(valid, vs[:, -1], torch.zeros_like(vs[:, -1]))
    return conf, passed


def phase_a_work(sat_l: torch.Tensor, tables: CascadeTables, step: int,
                 dims) -> Tuple[int, int]:
    """(FP32 operations, bytes) that K3 needs on these inputs: every window
    of every level's grid evaluates every feature of the phase (no early
    exit), scd_cascade.FEATURE_FLOP each."""
    dims = scd_cascade._check(sat_l, tables, step, dims)
    windows = int((dims[:, 0] * dims[:, 1]).sum())
    return (windows * tables.n_features * scd_cascade.FEATURE_FLOP,
            scd_cascade.io_bytes(sat_l, tables, dims))


def _library() -> ctypes.CDLL:
    lib = _build.load_library("scd_phase", ["scd_phase.cu"])
    fn = lib.scd_phase_a_levels
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, i, i, i, p, i, i, p, p, i, p, p, i, i, p, p, p]
        fn.restype = ctypes.c_int
    return lib


def build() -> None:
    """Compile (or find on disk) and load the kernel's library."""
    _library()


def phase_a(sat_l: torch.Tensor, tables: CascadeTables, step: int,
            dims: Sequence):
    """(conf, passed), each (L, NY, NX), for every window of every level.

    A CPU tensor goes through the plain PyTorch version; a CUDA tensor
    launches the CUDA kernel once for the whole stack, on the current
    stream, without synchronising."""
    global LAUNCHES
    dims = scd_cascade._check(sat_l, tables, step, dims)
    if sat_l.device.type == "cpu":
        return phase_a_ref(sat_l, tables, step, dims)
    if sat_l.device.type != "cuda":
        raise ValueError(f"no phase-A kernel for device {sat_l.device}")
    if tables.n_features > MAX_FEATURES:
        raise ValueError(f"phase A has {tables.n_features} features; the "
                         f"kernel takes at most {MAX_FEATURES}")
    fn = _library().scd_phase_a_levels
    dev = sat_l.device
    L, _, H1, W1 = sat_l.shape
    NY, NX = (int(v) for v in dims.max(axis=0))
    tab = tables.on(dev)
    dims_d = to_device(dims.astype(np.int32), dev)
    conf = torch.empty((L, NY, NX), dtype=torch.float32, device=dev)
    passed = torch.empty((L, NY, NX), dtype=torch.uint8, device=dev)
    err = fn(sat_l.get_device(), sat_l.data_ptr(), L, H1, W1,
             dims_d.data_ptr(), NY, NX, tab["stage_end"].data_ptr(),
             tab["thresholds"].data_ptr(), tables.n_stages,
             tab["boxes"].data_ptr(), tab["feats"].data_ptr(),
             tables.n_features, step, conf.data_ptr(), passed.data_ptr(),
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"scd_phase kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    return conf, passed.view(torch.bool)
