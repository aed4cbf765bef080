"""Kernel K3: a run of stages of the SCD cascade over every window of an
octave, with no early exit: the staged cascade's phase A and its phase B1.

Counterpart of ccv_tpu/ops/pallas/scd_phase.py (``_get_phase_a_call``,
entry ``phase_a``), which the staged cascade of detectors/scd.py runs as its
phase A; ccv_tpu's dense phase B1 is the same computation on the next block
of stages (ccv_tpu/detectors/scd.py ``_eval_level``), and the port runs it
through the same kernel. Four pieces:

- ``phase_tables``: the tables of a run of stages (their features, boxes,
  weights, biases and thresholds) as a ``scd_cascade.CascadeTables``;
- ``phase_a_ref``: the plain PyTorch version, K1's stage sums
  (``scd_cascade.cascade_stage_sums_ref``, the kernel's op order) reduced
  to the phase's outputs;
- ``launcher``: K3's launch over given inputs on the card, for the wrapper
  and for timing the kernel alone;
- ``phase_a``: the wrapper. On a CPU tensor it runs the plain version; on a
  CUDA tensor it launches the hand-written kernel (csrc/scd_phase.cu) or
  raises. ``LAUNCHES`` counts its launches.

Input is K1's: the channels-first SAT stack of one octave ``(L, 8, H1,
W1)``, read at stride ``step``, and each level's ``(ny, nx)`` grid. The
kernel reads the SAT as K1 does, as step x step phase planes (ccv_tpu's
``_phase_planes`` / ``_planes_cf``, ``scd_cascade.kernel_planes``) through
each feature's distinct corners; a caller running several phases over the
same SAT makes the planes once, for the largest corner extent, and passes
them as ``planes``. Outputs, ``(L, NY, NX)``: ``conf``, the LAST stage's
sum for every window (K1's conf is the sum of the first failing stage), 0
outside a level's grid; ``passed``, the AND of ``sum > threshold`` over the
phase's stages, false outside the grid.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ccv_tpu_torch.device import to_device
from ccv_tpu_torch.ops.kernels import _build
from ccv_tpu_torch.ops.kernels import scd_cascade
from ccv_tpu_torch.ops.kernels.scd_cascade import CascadeTables

# kernel launches made by phase_a and launcher (CUDA tensors only)
LAUNCHES = 0


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
                dims, planes: Optional[torch.Tensor] = None):
    """Plain PyTorch version of the kernel: (conf, passed), (L, NY, NX).
    Reads ``sat_l`` itself; ``planes`` is taken, and ignored, so that it
    has ``phase_a``'s signature."""
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
    lib = _build.load_library("scd_phase", ["scd_phase.cu"],
                              scd_cascade.layout_flags())
    fn = lib.scd_phase_a_levels
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, i, i, i, i, p, i, i, p, p, i, p, i, p, p, p,
                       p]
        fn.restype = ctypes.c_int
    return lib


def build() -> None:
    """Compile (or find on disk) and load the kernel's library."""
    _library()


def launcher(sat_l: torch.Tensor, tables: CascadeTables, step: int,
             dims: Sequence, planes: Optional[torch.Tensor] = None):
    """(launch, conf, passed) for a CUDA ``sat_l``: ``launch()`` runs K3
    once over ``planes`` (made here when not given) into the (L, NY, NX)
    conf and passed, on the current stream, without synchronising, and adds
    one to LAUNCHES. Every input is on the card before the first call, so a
    run of calls times the kernel alone."""
    dims = scd_cascade._check(sat_l, tables, step, dims)
    if sat_l.device.type != "cuda":
        raise ValueError(f"no phase kernel for device {sat_l.device}")
    if planes is None:
        planes = scd_cascade.kernel_planes(sat_l, tables, step, dims)
    else:
        scd_cascade.check_planes(planes, sat_l, tables, step, dims)
    run, conf, passed = scd_cascade._launch(
        _library().scd_phase_a_levels, "scd_phase", sat_l, planes, tables,
        step, dims)

    def launch():
        global LAUNCHES
        run()
        LAUNCHES += 1
    return launch, conf, passed


def phase_a(sat_l: torch.Tensor, tables: CascadeTables, step: int,
            dims: Sequence, planes: Optional[torch.Tensor] = None):
    """(conf, passed), each (L, NY, NX), for every window of every level.

    A CPU tensor goes through the plain PyTorch version; a CUDA tensor
    launches the CUDA kernel once for the whole stack, on the current
    stream, without synchronising. ``planes``: ``sat_l``'s phase planes
    covering at least ``tables``' corner extent
    (``scd_cascade.kernel_planes``), made once by a caller that runs several
    phases over the same SAT; checked on either device (ValueError), made
    here when not given."""
    if sat_l.device.type == "cpu":
        dims = scd_cascade._check(sat_l, tables, step, dims)
        if planes is not None:
            scd_cascade.check_planes(planes, sat_l, tables, step, dims)
        return phase_a_ref(sat_l, tables, step, dims)
    launch, conf, passed = launcher(sat_l, tables, step, dims, planes)
    launch()
    return conf, passed
