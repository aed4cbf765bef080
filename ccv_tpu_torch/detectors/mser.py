"""MSER: maximally stable extremal regions (counterpart of
ccv_tpu/detectors/mser.py; reference: lib/ccv_mser.c).

``mser_any`` is the ccv_mser dispatch (ccv_mser.c:852): a single-channel
integer image runs the set-union component-tree MSER (``mser``), a colour
or float image runs MSCR, the chi-distance colour variant (``mscr``).

Both trees are sequential sweeps over a union-find, so they run on the host
in C++ (``csrc/ccv_tpu_mser.cpp`` and ``csrc/ccv_tpu_mscr.cpp``, copies of
ccv_tpu's native sources, built with g++ into ``ccv_tpu_torch/_build`` at the
first call and bound with ctypes). MSCR's four chi-distance edge maps and
their Gaussian blur are computed on the image's device (``_chi_maps``) and
copied to the host once.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ccv_tpu_torch import _native_build
from ccv_tpu_torch.core.dense_matrix import as_array
from ccv_tpu_torch.ops import basic

DARK_TO_BRIGHT = 1
BRIGHT_TO_DARK = -1

_CAP = 8192  # keypoints the native calls return at most


@dataclasses.dataclass
class MserParams:
    """ccv_mser_param_t twin."""

    # MSER
    delta: int = 5
    min_area: int = 60
    max_area: int = 1 << 28
    max_variance: float = 0.25
    min_diversity: float = 0.2
    direction: int = DARK_TO_BRIGHT
    range: int = 255
    # MSCR (defaults of the msermatch tool, bin/msermatch.c:20-30)
    night: int = 0
    area_threshold: float = 1.01
    min_margin: float = 3e-3
    max_evolution: int = 200
    edge_blur_sigma: float = 1.0


@dataclasses.dataclass
class MserKeypoint:
    x: int
    y: int
    width: int
    height: int
    size: int
    keypoint: tuple


def _lib(name: str, argtypes) -> ctypes.CDLL:
    """lib<name> built from csrc/<name>.cpp, its entry point bound."""
    lib = _native_build.load_host_library(name, [f"{name}.cpp"])
    fn = getattr(lib, name)
    if not hasattr(fn, "_configured"):
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        fn._configured = True
    return lib


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.c_void_p)


def _keypoints(kp: np.ndarray, count: int) -> List[MserKeypoint]:
    return [MserKeypoint(x=int(rx), y=int(ry), width=int(rw), height=int(rh),
                         size=int(size), keypoint=(int(x), int(y)))
            for size, x, y, rx, ry, rw, rh, _ in kp[:min(count, _CAP)]]


def _host_u8(a) -> np.ndarray:
    if not isinstance(a, np.ndarray):
        a = as_array(a, "cpu").numpy()
    return np.ascontiguousarray(a, np.uint8)


def mser(a, h=None, params: Optional[MserParams] = None
         ) -> Tuple[List[MserKeypoint], np.ndarray]:
    """ccv_mser twin for a single-channel 8U image (the set-union path),
    optionally masked by ``h``.

    Returns (keypoints, label map (H, W) int32): 1-based region ids on the
    pixels of stable regions, the first writer winning, as the reference's
    ``b`` output."""
    params = params or MserParams()
    img = _host_u8(a)
    if img.ndim == 3:
        img = np.ascontiguousarray(img[..., 0])
    if img.ndim != 2:
        raise ValueError(f"mser needs an (H, W) image, got {img.shape}")
    if h is not None:
        h = _host_u8(h)
        if h.shape != img.shape:
            raise ValueError(f"mask {h.shape} is not the image's "
                             f"{img.shape}")
    rows, cols = img.shape
    lib = _lib("ccv_tpu_mser", [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.c_double, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int])
    labels = np.zeros((rows, cols), np.int32)
    kp = np.zeros((_CAP, 8), np.int32)
    count = lib.ccv_tpu_mser(
        _ptr(img), rows, cols, _ptr(h) if h is not None else None,
        params.delta, params.min_area, params.max_area,
        params.max_variance, params.min_diversity,
        params.direction, params.range, _ptr(labels), _ptr(kp), _CAP)
    return _keypoints(kp, count), labels


# ---------------------------------------------------------------------------
# MSCR, the colour / float variant (_ccv_mscr, lib/ccv_mser.c:570)
# ---------------------------------------------------------------------------

def _chi_maps(x: torch.Tensor, sigma: float) -> List[np.ndarray]:
    """The chi-distance edge maps in 4 directions, Gaussian-blurred
    (_ccv_mscr_chi, ccv_mser.c:449), on ``x``'s device; one copy of all four
    to the host."""
    x = x.to(torch.float32)
    if x.dim() == 2:
        x = x[..., None]

    def chi(p, q, diag):
        v = torch.sum((q - p) ** 2 / (p + q + 1e-10), dim=-1)
        return basic.sqrt32(v * 0.5 if diag else v)

    maps = [chi(x[:, :-1], x[:, 1:], False), chi(x[:-1, :], x[1:, :], False),
            chi(x[:-1, :-1], x[1:, 1:], True),
            chi(x[:-1, 1:], x[1:, :-1], True)]
    blurred = [basic.blur(m, sigma, out_float=True) for m in maps]
    flat = torch.cat([m.reshape(-1) for m in blurred]).cpu().numpy()
    out, start = [], 0
    for m in blurred:
        n = m.numel()
        out.append(np.ascontiguousarray(flat[start:start + n].reshape(
            m.shape)))
        start += n
    return out


def _chitab3(size: int = 400) -> np.ndarray:
    """The chi-square threshold schedule: chi2inv(i / (size - 1), 3) / 3 with
    the last entry clamped (the closed form behind the reference's constant
    table, ccv_mser.c:348)."""
    from scipy import stats

    tab = stats.chi2.ppf(np.arange(size) / (size - 1), 3) / 3.0
    tab[-1] = 133.333
    return tab.astype(np.float64)


def mscr(a, params: Optional[MserParams] = None, device=None
         ) -> Tuple[List[MserKeypoint], np.ndarray]:
    """_ccv_mscr twin for a colour or float image: chi-distance edge
    evolution under the chi-square schedule, stable areas by margin. The
    chi maps are made on ``a``'s device (a numpy image goes to ``device``,
    default the card)."""
    params = params or MserParams()
    x = as_array(a, device)
    rows, cols = x.shape[0], x.shape[1]
    bdx, bdy, bdxy, bdxy2 = _chi_maps(x, params.edge_blur_sigma)
    tab = _chitab3()
    lib = _lib("ccv_tpu_mscr", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.c_double,
        ctypes.c_int, ctypes.c_int, ctypes.c_double,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int])
    labels = np.zeros((rows, cols), np.int32)
    kp = np.zeros((_CAP, 8), np.int32)
    count = lib.ccv_tpu_mscr(
        _ptr(bdx), _ptr(bdy), _ptr(bdxy), _ptr(bdxy2), rows, cols,
        _ptr(tab), len(tab), params.max_evolution, params.area_threshold,
        params.min_margin, params.min_area, params.max_area,
        params.min_diversity, _ptr(labels), _ptr(kp), _CAP)
    return _keypoints(kp, count), labels


def mser_any(a, h=None, params: Optional[MserParams] = None, device=None):
    """ccv_mser dispatch twin (ccv_mser.c:852): a multi-channel or float
    image runs MSCR, a single-channel integer one the set-union MSER."""
    dtype = a.dtype if isinstance(a, torch.Tensor) else np.asarray(a).dtype
    shape = tuple(a.shape)
    floating = (dtype.is_floating_point if isinstance(dtype, torch.dtype)
                else np.issubdtype(dtype, np.floating))
    if (len(shape) == 3 and shape[-1] > 1) or floating:
        return mscr(a, params, device)
    return mser(a, h=h, params=params)
