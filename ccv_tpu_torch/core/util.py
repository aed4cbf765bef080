"""Matrix utilities (counterpart of ccv_tpu/core/util.py; reference:
lib/ccv_util.c).

``slice_`` / ``border`` / ``shift`` / ``flatten`` / ``any_nan`` /
``visualize`` / ``zero`` as torch ops on an explicit device, and the
sparse-matrix twin as host Python, as in ``ccv_tpu``: ``SparseMatrix``
(ccv_sparse_matrix_t, lib/ccv.h:104-145: row or column major, typed
multi-channel cells, get / set / vector access, FOREACH-style iteration),
``CompressedSparseMatrix`` (CSR / CSC) and ``compress_symmetric``.

The device bridge keeps ``ccv_tpu``'s names, ``sparse_to_bcoo`` and
``bcoo_to_sparse``, so that a reader finds the counterpart, but the device
form is a torch sparse COO tensor (``torch.sparse_coo_tensor``) on an
explicit device, not JAX's BCOO.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from ccv_tpu_torch import device as _device


def slice_(a: torch.Tensor, y: int, x: int, rows: int, cols: int
           ) -> torch.Tensor:
    """ccv_slice twin: crop with zero padding for out-of-bound regions."""
    H, W = a.shape[0], a.shape[1]
    out = torch.zeros((rows, cols) + tuple(a.shape[2:]), dtype=a.dtype,
                      device=a.device)
    sy0, sx0 = max(y, 0), max(x, 0)
    sy1, sx1 = min(y + rows, H), min(x + cols, W)
    if sy1 > sy0 and sx1 > sx0:
        out[sy0 - y:sy1 - y, sx0 - x:sx1 - x] = a[sy0:sy1, sx0:sx1]
    return out


def border(a: torch.Tensor, margin: Tuple[int, int, int, int]
           ) -> torch.Tensor:
    """ccv_border twin: zero-pad by (left, top, right, bottom)."""
    left, top, right, bottom = margin
    out = torch.zeros((a.shape[0] + top + bottom, a.shape[1] + left + right)
                      + tuple(a.shape[2:]), dtype=a.dtype, device=a.device)
    out[top:top + a.shape[0], left:left + a.shape[1]] = a
    return out


def shift(a: torch.Tensor, lshift: int = 0) -> torch.Tensor:
    """ccv_shift twin: to int32 with a left (``lshift`` >= 0) or
    arithmetic right shift."""
    x = a.to(torch.int32)
    return x << lshift if lshift >= 0 else x >> (-lshift)


def flatten(a: torch.Tensor) -> torch.Tensor:
    """ccv_flatten twin: sum over channels to one int32 channel."""
    if a.dim() == 2:
        return a.to(torch.int32)
    return a.to(torch.int32).sum(-1, dtype=torch.int32)


def any_nan(a: torch.Tensor) -> bool:
    """ccv_any_nan twin."""
    return bool(torch.isnan(a.to(torch.float32)).any())


def visualize(a: torch.Tensor) -> torch.Tensor:
    """ccv_visualize twin: stretch any matrix to a viewable uint8 image."""
    x = a.to(torch.float32)
    lo, hi = x.min(), x.max()
    out = (x - lo) / torch.clamp(hi - lo, min=1e-12) * 255.0
    return torch.round(out).clamp(0, 255).to(torch.uint8)


def zero(shape, dtype: torch.dtype = torch.float32,
         device: _device.DeviceLike = None) -> torch.Tensor:
    """A zero matrix on ``device`` (default: the card)."""
    return torch.zeros(shape, dtype=dtype, device=_device.resolve(device))


SPARSE_ROW_MAJOR = 0  # CCV_SPARSE_ROW_MAJOR (lib/ccv.h:120)
SPARSE_COL_MAJOR = 1  # CCV_SPARSE_COL_MAJOR


class SparseMatrix:
    """ccv_sparse_matrix_t twin (lib/ccv.h:125-144, lib/ccv_util.c).

    Cells are keyed (row, col); internally a per-major-axis vector index
    (dict-of-dicts) mirrors the reference's vector-hash layout so
    ``vector(i)`` / ``vector_foreach`` are O(vector) like
    ``ccv_get_sparse_matrix_vector`` (lib/ccv.h:763). ``dtype`` and
    ``channels`` play the role of the CCV type tag; multi-channel cells
    are stored as length-``channels`` numpy arrays.
    """

    def __init__(self, rows: int, cols: int, dtype=np.float32,
                 channels: int = 1, major: int = SPARSE_ROW_MAJOR):
        self.rows = rows
        self.cols = cols
        self.dtype = np.dtype(dtype)
        self.channels = channels
        self.major = major
        self.data: Dict[Tuple[int, int], object] = {}
        self._vec: Dict[int, Dict[int, object]] = {}

    # -- cell access (ccv_set/get_sparse_matrix_cell, lib/ccv.h:777-793) --
    def _coerce(self, value):
        if self.channels == 1:
            return self.dtype.type(value)
        v = np.asarray(value, self.dtype)
        if v.shape != (self.channels,):
            raise ValueError(f"a cell of {self.channels} channels, got "
                             f"shape {v.shape}")
        return v

    def set(self, i: int, j: int, value):
        if not (0 <= i < self.rows and 0 <= j < self.cols):
            raise IndexError(f"cell ({i}, {j}) outside {self.rows} x "
                             f"{self.cols}")
        value = self._coerce(value)
        self.data[(i, j)] = value
        mi, mj = (j, i) if self.major == SPARSE_COL_MAJOR else (i, j)
        self._vec.setdefault(mi, {})[mj] = value

    def get(self, i: int, j: int, default=0.0):
        return self.data.get((i, j), default)

    def __contains__(self, ij) -> bool:
        return tuple(ij) in self.data

    @property
    def rnum(self) -> int:
        """Number of assigned cells (the reference's mat->rnum)."""
        return len(self.data)

    # -- vector access (ccv_get_sparse_matrix_vector) ----------------------
    def vector(self, index: int) -> Dict[int, object]:
        """All assigned cells of one major-axis vector: {minor: value}.
        Empty dict when nothing was assigned (the reference returns a
        vector with size 0)."""
        return dict(self._vec.get(index, {}))

    def vector_foreach(self, index: int):
        """CCV_SPARSE_VECTOR_FOREACH twin: (minor_index, value) pairs."""
        return iter(sorted(self._vec.get(index, {}).items()))

    def foreach(self):
        """CCV_SPARSE_FOREACH twin: ((row, col), value) in major order."""
        if self.major == SPARSE_COL_MAJOR:
            return iter(sorted(self.data.items(),
                               key=lambda kv: (kv[0][1], kv[0][0])))
        return iter(sorted(self.data.items()))

    # -- dense bridges ------------------------------------------------------
    def to_dense(self) -> np.ndarray:
        shape = ((self.rows, self.cols) if self.channels == 1
                 else (self.rows, self.cols, self.channels))
        out = np.zeros(shape, self.dtype)
        for (i, j), v in self.data.items():
            out[i, j] = v
        return out

    @classmethod
    def from_dense(cls, arr, major: int = SPARSE_ROW_MAJOR) -> "SparseMatrix":
        arr = np.asarray(arr)
        channels = arr.shape[2] if arr.ndim == 3 else 1
        sm = cls(arr.shape[0], arr.shape[1], dtype=arr.dtype,
                 channels=channels, major=major)
        nz = np.nonzero(arr if arr.ndim == 2 else arr.any(axis=2))
        for i, j in zip(*nz):
            sm.set(int(i), int(j), arr[i, j])
        return sm

    # -- CSR compression (ccv_compress_sparse_matrix, ccv.h:799) -----------
    def compress(self) -> "CompressedSparseMatrix":
        """CSR for row-major, CSC for column-major (the reference
        compresses along the major axis)."""
        n_major = self.cols if self.major == SPARSE_COL_MAJOR else self.rows
        index, values = [], []
        offset = [0]
        for mi in range(n_major):
            for mj, v in sorted(self._vec.get(mi, {}).items()):
                index.append(mj)
                values.append(v)
            offset.append(len(index))
        data = (np.asarray(values, self.dtype) if self.channels == 1
                else (np.stack(values).astype(self.dtype) if values
                      else np.zeros((0, self.channels), self.dtype)))
        return CompressedSparseMatrix(
            nnz=len(index), rows=self.rows, cols=self.cols,
            major=self.major, channels=self.channels,
            index=np.asarray(index, np.int32),
            offset=np.asarray(offset, np.int32), data=data)


@dataclasses.dataclass
class CompressedSparseMatrix:
    """ccv_compressed_sparse_matrix_t twin (lib/ccv.h:244-255): CSR/CSC
    arrays — per-cell minor `index`, per-vector `offset` (length
    n_major + 1), `data`."""

    nnz: int
    rows: int
    cols: int
    major: int
    channels: int
    index: np.ndarray
    offset: np.ndarray
    data: np.ndarray

    def decompress(self) -> SparseMatrix:
        """ccv_decompress_sparse_matrix twin (lib/ccv.h:805)."""
        sm = SparseMatrix(self.rows, self.cols, dtype=self.data.dtype,
                          channels=self.channels, major=self.major)
        for mi in range(len(self.offset) - 1):
            for p in range(self.offset[mi], self.offset[mi + 1]):
                mj = int(self.index[p])
                i, j = ((mj, mi) if self.major == SPARSE_COL_MAJOR
                        else (mi, mj))
                sm.set(i, j, self.data[p])
        return sm


def compress_symmetric(sm: SparseMatrix) -> SparseMatrix:
    """Lower-triangle fold for symmetric relations (the reference keeps
    symmetric interference edges once)."""
    out = SparseMatrix(sm.rows, sm.cols, dtype=sm.dtype,
                       channels=sm.channels, major=sm.major)
    for (i, j), v in sm.data.items():
        if i >= j:
            out.set(i, j, v)
    return out


# ---------------------------------------------------------------------------
# the device bridge: torch sparse COO (ccv_tpu's names, not JAX's BCOO)
# ---------------------------------------------------------------------------

def sparse_to_bcoo(sp: SparseMatrix, device: _device.DeviceLike = None
                   ) -> torch.Tensor:
    """SparseMatrix -> a coalesced float32 torch sparse COO tensor on
    ``device`` (default: the card), for products with dense operands
    (``torch.sparse.mm``). Single-channel only."""
    if sp.channels != 1:
        raise ValueError("the sparse COO bridge is single-channel")
    items = sorted(sp.data.items())
    idx = np.array([ij for ij, _ in items], np.int64).reshape(-1, 2).T
    val = np.array([v for _, v in items], np.float32)
    dev = _device.resolve(device)
    return torch.sparse_coo_tensor(
        torch.from_numpy(idx), torch.from_numpy(val),
        (sp.rows, sp.cols), check_invariants=True).coalesce().to(dev)


def bcoo_to_sparse(mat: torch.Tensor) -> SparseMatrix:
    """A torch sparse COO tensor -> SparseMatrix (host); explicit zeros
    are dropped."""
    mat = mat.coalesce().cpu()
    sp = SparseMatrix(int(mat.shape[0]), int(mat.shape[1]))
    for (i, j), v in zip(mat.indices().T.tolist(), mat.values().tolist()):
        if v != 0:
            sp.set(int(i), int(j), v)
    return sp
