"""Numerical methods (counterpart of ccv_tpu/core/numeric.py; reference:
lib/ccv_numeric.c).

- ``filter``: frequency-domain convolution (``torch.fft.rfft2`` /
  ``irfft2``; KissFFT in the reference);
- ``distance_transform``: the generalized squared distance transform as
  two brute-force 1-D minimisations, O(n^2) a row as ``ccv_tpu`` computes
  it, with rows taken in chunks so that no cost cube passes
  ``DT_CHUNK_BYTES``;
- ``kmeans1d``: optimal 1-D k-means (host numpy, ``ccv_tpu``'s copy);
- ``minimize``: Polak-Ribiere conjugate gradient with the reference's
  line-search constants (ccv_minimize), on tensors;
- ``invert``, ``solve``, ``eigen`` through ``torch.linalg`` in float32.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from ccv_tpu_torch import device as _device

DT_CHUNK_BYTES = 1 << 29  # largest (rows, n, n) float32 cost cube at once


def _tensor(a, like=None) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32)
    dev = like.device if like is not None else _device.default_device()
    return torch.from_numpy(np.asarray(a, np.float32)).to(dev)


# ---------------------------------------------------------------------------
# frequency-domain convolution
# ---------------------------------------------------------------------------

def filter(a: torch.Tensor, b, mode: str = "same") -> torch.Tensor:
    """ccv_filter twin: 2-D convolution of image ``a`` with kernel ``b``
    by FFT, zero-padded to the full size; the output is the 'same'
    window, the kernel centred at (kh // 2, kw // 2)."""
    a = _tensor(a)
    b = _tensor(b, a)
    H, W = a.shape[-2], a.shape[-1]
    kh, kw = b.shape[-2], b.shape[-1]
    size = (H + kh - 1, W + kw - 1)
    full = torch.fft.irfft2(torch.fft.rfft2(a, size) * torch.fft.rfft2(b, size),
                            size)
    y0, x0 = kh // 2, kw // 2
    return full[..., y0:y0 + H, x0:x0 + W]


# ---------------------------------------------------------------------------
# generalized distance transform (Felzenszwalb & Huttenlocher)
# ---------------------------------------------------------------------------

def _dt1d(f: torch.Tensor, mult: float, shift: float):
    """min_q f[q] + mult*(p-q)^2 + shift*(p-q) along the last axis of an
    (R, n) tensor: (values, argmins), the first minimum on ties. The sum
    rounds in ccv_tpu's order, (f + mult*d*d) + shift*d."""
    n = f.shape[-1]
    p = torch.arange(n, dtype=torch.float32, device=f.device)
    d = p[:, None] - p[None, :]                     # (p, q)
    quad = mult * d * d
    lin = shift * d
    rows = max(1, DT_CHUNK_BYTES // (4 * n * n))
    vals, idxs = [], []
    for r0 in range(0, f.shape[0], rows):
        cost = f[r0:r0 + rows, None, :] + quad + lin
        idx = torch.argmin(cost, dim=-1)
        vals.append(torch.gather(cost, -1, idx[..., None])[..., 0])
        idxs.append(idx)
    return torch.cat(vals), torch.cat(idxs)


def distance_transform(a: torch.Tensor, dx: float = 0.0, dy: float = 0.0,
                       dxx: float = 1.0, dyy: float = 1.0):
    """ccv_distance_transform twin on an (H, W) plane: rows, then columns;
    returns (values float32, x offsets, y offsets) (int64)."""
    a = _tensor(a)
    rowv, rowi = _dt1d(a, dxx, dx)
    colv, coli = _dt1d(rowv.T.contiguous(), dyy, dy)
    ybest = coli.T
    return colv.T, torch.gather(rowi, 0, ybest), ybest


# ---------------------------------------------------------------------------
# optimal 1-D k-means (host / numpy)
# ---------------------------------------------------------------------------

def kmeans1d(values: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """ccv_kmeans1d twin: optimal clustering of sorted 1-D data.

    Returns (clusters[n] int32, centroids[k] float64). Divide-and-conquer
    over the totally-monotone argmin matrix — same optimum as the
    reference's SMAWK.
    """
    v = np.asarray(values, np.float64).reshape(-1)
    n = v.size
    order = np.argsort(v, kind="stable")
    s = v[order]
    cs = np.concatenate([[0.0], np.cumsum(s)])
    cs2 = np.concatenate([[0.0], np.cumsum(s * s)])

    def cost(j, i):  # cluster [j..i] inclusive
        if j > i:
            return 0.0
        mu = (cs[i + 1] - cs[j]) / (i - j + 1)
        return cs2[i + 1] - cs2[j] - (i - j + 1) * mu * mu

    D_prev = np.array([cost(0, i) for i in range(n)])
    T = np.zeros((k, n), np.int32)

    for k_ in range(1, k):
        D_next = np.empty(n)
        Tk = T[k_]

        def solve(ilo, ihi, jlo, jhi):
            if ilo > ihi:
                return
            mid = (ilo + ihi) // 2
            best, bestj = np.inf, jlo
            for j in range(jlo, min(jhi, mid) + 1):
                c = (D_prev[j - 1] if j > 0 else 0.0) + cost(j, mid)
                if c < best:
                    best, bestj = c, j
            D_next[mid] = best
            Tk[mid] = bestj
            solve(ilo, mid - 1, jlo, bestj)
            solve(mid + 1, ihi, bestj, jhi)

        import sys
        old = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old, 2 * n + 100))
        solve(0, n - 1, 0, n - 1)
        sys.setrecursionlimit(old)
        D_prev = D_next

    # backtrack
    clusters_sorted = np.zeros(n, np.int32)
    centroids = np.zeros(k)
    t = n
    for k_ in range(k - 1, -1, -1):
        t_new = T[k_, t - 1] if k_ > 0 else 0
        seg = s[t_new:t]
        clusters_sorted[t_new:t] = k_
        centroids[k_] = seg.mean() if seg.size else 0.0
        t = t_new
        if t == 0:
            break
    clusters = np.zeros(n, np.int32)
    clusters[order] = clusters_sorted
    return clusters, centroids


# ---------------------------------------------------------------------------
# conjugate-gradient minimize
# ---------------------------------------------------------------------------

def minimize(fn: Callable, x0, max_iter: int = 100, red: float = 1.0):
    """ccv_minimize twin: Polak-Ribiere conjugate gradient with
    minimize.m's line search (cubic extrapolation, then quadratic or cubic
    interpolation, the Wolfe-Powell conditions with SIG and RHO), as the
    reference's lib/ccv_numeric.c runs it. ``fn(x) -> (value, gradient)``
    on float32 tensors; the line search's scalars are Python floats.
    ``max_iter`` line searches at most. Returns (x, value).

    ccv_tpu's ``minimize`` leaves out the interpolation and does not
    evaluate ``fn`` again between extrapolations, so it can loop forever
    (it does on Rosenbrock from (-1.2, 1)); this follows the reference."""
    INT, EXT, MAX, RATIO, SIG = 0.1, 3.0, 20, 10.0, 0.1
    RHO = SIG / 2

    def vdot(u, v):
        return float(torch.dot(u.reshape(-1), v.reshape(-1)))

    def call(x):
        f, df = fn(x)
        return float(f), df

    x = _tensor(x0)
    f0, df0 = call(x)
    s = -df0
    d0 = -vdot(s, s)
    x3 = red / (1.0 - d0)
    ls_failed = False
    for _ in range(max_iter):
        X0, F0, dF0 = x, f0, df0
        M = MAX
        while True:  # extrapolate as long as necessary
            x2, f2, d2, f3, df3 = 0.0, f0, d0, f0, df0
            success = False
            while not success and M > 0:
                M -= 1
                f3, df3 = call(x + x3 * s)
                if np.isfinite(f3) and bool(torch.isfinite(df3).all()):
                    success = True
                else:
                    x3 = (x2 + x3) / 2
            if f3 < F0:
                X0, F0, dF0 = x + x3 * s, f3, df3
            d3 = vdot(df3, s)
            if d3 > SIG * d0 or f3 > f0 + x3 * RHO * d0 or M == 0:
                break
            x1, f1, d1 = x2, f2, d2
            x2, f2, d2 = x3, f3, d3
            A = 6 * (f1 - f2) + 3 * (d2 + d1) * (x2 - x1)
            B = 3 * (f2 - f1) - (2 * d1 + d2) * (x2 - x1)
            disc = B * B - A * d1 * (x2 - x1)
            with np.errstate(divide="ignore", invalid="ignore"):
                x3 = (x1 - d1 * (x2 - x1) ** 2 / (B + np.sqrt(disc))
                      if disc >= 0 else np.nan)
            if not np.isfinite(x3) or x3 < 0:
                x3 = x2 * EXT
            elif x3 > x2 * EXT:
                x3 = x2 * EXT
            elif x3 < x2 + INT * (x2 - x1):
                x3 = x2 + INT * (x2 - x1)
        x4 = f4 = d4 = 0.0
        while (abs(d3) > -SIG * d0 or f3 > f0 + x3 * RHO * d0) and M > 0:
            if d3 > 0 or f3 > f0 + x3 * RHO * d0:
                x4, f4, d4 = x3, f3, d3
            else:
                x2, f2, d2 = x3, f3, d3
            with np.errstate(divide="ignore", invalid="ignore"):
                if f4 > f0:  # quadratic interpolation
                    x3 = x2 - (0.5 * d2 * (x4 - x2) ** 2) / (
                        f4 - f2 - d2 * (x4 - x2))
                else:        # cubic interpolation
                    A = 6 * (f2 - f4) / (x4 - x2) + 3 * (d4 + d2)
                    B = 3 * (f4 - f2) - (2 * d2 + d4) * (x4 - x2)
                    disc = B * B - A * d2 * (x4 - x2) ** 2
                    x3 = (x2 + (np.sqrt(disc) - B) / A if disc >= 0
                          else np.nan)
            if not np.isfinite(x3):
                x3 = (x2 + x4) / 2
            x3 = max(min(x3, x4 - INT * (x4 - x2)), x2 + INT * (x4 - x2))
            f3, df3 = call(x + x3 * s)
            if f3 < F0:
                X0, F0, dF0 = x + x3 * s, f3, df3
            M -= 1
            d3 = vdot(df3, s)
        if abs(d3) < -SIG * d0 and f3 < f0 + x3 * RHO * d0:
            x = x + x3 * s
            f0 = f3
            # the Polak-Ribiere update
            s = (vdot(df3, df3) - vdot(df0, df3)) / vdot(df0, df0) * s - df3
            df0 = df3
            d3 = d0
            d0 = vdot(df0, s)
            if d0 > 0:
                s = -df0
                d0 = -vdot(s, s)
            x3 = x3 * min(RATIO, d3 / (d0 - 1e-300))
            ls_failed = False
        else:  # the line search failed: back to the best point
            x, f0, df0 = X0, F0, dF0
            if ls_failed:
                break
            s = -df0
            d0 = -vdot(s, s)
            x3 = 1.0 / (1.0 - d0)
            ls_failed = True
    return x, f0


# ---------------------------------------------------------------------------
# linear algebra (ccv.h:1098-1100)
# ---------------------------------------------------------------------------

def invert(a: torch.Tensor) -> torch.Tensor:
    """ccv_invert twin: the inverse of a square matrix, else the
    Moore-Penrose pseudo-inverse."""
    a = _tensor(a)
    if a.shape[-1] == a.shape[-2]:
        return torch.linalg.inv(a)
    return torch.linalg.pinv(a)


def solve(a: torch.Tensor, b) -> torch.Tensor:
    """ccv_solve twin: the minimum-norm least-squares x of a x = b, as
    ``jnp.linalg.lstsq`` gives it (singular values below eps * max(m, n)
    of the largest are cut), through the pseudo-inverse so that the card
    and the CPU take one route."""
    a = _tensor(a)
    return torch.linalg.pinv(a) @ _tensor(b, a)


def eigen(a: torch.Tensor):
    """ccv_eigen twin (real symmetric input): (vectors, values) with the
    eigenvectors as rows, by descending eigenvalue (ties keep ascending
    order)."""
    lam, vec = torch.linalg.eigh(_tensor(a))          # ascending
    order = torch.sort(-lam, stable=True).indices
    return vec[:, order].T, lam[order]
