"""Summed-area tables and prefix sums (counterpart of the ``sat`` half of
ccv_tpu/core/algebra.py; reference: lib/ccv_algebra.c).

``sat`` is two cumulative sums, the building block of the cascade
detectors' box features. Integer images sum exactly with ``torch.cumsum``.
Float images sum in the order ccv_tpu's ``sat`` sums them on the CPU, where
XLA rewrites a cumulative sum into 16-element tiles: a sequential sum
within each tile, the same scan over the tiles' totals, and each tile's
exclusive prefix added back (``tiled_cumsum``). Every step is an
elementwise add, so the card and the CPU round alike and the port's SAT
has ccv_tpu's bits: a box feature is a difference of SAT corners that
reach ~1e9 at 1080p, where one float32 ulp is ~64, so another summation
order would move features, not just confidences.

``associative_scan_add`` is ``jax.lax.associative_scan(jnp.add, x, axis)``
step for step (ICF sums its trees with it), for the same reason.

ccv_tpu's ``sat_mxu`` (triangular matmuls, the TPU form) and ``sat_auto``
(its measured choice between forms) are not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NO_PADDING = 0x00
PADDING_ZERO = 0x01

TILE = 16  # XLA's tile for cumulative sums on the CPU


def _sequential_cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Left-to-right running sum along ``dim``: one add per element."""
    parts = [x.select(dim, 0)]
    for k in range(1, x.shape[dim]):
        parts.append(parts[-1] + x.select(dim, k))
    return torch.stack(parts, dim)


def tiled_cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive float cumulative sum along ``dim`` in the order of XLA's
    CPU cumsum: tiles of TILE summed left to right, the tiles' totals
    scanned the same way (recursively) and added back to the next tiles."""
    dim = dim % x.dim()
    n = x.shape[dim]
    if n <= TILE:
        return _sequential_cumsum(x, dim)
    m = -(-n // TILE) * TILE
    pad = [0, 0] * (x.dim() - 1 - dim) + [0, m - n]
    tiles = F.pad(x, pad).unflatten(dim, (m // TILE, TILE))
    within = _sequential_cumsum(tiles, dim + 1)
    totals = tiled_cumsum(within.select(dim + 1, TILE - 1), dim)
    excl = torch.cat([torch.zeros_like(totals.narrow(dim, 0, 1)),
                      totals.narrow(dim, 0, m // TILE - 1)], dim)
    out = (within + excl.unsqueeze(dim + 1)).flatten(dim, dim + 1)
    return out.narrow(dim, 0, n)


def associative_scan_add(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive prefix sums along ``dim`` by JAX's associative_scan:
    pairwise sums, the scan of those (recursively), then the even
    positions from the odd ones, interleaved."""
    e = x.movedim(dim, 0)
    return _ascan(e).movedim(0, dim)


def _ascan(e: torch.Tensor) -> torch.Tensor:
    n = e.shape[0]
    if n < 2:
        return e
    odd = _ascan(e[0:-1:2] + e[1::2])
    even = (odd[:-1] if n % 2 == 0 else odd) + e[2::2]
    out = torch.empty_like(e)
    out[0] = e[0]
    out[2::2] = even
    out[1::2] = odd
    return out


def sat(a: torch.Tensor, padding: int = NO_PADDING) -> torch.Tensor:
    """ccv_sat twin: inclusive 2D prefix sum over (..., H, W[, C]); a 2-D
    input is (H, W). NO_PADDING: the input's size. PADDING_ZERO: one
    leading row and column of zeros, so window sums need no bounds checks.
    Integer inputs accumulate in int32, int64 from 0x808080 pixels (the
    reference's safe-type rule); float inputs in float32, summed along H
    and then W as ccv_tpu's sat."""
    h_axis, w_axis = (-2, -1) if a.dim() == 2 else (-3, -2)
    if a.dtype.is_floating_point:
        x = a.to(torch.float32)
        out = tiled_cumsum(tiled_cumsum(x, h_axis), w_axis)
    else:
        big = a.shape[h_axis] * a.shape[w_axis] >= 0x808080
        acc = torch.int64 if big else torch.int32
        out = torch.cumsum(torch.cumsum(a, h_axis, dtype=acc), w_axis,
                           dtype=acc)
    if padding == PADDING_ZERO:
        pad = [0, 0] * out.dim()  # (before, after) pairs from the last axis
        pad[2 * (-1 - w_axis)] = pad[2 * (-1 - h_axis)] = 1
        out = F.pad(out, pad)
    return out
