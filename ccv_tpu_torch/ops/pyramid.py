"""Image pyramids (counterpart of ccv_tpu/ops/pyramid.py).

The detectors' outer loop: an octave chain of exact-2x ``sample_down`` plus
fractional ``resample`` levels within each octave (lib/ccv_scd.c:1667-1700,
lib/ccv_bbf.c:1198-1236, lib/ccv_swt.c:638-652). Level sizes are computed
on the host; every level stays on the image's device.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ccv_tpu_torch.ops import resample as R


def octave_sizes(h: int, w: int, n_octaves: int) -> List[Tuple[int, int]]:
    sizes = [(h, w)]
    for _ in range(1, n_octaves):
        h, w = h // 2, w // 2
        sizes.append((h, w))
    return sizes


def max_octaves(h: int, w: int, min_h: int, min_w: int) -> int:
    n = 1
    while (h // 2) >= min_h and (w // 2) >= min_w:
        h, w = h // 2, w // 2
        n += 1
    return n


def _hw(img: torch.Tensor) -> Tuple[int, int]:
    """(H, W) of an (H, W) or (..., H, W, C) image."""
    if img.dim() >= 3:
        return img.shape[-3], img.shape[-2]
    return img.shape[-2], img.shape[-1]


def octave_pyramid(img: torch.Tensor, n_octaves: int) -> List[torch.Tensor]:
    """Chain of exact-2x 5-tap downsamples (ccv_sample_down)."""
    levels = [img]
    for _ in range(1, n_octaves):
        levels.append(R.sample_down(levels[-1]))
    return levels


def scale_pyramid(img: torch.Tensor, scales: Sequence[float],
                  interp: int = R.INTER_AREA) -> List[torch.Tensor]:
    """Arbitrary-scale pyramid: each level is resample(img, scale)."""
    h, w = _hw(img)
    return [R.resample(img, rows=int(h * s + 0.5), cols=int(w * s + 0.5),
                       rows_scale=s, cols_scale=s, interp=interp)
            for s in scales]


def interval_pyramid(img: torch.Tensor, n_octaves: int, n_intervals: int,
                     interp: int = R.INTER_AREA) -> List[List[torch.Tensor]]:
    """Octaves x intervals grid (the SCD/BBF layout): level[o][i] has scale
    2^-o * 2^(-i/n_intervals); interval levels are resampled once at the top
    octave, then halved exactly down the chain."""
    tops = [img] + scale_pyramid(
        img, [2.0 ** (-i / n_intervals) for i in range(1, n_intervals)],
        interp)
    grid = [tops]
    for _ in range(1, n_octaves):
        grid.append([R.sample_down(lv) for lv in grid[-1]])
    return grid
