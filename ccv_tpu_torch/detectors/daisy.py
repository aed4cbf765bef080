"""DAISY dense descriptor (counterpart of ccv_tpu/detectors/daisy.py;
reference: lib/ccv_daisy.c, Tola et al.).

Oriented gradient layers max(0, cos t * dx + sin t * dy), an initial
Gaussian smoothing, incremental smoothing per ring at the cube sigmas, then
per pixel the centre histogram and bilinear petal samples on ``rad_q_no``
rings of ``th_q_no`` points, and one of three normalisations; every step is
a torch op over the whole image on its device.

As ccv_tpu, every ring reads its own smoothed cube (the intended
semantics); the reference's outermost ring reads a cube that skipped its
in-place transpose (ccv_daisy.c:108-131), so its values differ there.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ccv_tpu_torch.core.dense_matrix import as_array
from ccv_tpu_torch.ops import basic

NORMAL_PARTIAL = 0x01
NORMAL_FULL = 0x02
NORMAL_SIFT = 0x03


@dataclasses.dataclass
class DaisyParams:
    radius: float = 15.0
    rad_q_no: int = 3
    th_q_no: int = 8
    hist_th_q_no: int = 8
    normalize_threshold: float = 0.154
    normalize_method: int = NORMAL_PARTIAL


def _normalized(v: torch.Tensor) -> torch.Tensor:
    """v / ||v|| over the last axis where the norm exceeds 1e-3."""
    norms = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
    return torch.where(norms > 1e-3, v / torch.clamp(norms, min=1e-12), v)


def daisy(a, params: DaisyParams = DaisyParams(), device=None
          ) -> torch.Tensor:
    """ccv_daisy twin: (H, W, grid points * hist) float32 on ``a``'s device
    (a numpy image goes to ``device``, default the card)."""
    img = as_array(a, device)
    if img.dim() == 3:
        img = img[..., 0]
    H, W = img.shape
    P = params
    dev = img.device
    grid_point_number = P.rad_q_no * P.th_q_no + 1
    r_step = P.radius / P.rad_q_no
    t_step = 2 * math.pi / P.th_q_no
    # oriented gradient layers (the 3-tap sobel gives a sigma ~0.85 blur)
    dx = basic.sobel(img, 1, 0, out_float=True)
    dy = basic.sobel(img, 0, 1, out_float=True)
    sobel_sigma = math.sqrt(0.5 / -math.log(0.5))
    sigma0 = math.sqrt(1.6 ** 2 - sobel_sigma ** 2)
    angles = [k * 2 * math.pi / P.th_q_no for k in range(P.hist_th_q_no)]
    cube = torch.stack([
        basic.blur(torch.clamp(math.cos(t) * dx + math.sin(t) * dy, min=0.0),
                   sigma0) for t in angles], dim=-1)  # (H, W, hist)
    cubes, prev_sigma, cur = [], 0.0, cube
    for k in range(P.rad_q_no):
        s = (k + 1) * r_step * 0.5
        inc = math.sqrt(s * s - prev_sigma * prev_sigma) if prev_sigma else s
        cur = basic.blur(cur, inc)
        cubes.append(cur)
        prev_sigma = s

    yg, xg = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev),
                            indexing="ij")
    points = [cube]
    for r in range(P.rad_q_no):
        src = cubes[r]
        for j in range(P.th_q_no):
            y = yg + math.sin(j * t_step) * (r + 1) * r_step
            x = xg + math.cos(j * t_step) * (r + 1) * r_step
            iy = torch.round(y).to(torch.int64)
            ix = torch.round(x).to(torch.int64)
            valid = (iy >= 0) & (iy < H) & (ix >= 0) & (ix < W)
            jy = torch.floor(y).to(torch.int64)
            jx = torch.floor(x).to(torch.int64)
            yr, xr = y - jy, x - jx
            acc = torch.zeros((H, W, P.hist_th_q_no), device=dev)
            for dyy, dxx, wgt in ((0, 0, (1 - yr) * (1 - xr)),
                                  (1, 0, yr * (1 - xr)),
                                  (0, 1, (1 - yr) * xr),
                                  (1, 1, yr * xr)):
                sy, sx = jy + dyy, jx + dxx
                ok = (sy >= 0) & (sy < H) & (sx >= 0) & (sx < W)
                vals = src[sy.clamp(0, H - 1), sx.clamp(0, W - 1)]
                acc = acc + torch.where(ok[..., None], vals * wgt[..., None],
                                        0.0)
            points.append(torch.where(valid[..., None], acc, 0.0))
    desc = torch.stack(points, dim=2)   # (H, W, grid points, hist)
    flat = desc.reshape(H, W, grid_point_number * P.hist_th_q_no)
    if P.normalize_method == NORMAL_PARTIAL:
        return _normalized(desc).reshape(H, W, -1)
    if P.normalize_method == NORMAL_FULL:
        return _normalized(flat)
    # NORMAL_SIFT: normalise and clamp at the threshold, five times
    out = flat
    for _ in range(5):
        out = torch.clamp(_normalized(out), min=P.normalize_threshold)
    return out
