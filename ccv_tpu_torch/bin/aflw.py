"""bin/aflw twin on the PyTorch port: AFLW face crops (reference:
bin/aflw.c).

    python -m ccv_tpu_torch.bin.aflw annotations.txt image_dir/ out_dir/
        [--seed 0] [--device cuda|cpu]

Reads annotation lines "file x y width height roll pitch yaw" (radians,
aflw.c:46), keeps the near-frontal faces (|pitch|, |roll| < 22.5 degrees,
|yaw| < 20, at least 15 pixels: aflw.c:48-52), deforms each square crop at
random (a scale in [1 / (1 + s), 1 + s] spread evenly around 1, a shift of
up to 5%: aflw.c:15-22) with draws from ``np.random.default_rng(seed)`` in
bin/aflw.py's order, resamples it to 48 x 48 (INTER_CUBIC up, INTER_AREA
down: aflw.c:25-28) and writes aflw-NNNNNNN-bw.png and -rgb.png pairs.
The crops and the resampling run on the first CUDA device (the default,
which raises without one), or on the CPU with ``--device cpu``."""

import argparse
import math
import os
import sys

import torch

from ccv_tpu_torch.bin.icfcreate import run_device

SIZE = 48
DEFORM_ANGLE = 10      # accepted for parity; unused, as in the reference
DEFORM_SCALE = 0.1
DEFORM_SHIFT = 0.05


def slice_with_rect(rng, image: torch.Tensor, rect, size=SIZE,
                    deform_scale=DEFORM_SCALE,
                    deform_shift=DEFORM_SHIFT) -> torch.Tensor:
    """aflw.c:10-31 ``_ccv_aflw_slice_with_rect``: a random scale and shift
    of a square crop of ``image`` (zero outside it), resampled to
    (size, size) on the image's device."""
    from ccv_tpu_torch.core.util import slice_
    from ccv_tpu_torch.ops import resample

    x, y, w, h = rect
    if w != h:
        raise ValueError(f"aflw rects are square, got {w} x {h}")
    # a scale spread evenly around 1 (aflw.c:17)
    u = rng.uniform()
    scale = (1 + deform_scale * u) / (1 + deform_scale * (1 - u))
    new_w = int(w * scale + 0.5)
    new_h = int(h * scale + 0.5)
    ox = int((deform_shift * 2 * rng.uniform() - deform_shift) * w + 0.5
             + (w - new_w) * 0.5)
    oy = int((deform_shift * 2 * rng.uniform() - deform_shift) * h + 0.5
             + (h - new_h) * 0.5)
    crop = slice_(image, y + oy, x + ox, h, w)
    interp = resample.INTER_CUBIC if size > w else resample.INTER_AREA
    return resample.resample(crop, rows=size, cols=size,
                             rows_scale=size / crop.shape[0],
                             cols_scale=size / crop.shape[1], interp=interp)


def frontal(roll: float, pitch: float, yaw: float, w: int, h: int) -> bool:
    """aflw.c:48-52's near-frontal filter."""
    lim = math.pi * 22.5 / 180
    ylim = math.pi * 20 / 180
    return (abs(pitch) < lim and abs(roll) < lim and abs(yaw) < ylim
            and w >= 15 and h >= 15)


def main(argv=None) -> int:
    import numpy as np

    from ccv_tpu_torch.core.io import IO_GRAY, IO_RGB_COLOR, read, write

    ap = argparse.ArgumentParser(prog="python -m ccv_tpu_torch.bin.aflw",
                                 description="Cut AFLW face crops.")
    ap.add_argument("annotations")
    ap.add_argument("image_dir")
    ap.add_argument("out_dir")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    dev = run_device(args.device)
    rng = np.random.default_rng(args.seed)
    os.makedirs(args.out_dir, exist_ok=True)
    i = 0
    with open(args.annotations) as r:
        for line in r:
            parts = line.split()
            if len(parts) != 8:
                continue
            fname = parts[0]
            x, y, w, h = (int(v) for v in parts[1:5])
            roll, pitch, yaw = (float(v) for v in parts[5:8])
            if not frontal(roll, pitch, yaw, w, h):
                continue
            path = os.path.join(args.image_dir, fname)
            for suffix, flag in (("bw", IO_GRAY), ("rgb", IO_RGB_COLOR)):
                img = read(path, flag, device=dev).tensor
                b = slice_with_rect(rng, img, (x, y, w, h))
                write(b, os.path.join(args.out_dir,
                                      f"aflw-{i:07d}-{suffix}.png"))
            i += 1
    print(f"wrote {i} crops to {args.out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
