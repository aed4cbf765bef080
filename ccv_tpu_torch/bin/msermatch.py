"""bin/msermatch twin on the PyTorch port:

    python -m ccv_tpu_torch.bin.msermatch <image> [out.png] [--device cuda|cpu]

Canny (3, 175, 320) and close_outline on the device make the mask, then the
masked MSER (the C++ set-union tree on the host) with bin/msermatch.py's
params; prints the region count, as bin/msermatch.py does. With `out.png`,
writes the gray image as RGB with each region's pixels painted in one of
bin/msermatch.py's six colours (label - 1 mod 6), through `core.io.write`.
Runs on the first CUDA device (the default, which raises without one), or
on the CPU with `--device cpu`."""

import argparse
import sys
import time

import numpy as np

from ccv_tpu_torch import device
from ccv_tpu_torch.core.io import IO_GRAY, read, write
from ccv_tpu_torch.detectors import mser
from ccv_tpu_torch.ops import classic


def msermatch(gray):
    """(keypoints, label map) of bin/msermatch.py's pipeline on a gray
    (H, W) uint8 tensor."""
    outline = classic.close_outline(classic.canny(gray, 3, 175, 320))
    params = mser.MserParams(
        min_area=60, max_area=int(gray.shape[0] * gray.shape[1] * 0.3 + 0.5),
        min_diversity=0.2, delta=5, max_variance=0.25,
        direction=mser.DARK_TO_BRIGHT)
    return mser.mser(gray, h=outline, params=params)


COLORS = np.array([[0, 0, 255], [0, 255, 0], [255, 0, 0], [255, 255, 0],
                   [255, 0, 255], [0, 255, 255]], np.uint8)


def paint(gray: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """The (H, W, 3) picture bin/msermatch.py writes: the gray image with
    each region's pixels in COLORS[(label - 1) % 6]."""
    rgb = np.stack([gray] * 3, -1)
    m = labels > 0
    rgb[m] = COLORS[(labels[m] - 1) % 6]
    return rgb


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ccv_tpu_torch.bin.msermatch",
        description="Masked MSER; prints the region count.")
    ap.add_argument("image")
    ap.add_argument("out", nargs="?",
                    help="write the regions painted over the image (PNG)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    dev = (device.default_device() if args.device == "cuda"
           else device.resolve("cpu"))
    gray = read(args.image, IO_GRAY, device=dev).tensor
    t0 = time.perf_counter()
    kps, labels = msermatch(gray)
    elapsed = int((time.perf_counter() - t0) * 1000)
    print(f"total : {len(kps)} in time {elapsed}ms")
    if args.out is not None:
        write(paint(gray.cpu().numpy(), labels), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
