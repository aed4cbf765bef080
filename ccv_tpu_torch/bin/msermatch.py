"""bin/msermatch twin on the PyTorch port:

    python -m ccv_tpu_torch.bin.msermatch <image> [--device cuda|cpu]

Canny (3, 175, 320) and close_outline on the device make the mask, then the
masked MSER (the C++ set-union tree on the host) with bin/msermatch.py's
params; prints the region count, as bin/msermatch.py does. Runs on the
first CUDA device (the default, which raises without one), or on the CPU
with `--device cpu`. bin/msermatch.py's optional `out.png` (the regions
painted over the image) needs an image writer, which the port does not
have yet: the argument is refused with exit code 2."""

import argparse
import sys
import time

from ccv_tpu_torch import device
from ccv_tpu_torch.core.io import IO_GRAY, read
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ccv_tpu_torch.bin.msermatch",
        description="Masked MSER; prints the region count.")
    ap.add_argument("image")
    ap.add_argument("out", nargs="?", help=argparse.SUPPRESS)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    if args.out is not None:
        ap.error("writing out.png is not ported yet: the port has no image "
                 "writer (core/io.write)")
    dev = (device.default_device() if args.device == "cuda"
           else device.resolve("cpu"))
    gray = read(args.image, IO_GRAY, device=dev).tensor
    t0 = time.perf_counter()
    kps, _ = msermatch(gray)
    elapsed = int((time.perf_counter() - t0) * 1000)
    print(f"total : {len(kps)} in time {elapsed}ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
