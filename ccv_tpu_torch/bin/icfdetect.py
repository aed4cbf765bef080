"""bin/icfdetect twin on the PyTorch port:

    python -m ccv_tpu_torch.bin.icfdetect <image> <cascade.icf>
        [--device cuda|cpu]

Prints `x y width height confidence` per detection and a total line, as
bin/icfdetect.py does. Runs on the first CUDA device (the default, which
raises without one), or on the CPU with `--device cpu`."""

import argparse
import sys
import time

from ccv_tpu_torch import device
from ccv_tpu_torch.core.io import IO_RGB_COLOR, read
from ccv_tpu_torch.detectors import icf


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ccv_tpu_torch.bin.icfdetect",
        description="ICF pedestrian detection; prints one rect per line.")
    ap.add_argument("image")
    ap.add_argument("cascade")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    dev = (device.default_device() if args.device == "cuda"
           else device.resolve("cpu"))
    image = read(args.image, IO_RGB_COLOR, device=dev)
    cascade = icf.load_cascade(args.cascade)
    icf.detect_objects(image, cascade)  # warm-up: tables, allocator
    t0 = time.perf_counter()
    seq = icf.detect_objects(image, cascade)  # returns once on the host
    elapsed = int((time.perf_counter() - t0) * 1000)
    for c in seq:
        print(f"{int(c.x)} {int(c.y)} {int(c.width)} {int(c.height)} "
              f"{c.confidence:f}")
    print(f"total : {len(seq)} in time {elapsed}ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
