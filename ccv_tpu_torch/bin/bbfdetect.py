"""bin/bbfdetect twin on the PyTorch port:

    python -m ccv_tpu_torch.bin.bbfdetect <image> <cascade directory>
        [--device cuda|cpu]

Prints `x y width height confidence` per face and a total line, as
bin/bbfdetect.py does (default BbfParams, the image read as gray). Runs on
the first CUDA device (the default, which raises without one), or on the
CPU with `--device cpu`."""

import argparse
import sys
import time

from ccv_tpu_torch import device
from ccv_tpu_torch.core.io import IO_GRAY, read
from ccv_tpu_torch.detectors import bbf


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ccv_tpu_torch.bin.bbfdetect",
        description="BBF face detection; prints one rect per line.")
    ap.add_argument("image")
    ap.add_argument("cascade")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    dev = (device.default_device() if args.device == "cuda"
           else device.resolve("cpu"))
    image = read(args.image, IO_GRAY, device=dev)
    cascade = bbf.load_cascade(args.cascade)
    t0 = time.perf_counter()
    seq = bbf.detect_objects(image, cascade)  # returns once on the host
    elapsed = int((time.perf_counter() - t0) * 1000)
    for c in seq:
        print(f"{int(c.x)} {int(c.y)} {int(c.width)} {int(c.height)} "
              f"{c.confidence:f}")
    print(f"total : {len(seq)} in time {elapsed}ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
