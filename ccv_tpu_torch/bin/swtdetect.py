"""bin/swtdetect twin on the PyTorch port:

    python -m ccv_tpu_torch.bin.swtdetect <image> [--device cuda|cpu]

Prints `x y width height` per word and a total line, as
bin/swtdetect.py does (default SwtParams, the image read as gray). Runs on
the first CUDA device (the default, which raises without one), or on the
CPU with `--device cpu`."""

import argparse
import sys
import time

from ccv_tpu_torch import device
from ccv_tpu_torch.core.io import IO_GRAY, read
from ccv_tpu_torch.detectors import swt


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ccv_tpu_torch.bin.swtdetect",
        description="SWT text detection; prints one word per line.")
    ap.add_argument("image")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    dev = (device.default_device() if args.device == "cuda"
           else device.resolve("cpu"))
    image = read(args.image, IO_GRAY, device=dev)
    swt.detect_words(image)  # warm-up: the native build, allocator
    t0 = time.perf_counter()
    words = swt.detect_words(image)
    elapsed = int((time.perf_counter() - t0) * 1000)
    for w in words:
        print(f"{int(w.x)} {int(w.y)} {int(w.width)} {int(w.height)}")
    print(f"total : {len(words)} in time {elapsed}ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
