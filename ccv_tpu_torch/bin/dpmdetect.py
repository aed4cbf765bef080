"""bin/dpmdetect twin on the PyTorch port:

    python -m ccv_tpu_torch.bin.dpmdetect <image> <model.m>
        [--device cuda|cpu]

Prints `x y width height confidence` per detection, a `| x y width height
confidence` line per part, and a total line, as bin/dpmdetect.py does
(default DpmParams, the image read as RGB; the time is of the second call,
after a warm-up). Runs on the first CUDA device (the default, which raises
without one), or on the CPU with `--device cpu`."""

import argparse
import sys
import time

from ccv_tpu_torch import device
from ccv_tpu_torch.core.io import IO_RGB_COLOR, read
from ccv_tpu_torch.detectors import dpm


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ccv_tpu_torch.bin.dpmdetect",
        description="DPM detection; prints one rect per line, then its "
                    "parts.")
    ap.add_argument("image")
    ap.add_argument("model")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    dev = (device.default_device() if args.device == "cuda"
           else device.resolve("cpu"))
    image = read(args.image, IO_RGB_COLOR, device=dev)
    model = dpm.read_mixture_model(args.model)
    dpm.detect(image, model)  # warm-up: filters on the device, allocator
    t0 = time.perf_counter()
    seq = dpm.detect(image, model)
    elapsed = int((time.perf_counter() - t0) * 1000)
    for comp in seq:
        print(f"{comp.x} {comp.y} {comp.width} {comp.height} "
              f"{comp.confidence:f}")
        for part in comp.parts:
            print(f"| {part.x} {part.y} {part.width} {part.height} "
                  f"{part.confidence:f}")
    print(f"total : {len(seq)} in time {elapsed}ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
