"""bin/scddetect twin on the PyTorch port:

    python -m ccv_tpu_torch.bin.scddetect <image> <cascade.sqlite3>

Prints `x y width height confidence` per detection and a total line. Runs
on the first CUDA device when there is one, else on the CPU."""

import sys
import time

from ccv_tpu_torch import device
from ccv_tpu_torch.core.io import IO_RGB_COLOR, read
from ccv_tpu_torch.detectors import scd


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    dev = device.default_device()
    image = read(argv[0], IO_RGB_COLOR, device=dev)
    cascade = scd.load_cascade(argv[1])
    scd.detect(image, cascade)  # warm-up: kernel build, allocator
    t0 = time.perf_counter()
    seq = scd.detect(image, cascade)  # returns once the device is done
    elapsed = int((time.perf_counter() - t0) * 1000)
    for c in seq:
        print(f"{int(c.x)} {int(c.y)} {int(c.width)} {int(c.height)} "
              f"{c.confidence:f}")
    print(f"total : {len(seq)} in time {elapsed}ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
