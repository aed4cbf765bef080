"""bin/siftmatch twin on the PyTorch port:

    python -m ccv_tpu_torch.bin.siftmatch <object image> <scene image>
        [--device cuda|cpu]

SIFT of both images (read as gray, default SiftParams) and the
squared-distance ratio test (0.36) of every object keypoint against the
scene's (``sift.match_pair``). Prints `x y => x y` per match, then the
matched count and the milliseconds, as bin/siftmatch.py does. Runs on the
first CUDA device (the default, which raises without one), or on the CPU
with `--device cpu`."""

import argparse
import sys
import time

from ccv_tpu_torch import device
from ccv_tpu_torch.core.io import IO_GRAY, read
from ccv_tpu_torch.detectors import sift


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ccv_tpu_torch.bin.siftmatch",
        description="SIFT matching of an object in a scene.")
    ap.add_argument("object")
    ap.add_argument("scene")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    dev = (device.default_device() if args.device == "cuda"
           else device.resolve("cpu"))
    obj = read(args.object, IO_GRAY, device=dev)
    scene = read(args.scene, IO_GRAY, device=dev)
    t0 = time.perf_counter()
    k1, k2, pairs = sift.match_pair(obj, scene)
    elapsed = int((time.perf_counter() - t0) * 1000)
    for i, j in pairs:
        a, b = k1[i], k2[j]
        print(f"{a['x']:.2f} {a['y']:.2f} => {b['x']:.2f} {b['y']:.2f}")
    print(f"{len(pairs)} keypoints out of {len(k1)} are matched")
    print(f"elpased time : {elapsed}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
