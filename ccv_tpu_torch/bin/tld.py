"""bin/tld twin on the PyTorch port:

    python -m ccv_tpu_torch.bin.tld <frame0.png> <frame1.png> [...] x y w h
        [--device cuda|cpu]

Tracks the box (x, y, w, h) of the first frame through the ordered frames
(the reference reads a video through libavcodec) and prints one rect and
confidence per frame, or a dashed line where the target is lost, as
bin/tld.py does. Runs on the first CUDA device (the default, which raises
without one), or on the CPU with `--device cpu`."""

import argparse
import sys

from ccv_tpu_torch import device
from ccv_tpu_torch.core.io import IO_GRAY, read
from ccv_tpu_torch.detectors import tld


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ccv_tpu_torch.bin.tld",
        description="TLD tracking; prints one rect per frame.")
    ap.add_argument("args", nargs="+", metavar="frame... x y w h")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    if len(args.args) < 6:
        ap.error("needs at least two frames and x y w h")
    *frames, x, y, w, h = args.args
    box = (int(x), int(y), int(w), int(h))
    dev = (device.default_device() if args.device == "cuda"
           else device.resolve("cpu"))
    imgs = [read(f, IO_GRAY, device=dev).tensor for f in frames]
    print(f"{0:05d}: {box[0]} {box[1]} {box[2]} {box[3]} 1.000000")
    tracker = tld.Tld(imgs[0], box)
    for i in range(1, len(imgs)):
        nb, conf = tracker.track_object(imgs[i - 1], imgs[i], tld.TldInfo())
        if nb is None:
            print(f"{i:05d}: --------------")
        else:
            print(f"{i:05d}: {nb[0]} {nb[1]} {nb[2]} {nb[3]} {conf:f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
