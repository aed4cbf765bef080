"""bin/icf_profile twin on the PyTorch port: one ``detect_objects`` timed.

    python -m ccv_tpu_torch.bin.icf_profile <image> <cascade.icf>
        [--steps 10] [--device cuda|cpu]

Prints one JSON line: ms per image (host clock around ``steps`` calls,
each returning once the device is done, after one warm-up call), the
warm-up's seconds, the detections and the device. ``ccv_tpu``'s tool
also forces each of its SAT forms (``sat`` / ``sat_mxu``); the port has
one SAT form, so it has no ``--form``. On the card the timing is of the
card (the default, which raises without one); ``--device cpu`` times the
CPU."""

import argparse
import json
import sys
import time

import torch

from ccv_tpu_torch.bin.icfcreate import run_device
from ccv_tpu_torch.core.io import IO_RGB_COLOR, read
from ccv_tpu_torch.detectors import icf


def run(image: str, cascade: str, steps: int, dev: torch.device) -> dict:
    img = read(image, IO_RGB_COLOR, device=dev)
    casc = icf.load_cascade(cascade)
    t0 = time.perf_counter()
    dets = icf.detect_objects(img, casc)
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(steps):
        dets = icf.detect_objects(img, casc)
    ms = (time.perf_counter() - t0) / steps * 1e3
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    return {"ms_per_image": round(ms, 3), "warm_s": round(warm, 2),
            "detections": len(dets), "device": name}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ccv_tpu_torch.bin.icf_profile",
        description="Time ICF detect_objects.")
    ap.add_argument("image")
    ap.add_argument("cascade")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    print(json.dumps(run(args.image, args.cascade, args.steps,
                         run_device(args.device))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
