"""Where the card's time goes in the staged SCD form at 1920x1080.

    python -m ccv_tpu_torch.bin.staged_profile [--images N]   # repo root

Runs ``detect(form="pallas")`` on chip_smoke.py's 1920x1080 frame with the
face cascade (tests/data/face_low.sqlite3) at chip_smoke.py's near-median
thresholds: one image to warm up, one to count K3's launches and the
overflow reruns, then N images (default 3) under torch.profiler
(chip_smoke.device_ms). Prints one JSON line: device busy ms per image, the
wall per image in the same window (profiler overhead included), the idle
share, K3's and the B2 gathers' device ms per image, the largest kernels by
device ms per image, the launches and reruns, and the card's name and power
limit. It uses only what chip_smoke.py and the detector offered before K3
ran phase B1, so the same script profiles an older checkout of the
repository when copied into it. Needs a CUDA card.
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def split(by_name: dict, top: int = 8) -> dict:
    """The staged form's device ms per image by part, from {kernel name:
    device ms per image}: K3, the gathers of phase B2, and the ``top``
    largest kernels (names cut to 70 characters)."""
    return dict(
        k3_ms=sum(v for k, v in by_name.items() if "scd_phase_a_kernel" in k),
        gather_ms=sum(v for k, v in by_name.items() if "gather" in k.lower()),
        top=[(k[:70], v) for k, v in sorted(by_name.items(),
                                             key=lambda kv: -kv[1])[:top]])


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--images", type=int, default=3)
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from ccv_tpu_torch.core.io import read
    from ccv_tpu_torch.detectors import scd
    from ccv_tpu_torch.device import default_device
    from ccv_tpu_torch.ops.kernels import scd_cascade as k1
    from ccv_tpu_torch.ops.kernels import scd_phase as k3

    dev = default_device()
    face = scd.load_cascade(os.path.join(cs.DATA, "face_low.sqlite3"))
    frame = cs.frame_1080p(read)
    specs, _ = scd._level_specs(*frame.shape, face, scd.ScdParams())
    dims = np.array([specs[0][4:6]])
    img = torch.from_numpy(frame).to(dev)
    sat = scd._sat_cf8(scd.scd_map_cf8(img[..., None]))[None].contiguous()
    cascade = cs.with_median_thresholds(scd, k1, face, sat, dims)
    params = scd.ScdParams(min_neighbors=0)
    scd.detect(img, cascade, params, form="pallas")  # warm-up
    launches, reruns = k3.LAUNCHES, scd.RERUNS
    windows = len(scd.detect(img, cascade, params, form="pallas"))
    launches, reruns = k3.LAUNCHES - launches, scd.RERUNS - reruns
    busy, by_name, wall = cs.device_ms(
        lambda: scd.detect(img, cascade, params, form="pallas"), args.images)
    print(json.dumps(dict(
        busy_ms=busy, wall_ms=wall, idle_share=1 - busy / wall,
        **split(by_name), k3_launches=launches, reruns=reruns,
        windows=windows, images=args.images, card=cs.card_line())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
