"""Does reading each distinct corner once pay in kernel K1?

    python -m ccv_tpu_torch.bin.k1_corner_trial     # from the repo root

Runs K1 (csrc/scd_cascade.cu) on chip_smoke.py's 1080p level-0 SAT with the
face cascade, at chip_smoke.py's near-median thresholds and at the file's
open ones, twice per thresholds: with the tables as built (each feature of
SCD's three box layouts reads its 9 or 10 distinct corners) and with every
feature set to layout 0 (the same kernel reading all 16 box corners).
Checks that both give bit-equal outputs, then times them in turns (A, B, B,
A, twice) with CUDA events and prints the means, the single times and the
card's name and power limit. Needs a CUDA card.
"""

import dataclasses
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main() -> int:
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from ccv_tpu_torch.core.io import read
    from ccv_tpu_torch.detectors import scd
    from ccv_tpu_torch.device import default_device
    from ccv_tpu_torch.ops.kernels import scd_cascade as k1

    dev = default_device()
    card = cs.card_line()
    k1.build()
    face = scd.load_cascade(os.path.join(cs.DATA, "face_low.sqlite3"))
    frame = cs.frame_1080p(read)
    specs, _ = scd._level_specs(*frame.shape, face, scd.ScdParams())
    dims = np.array([specs[0][4:6]])
    sat = scd._sat_cf8(scd.scd_map_cf8(
        torch.from_numpy(frame).to(dev)[..., None]))[None].contiguous()
    face_med = cs.with_median_thresholds(scd, k1, face, sat, dims)
    for name, cascade, reps in (("near-median", face_med, 20),
                                ("open", face, 10)):
        tabs = {"distinct": scd.cascade_tables(cascade)}
        tabs["16 box corners"] = dataclasses.replace(
            tabs["distinct"], layout=np.zeros_like(tabs["distinct"].layout),
            _on={})
        outs = [k1.cascade_eval_levels(sat, t, cs.STEP, dims)
                for t in tabs.values()]
        torch.cuda.synchronize()
        cs.check(all(torch.equal(a, b) for a, b in zip(*outs)),
                 f"{name}: the two corner reads give different outputs")
        ms = {key: [] for key in tabs}
        for key in [*tabs, *reversed(tabs)] * 2:
            ms[key].append(cs.time_cuda(
                lambda: k1.cascade_eval_levels(sat, tabs[key], cs.STEP, dims),
                reps))
        print(f"K1, 1080p level 0, {name} thresholds, outputs bit-equal; "
              + "; ".join(f"{key}: mean {np.mean(v):.4f} ms "
                          f"({', '.join(f'{x:.4f}' for x in v)})"
                          for key, v in ms.items())
              + f"; {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
