"""Which tile, windows a thread and blocks a SM suit kernel K3?

    python -m ccv_tpu_torch.bin.k3_tile_trial     # from the repo root

Builds variants of csrc/scd_phase.cu, each with its constants kRows
(windows a thread, in neighbouring tile rows), kWarps (warps a block: a
block's tile is 32 x kWarps * kRows windows) and kBlocksPerSm set to one
entry of VARIANTS, into ccv_tpu_torch/_build/k3_trial/ (nvcc with
``-Xptxas -v``: each variant's registers and spills are printed). Runs each
on chip_smoke.py's 1080p level-0 SAT with the face cascade's phase-A and
phase-B1 tables at chip_smoke.py's near-median thresholds, off one copy of
the phase planes; checks that every variant's outputs equal the committed
kernel's bit for bit (and the committed kernel's its plain version, as
chip_smoke.py does); then times all of them, the committed one first, in
turns (forward, then backward, 50 launches each, CUDA events, the kernel
alone) and prints the means, the single times and the card's name and
power limit. Needs a CUDA card.
"""

import ctypes
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# (kRows, kWarps, kBlocksPerSm); (1, 8, 3) is the committed kernel's
VARIANTS = ((1, 4, 5), (1, 4, 6), (1, 4, 7), (1, 4, 8), (1, 2, 12), (1, 8, 3),
            (2, 4, 4), (2, 4, 5), (2, 4, 6), (2, 8, 2), (4, 4, 2), (4, 4, 3),
            (4, 2, 6))


def build_variant(_build, flags, rows, warps, blocks):
    """(ctypes entry, ptxas lines) of scd_phase.cu with these constants."""
    src = (_build.CSRC / "scd_phase.cu").read_text()
    for name, value in (("kRows", rows), ("kWarps", warps),
                        ("kBlocksPerSm", blocks)):
        src, n = re.subn(rf"constexpr int {name} = \d+;",
                         f"constexpr int {name} = {value};", src)
        if n != 1:
            raise RuntimeError(f"scd_phase.cu has {n} definitions of {name}")
    out = _build.BUILD_DIR / "k3_trial"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / f"scd_phase_r{rows}_w{warps}_b{blocks}.cu"
    cu.write_text(src)
    so = cu.with_suffix(".so")
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, *flags, "-Xptxas", "-v",
           "-I", str(_build.CSRC), "-o", str(so), str(cu)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{' '.join(cmd)}\n{proc.stderr}")
    ptxas = [line.strip() for line in proc.stderr.splitlines()
             if "Used" in line or "spill" in line]
    return ctypes.CDLL(str(so)).scd_phase_a_levels, ptxas


def main() -> int:
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from ccv_tpu_torch.core.io import read
    from ccv_tpu_torch.detectors import scd
    from ccv_tpu_torch.device import default_device
    from ccv_tpu_torch.ops.kernels import _build
    from ccv_tpu_torch.ops.kernels import scd_cascade as k1
    from ccv_tpu_torch.ops.kernels import scd_phase as k3

    dev = default_device()
    card = cs.card_line()
    k3.build()
    entry = k3._library().scd_phase_a_levels
    with ThreadPoolExecutor(len(VARIANTS)) as ex:
        futs = {v: ex.submit(build_variant, _build, k1.layout_flags(), *v)
                for v in VARIANTS}
        built = {v: f.result() for v, f in futs.items()}
    for (rows, warps, blocks), (fn, ptxas) in built.items():
        fn.argtypes, fn.restype = entry.argtypes, entry.restype
        print(f"kRows {rows}, kWarps {warps}, kBlocksPerSm {blocks}: "
              + " | ".join(ptxas), flush=True)

    face = scd.load_cascade(os.path.join(cs.DATA, "face_low.sqlite3"))
    frame = cs.frame_1080p(read)
    specs, _ = scd._level_specs(*frame.shape, face, scd.ScdParams())
    dims = np.array([specs[0][4:6]])
    sat = scd._sat_cf8(scd.scd_map_cf8(
        torch.from_numpy(frame).to(dev)[..., None]))[None].contiguous()
    staged = scd.staged_tables(
        cs.with_median_thresholds(scd, k1, face, sat, dims))
    planes = k1.kernel_planes(sat, staged.phase_a, cs.STEP, dims,
                              staged.phase_b1)
    for phase in ("phase_a", "phase_b1"):
        tables = getattr(staged, phase)
        cs.phase_a_vs_plain(k1, k3, tables, sat, dims)
        runs = {"committed": k3.launcher(sat, tables, cs.STEP, dims,
                                         planes)}
        for v, (fn, _p) in built.items():
            runs["r%d w%d b%d" % v] = k1._launch(
                fn, "trial", sat, planes, tables, cs.STEP, dims)
        for launch, _conf, _passed in runs.values():
            launch()
        torch.cuda.synchronize()
        _, conf0, pass0 = runs["committed"]
        for key, (_l, conf, passed) in runs.items():
            cs.check(torch.equal(conf, conf0) and torch.equal(passed, pass0),
                     f"{phase}: variant {key} differs from the committed "
                     f"kernel")
        ms = {key: [] for key in runs}
        for key in [*runs, *reversed(runs)]:
            ms[key].append(cs.time_cuda(runs[key][0], 50))
        print(f"K3, 1080p level 0, {phase} ({tables.n_features} features), "
              f"near-median thresholds, outputs bit-equal; "
              + "; ".join(f"{key}: mean {np.mean(v):.4f} ms "
                          f"({', '.join(f'{x:.4f}' for x in v)})"
                          for key, v in ms.items())
              + f"; {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
