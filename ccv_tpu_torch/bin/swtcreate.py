"""bin/swtcreate twin on the PyTorch port:

    python -m ccv_tpu_torch.bin.swtcreate <list.txt> [--iterations 10]
        [--<field> min,step,max ...] [--device cuda|cpu]

Coordinate-descent search of the SWT parameters that maximises the
Wolf-Jolion F-score on annotated images (reference: bin/swtcreate.c).
list.txt lines: "<image-path> <truth-path>"; a truth file holds one
"x y w h" rect a line. One range flag for each SwtParams field but
scale_invariant and same_word_thresh, its name with dashes
(--low-thresh 50,25,150, --min-height ...). Prints the best parameters as
bin/swtcreate.py does. Runs SWT on the first CUDA device (the default,
which raises without one), or on the CPU with ``--device cpu``."""

import argparse
import dataclasses
import sys

from ccv_tpu_torch.bin.icfcreate import run_device

INT_FIELDS = {"size", "low_thresh", "high_thresh", "max_height",
              "min_height", "min_area", "letter_occlude_thresh",
              "letter_thresh", "intensity_thresh"}
NOT_SEARCHED = ("scale_invariant", "same_word_thresh")


def main(argv=None) -> int:
    from ccv_tpu_torch.core.io import IO_GRAY, read
    from ccv_tpu_torch.detectors import swt
    from ccv_tpu_torch.train.swt import Range, optimize_params

    ap = argparse.ArgumentParser(prog="python -m ccv_tpu_torch.bin.swtcreate",
                                 description="Search the SWT parameters.")
    ap.add_argument("list")
    ap.add_argument("--iterations", type=int, default=10)
    for f in dataclasses.fields(swt.SwtParams):
        if f.name not in NOT_SEARCHED:
            ap.add_argument(f"--{f.name.replace('_', '-')}", default=None,
                            help="min,step,max search range")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    dev = run_device(args.device)
    images, truths = [], []
    with open(args.list) as f:
        for line in f:
            parts = line.split()
            if len(parts) != 2:
                continue
            images.append(read(parts[0], IO_GRAY, device=dev).tensor)
            with open(parts[1]) as t:
                truths.append([tuple(map(int, r.split()))
                               for r in t.read().split("\n") if r])
    ranges = {}
    for f in dataclasses.fields(swt.SwtParams):
        v = getattr(args, f.name, None)
        if isinstance(v, str):
            lo, step, hi = (float(t) for t in v.split(","))
            ranges[f.name] = Range(lo, step, hi)
    print(f"{len(images)} images; searching {sorted(ranges)}")
    best = optimize_params(images, truths, ranges,
                           iterations=args.iterations,
                           integer_fields=tuple(INT_FIELDS), device=dev)
    print("best params:")
    for f in dataclasses.fields(swt.SwtParams):
        print(f"  {f.name} = {getattr(best, f.name)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
