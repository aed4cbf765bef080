"""bin/icfoptimize twin on the PyTorch port:

    python -m ccv_tpu_torch.bin.icfoptimize <cascade.icf> <validates-dir>
        <out.icf> [--accept 0.98] [--device cuda|cpu]

Tightens the soft-cascade thresholds so that the given fraction of the
validation positives (images resized to the cascade's size) survives
every prefix (reference: bin/icfoptimize.c +
ccv_icf_classifier_cascade_soft). Runs the trees on the first CUDA device
(the default, which raises without one), or on the CPU with
``--device cpu``."""

import argparse
import sys

from ccv_tpu_torch.bin.icfcreate import load_dir, run_device


def main(argv=None) -> int:
    from ccv_tpu_torch.detectors import icf
    from ccv_tpu_torch.train import icf as train_icf

    ap = argparse.ArgumentParser(
        prog="python -m ccv_tpu_torch.bin.icfoptimize",
        description="Tighten an ICF cascade's soft thresholds.")
    ap.add_argument("cascade")
    ap.add_argument("validates")
    ap.add_argument("output")
    ap.add_argument("--accept", type=float, default=0.98)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    dev = run_device(args.device)
    cas = icf.load_cascade(args.cascade)
    vals = load_dir(args.validates, (cas.width, cas.height))
    train_icf.optimize_soft_cascade(cas, vals, args.accept, dev)
    train_icf.write_cascade(cas, args.output)
    print(f"optimized thresholds at {args.accept:.2%} acceptance"
          f" -> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
