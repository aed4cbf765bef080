"""bin/scdcreate twin on the PyTorch port:

    python -m ccv_tpu_torch.bin.scdcreate <positives-dir> <negatives-dir>
        <out.sqlite3> [--size W H] [--boosting N] [--max-feature N]
        [--hit-rate R] [--device cuda|cpu]

Trains an SCD (SURF-cascade) detector with gentle AdaBoost (reference:
bin/scdcreate.c + ccv_scd_classifier_cascade_new) and writes the SQLite
cascade ``scddetect`` reads. Positives are images resized to the patch
size by INTER_AREA; negatives are 8 random crops an image (``icfcreate``'s
loader). Trains on the first CUDA device (the default, which raises
without one), or on the CPU with ``--device cpu``."""

import argparse
import sys

from ccv_tpu_torch.bin.icfcreate import load_dir, run_device


def main(argv=None) -> int:
    from ccv_tpu_torch.train import scd as train_scd

    ap = argparse.ArgumentParser(prog="python -m ccv_tpu_torch.bin.scdcreate",
                                 description="Train an SCD cascade.")
    ap.add_argument("positives")
    ap.add_argument("negatives")
    ap.add_argument("output")
    ap.add_argument("--size", type=int, nargs=2, default=(40, 40))
    ap.add_argument("--boosting", type=int, default=4)
    ap.add_argument("--max-feature", type=int, default=16)
    ap.add_argument("--hit-rate", type=float, default=0.995)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    dev = run_device(args.device)
    size = tuple(args.size)
    pos = load_dir(args.positives, size)
    neg = load_dir(args.negatives, size, crop=True)
    print(f"{len(pos)} positives, {len(neg)} negative patches")
    params = train_scd.ScdTrainParams(
        size=size, boosting=args.boosting, maximum_feature=args.max_feature,
        hit_rate=args.hit_rate)
    cascade = train_scd.train_cascade(pos, neg, params, dev)
    train_scd.write_cascade(cascade, args.output)
    print(f"wrote {cascade.n_stages}-stage cascade"
          f" ({cascade.n_features} features) to {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
