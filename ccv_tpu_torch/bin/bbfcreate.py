"""bin/bbfcreate twin on the PyTorch port:

    python -m ccv_tpu_torch.bin.bbfcreate <positives-dir> <negatives-dir>
        <out-dir> [--size W H] [--stages N] [--features-per-stage N]
        [--device cuda|cpu]

Trains a BBF face-detector cascade (genetic feature search and AdaBoost;
reference: bin/bbfcreate.c + ccv_bbf_classifier_cascade_new) and writes
cascade.txt and stage-N.txt into the output directory, which ``bbfdetect``
reads. Positives are gray images resized to the patch size by INTER_AREA
(on the training device); negatives are 8 random crops an image, drawn as
``ccv_tpu``'s tool draws them (``icfcreate.load_dir`` with IO_GRAY). Trains
on the first CUDA device (the default, which raises without one), or on
the CPU with ``--device cpu``."""

import argparse
import sys

from ccv_tpu_torch.bin.icfcreate import load_dir, run_device
from ccv_tpu_torch.core.io import IO_GRAY


def main(argv=None) -> int:
    from ccv_tpu_torch.train import bbf as train_bbf

    ap = argparse.ArgumentParser(prog="python -m ccv_tpu_torch.bin.bbfcreate",
                                 description="Train a BBF cascade.")
    ap.add_argument("positives")
    ap.add_argument("negatives")
    ap.add_argument("output")
    ap.add_argument("--size", type=int, nargs=2, default=(24, 24))
    ap.add_argument("--stages", type=int, default=8)
    ap.add_argument("--features-per-stage", type=int, default=32)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    dev = run_device(args.device)
    size = tuple(args.size)
    pos = load_dir(args.positives, size, flags=IO_GRAY, device=dev)
    neg = load_dir(args.negatives, size, crop=True, flags=IO_GRAY)
    print(f"{len(pos)} positives, {len(neg)} negative patches")
    params = train_bbf.BbfTrainParams(
        size=size, n_stages=args.stages,
        max_features_per_stage=args.features_per_stage)
    cas = train_bbf.train_cascade(pos, neg, params, dev)
    train_bbf.write_cascade(cas, args.output)
    print(f"wrote {cas.n_stages}-stage BBF cascade to {args.output}/")
    return 0


if __name__ == "__main__":
    sys.exit(main())
