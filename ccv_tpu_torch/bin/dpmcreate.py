"""bin/dpmcreate twin on the PyTorch port:

    python -m ccv_tpu_torch.bin.dpmcreate --positive-list pos.txt
        --background-list bg.txt --negative-count 200 --working-dir dir
        [--model-component 1] [--model-part 8] [--device cuda|cpu] ...

Trains a DPM mixture model (a latent SVM over 31-channel HOG root and part
filters with hard-negative mining; reference: bin/dpmcreate.c +
ccv_dpm_mixture_model_new). The positive list has one
"path x y width height" line an example; the background list one path a
line. Checkpoints land in the working directory as the reference writes
them (model, init.model, gradient_descent_progress), and training resumes
from them. Trains on the first CUDA device (the default, which raises
without one), or on the CPU with ``--device cpu``."""

import argparse
import sys

from ccv_tpu_torch.bin.icfcreate import run_device


def read_lists(positive_list, background_list):
    """(positive paths, their (x, y, w, h) boxes, background paths)."""
    posimgs, bboxes = [], []
    with open(positive_list) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 5:
                continue
            posimgs.append(parts[0])
            bboxes.append(tuple(int(v) for v in parts[1:5]))
    with open(background_list) as f:
        bgimgs = [line.strip() for line in f if line.strip()]
    return posimgs, bboxes, bgimgs


def main(argv=None) -> int:
    from ccv_tpu_torch.train import dpm as train_dpm

    ap = argparse.ArgumentParser(prog="python -m ccv_tpu_torch.bin.dpmcreate",
                                 description="Train a DPM mixture model.")
    ap.add_argument("--positive-list", required=True)
    ap.add_argument("--background-list", required=True)
    ap.add_argument("--working-dir", required=True)
    ap.add_argument("--negative-count", type=int, required=True)
    ap.add_argument("--model-component", type=int, default=1)
    ap.add_argument("--model-part", type=int, default=8)
    ap.add_argument("--symmetric", type=int, default=1)
    ap.add_argument("--iterations", type=int, default=1000)
    ap.add_argument("--relabels", type=int, default=10)
    ap.add_argument("--data-minings", type=int, default=50)
    ap.add_argument("--alpha", type=float, default=0.01)
    ap.add_argument("--alpha-ratio", type=float, default=0.995)
    ap.add_argument("--balance", type=float, default=1.5)
    ap.add_argument("--negative-cache-size", type=int, default=2000)
    ap.add_argument("--c", dest="C", type=float, default=0.002)
    ap.add_argument("--include-overlap", type=float, default=0.7)
    ap.add_argument("--grayscale", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    dev = run_device(args.device)
    posimgs, bboxes, bgimgs = read_lists(args.positive_list,
                                         args.background_list)
    print(f"{len(posimgs)} positives, {len(bgimgs)} backgrounds")
    params = train_dpm.DpmTrainParams(
        components=args.model_component, parts=args.model_part,
        symmetric=bool(args.symmetric), iterations=args.iterations,
        relabels=args.relabels, data_minings=args.data_minings,
        alpha=args.alpha, alpha_ratio=args.alpha_ratio,
        balance=args.balance, negative_cache_size=args.negative_cache_size,
        C=args.C, include_overlap=args.include_overlap,
        grayscale=bool(args.grayscale))
    train_dpm.mixture_model_new(posimgs, bboxes, bgimgs,
                                args.negative_count, args.working_dir,
                                params, device=dev)
    print(f"model written to {args.working_dir}/model")
    return 0


if __name__ == "__main__":
    sys.exit(main())
