"""bin/icfcreate twin on the PyTorch port:

    python -m ccv_tpu_torch.bin.icfcreate <positives-dir> <negatives-dir>
        <out.icf> [--size W H] [--feature-size N] [--weak-classifier N]
        [--device cuda|cpu]

Trains an ICF detector (discrete AdaBoost over depth-2 trees of random
integral-channel features; reference: bin/icfcreate.c +
ccv_icf_classifier_cascade_new) and writes it in the text format
``icfdetect`` reads. Positives are images resized to the patch size by
INTER_AREA; negatives are 8 random crops an image. Any format
``core.io.read`` decodes (PNG, JPEG, BMP, ...). Trains on the first CUDA
device (the default, which raises without one), or on the CPU with
``--device cpu``."""

import argparse
import os
import sys

import numpy as np
import torch

from ccv_tpu_torch import device
from ccv_tpu_torch.core.io import IO_RGB_COLOR, read
from ccv_tpu_torch.ops import resample

EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp")


def load_dir(path, size, crop=False, per_image=8, seed=0,
             flags=IO_RGB_COLOR, device="cpu") -> np.ndarray:
    """(N, H, W, 3) uint8 patches (with ``flags`` IO_GRAY: (N, H, W)) of
    ``size`` (W, H) from the images of ``path`` in name order: each
    resized (INTER_AREA, on ``device``), or with ``crop`` ``per_image``
    random crops of each (images no larger than the patch give none),
    drawn as ccv_tpu's tools draw them."""
    rng = np.random.default_rng(seed)
    W, H = size
    out = []
    for name in sorted(os.listdir(path)):
        if not name.lower().endswith(EXTENSIONS):
            continue
        img = read(os.path.join(path, name), flags, device="cpu").numpy()
        if crop:
            for _ in range(per_image):
                if img.shape[0] <= H or img.shape[1] <= W:
                    break
                y = rng.integers(0, img.shape[0] - H)
                x = rng.integers(0, img.shape[1] - W)
                out.append(img[y:y + H, x:x + W])
        else:
            if img.shape[:2] != (H, W):
                img = resample.resample(
                    torch.from_numpy(img).to(device), rows=H, cols=W,
                    rows_scale=H / img.shape[0], cols_scale=W / img.shape[1],
                    interp=resample.INTER_AREA).cpu().numpy().astype(np.uint8)
            out.append(img)
    return np.stack(out)


def run_device(name: str) -> torch.device:
    """The ``--device`` choice: the first card (raises without one) or the
    CPU."""
    return (device.default_device() if name == "cuda"
            else device.resolve("cpu"))


def main(argv=None) -> int:
    from ccv_tpu_torch.train import icf as train_icf

    ap = argparse.ArgumentParser(prog="python -m ccv_tpu_torch.bin.icfcreate",
                                 description="Train an ICF cascade.")
    ap.add_argument("positives")
    ap.add_argument("negatives")
    ap.add_argument("output")
    ap.add_argument("--size", type=int, nargs=2, default=(30, 60))
    ap.add_argument("--feature-size", type=int, default=2000)
    ap.add_argument("--weak-classifier", type=int, default=64)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    dev = run_device(args.device)
    size = tuple(args.size)
    pos = load_dir(args.positives, size)
    neg = load_dir(args.negatives, size, crop=True)
    print(f"{len(pos)} positives, {len(neg)} negative patches")
    params = train_icf.IcfTrainParams(
        size=size, feature_size=args.feature_size,
        weak_classifier=args.weak_classifier)
    cascade = train_icf.train_cascade(pos, neg, params, dev)
    train_icf.write_cascade(cascade, args.output)
    print(f"wrote {cascade.n_weak}-weak ICF cascade to {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
