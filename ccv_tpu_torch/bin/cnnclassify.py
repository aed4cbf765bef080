"""bin/cnnclassify twin: classify an image with a convnet, on the card.

    python -m ccv_tpu_torch.bin.cnnclassify <image> <model.sqlite3>
        [--device cpu]

The model is either a reference ccv_convnet SQLite file (layer_params /
layer_data schema, ccv_convnet.c:1412: the 10-patch protocol) or a VGG-D
checkpoint in the tensors schema (``Sequential.write``, as ``ccv_tpu``
writes it: the center patch), told apart by its tables. Prints the top 5
as ``<class id + 1> <confidence>`` joined by `` | ``, then the
classification's milliseconds, like the reference tool. A model that fails
to load raises: there are no random weights to fall back on. Runs on the
first CUDA device unless ``--device`` says otherwise.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional, Sequence, Tuple

import torch

from ccv_tpu_torch import device as _device
from ccv_tpu_torch.core.io import IO_RGB_COLOR, read
from ccv_tpu_torch.models import convnet, vgg


def classify(image_path: str, model_path: str,
             device: _device.DeviceLike = None
             ) -> Tuple[List[Tuple[int, float]], float]:
    """([(class id, confidence)] of the top 5, milliseconds of the
    classification itself, image and model loads left out)."""
    dev = _device.resolve(device)
    image = read(image_path, IO_RGB_COLOR, device=dev).tensor
    if convnet.is_convnet_file(model_path):
        net = convnet.Convnet.read(model_path, device=dev)
        t0 = time.perf_counter()
        ranks = net.classify(image, tops=5)
    else:
        model = vgg.vgg_d()
        model.build((1, 224, 224, 3), device=dev)
        model.read(model_path)  # raises on failure: no silent fallback
        t0 = time.perf_counter()
        idx, probs = vgg.classify(model, image)
        ranks = [(int(i), float(p))
                 for i, p in zip(idx[0].tolist(), probs[0].tolist())]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return ranks, (time.perf_counter() - t0) * 1000


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("image")
    ap.add_argument("model")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA device)")
    args = ap.parse_args(argv)
    ranks, ms = classify(args.image, args.model, args.device)
    parts = [f"{i + 1} {c:.6f}" for i, c in ranks]
    print(f"{' | '.join(parts)} | {int(ms)}ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
