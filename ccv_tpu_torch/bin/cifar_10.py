"""bin/cifar-10 twin: trains the reference's CIFAR-10 convnet (bin/cifar-10.c's
layer stack) with ccv_convnet_supervised_train's semantics, on the card.

    python -m ccv_tpu_torch.bin.cifar_10 <train.npz> <test.npz> <out.sqlite3>
        [epochs] [--device cpu]

The npz files hold x (N, 31, 31, 3) uint8 and y (N,) int. With fewer
arguments it runs a short self-test on seeded synthetic data and writes its
net to ``cifar10_selftest.sqlite3`` in the temporary directory. Published
settings: mini-batch 128, learn rate 5e-4, momentum 0.9, decay 5e-4, random
flips. Runs on the first CUDA device unless ``--device`` says otherwise.
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import Optional, Sequence

import numpy as np

from ccv_tpu_torch import device as _device
from ccv_tpu_torch.models.convnet import (AVERAGE_POOL, CONVOLUTIONAL,
                                          FULL_CONNECT, LOCAL_RESPONSE_NORM,
                                          MAX_POOL, Convnet, ConvnetLayer,
                                          ConvnetTrainParams,
                                          supervised_train)


def cifar10_net(seed: int = 0, device: _device.DeviceLike = None) -> Convnet:
    """bin/cifar-10.c's net at its 31 x 31 geometry (every 3 / 2 pool
    divides evenly), weights drawn as bin/cifar-10.py draws them."""
    rng = np.random.default_rng(seed)

    def conv(ir, ic, cin, count, k, border):
        return ConvnetLayer(
            type=CONVOLUTIONAL, in_rows=ir, in_cols=ic, in_channels=cin,
            in_partition=1, node_count=0, rows=k, cols=k, channels=cin,
            partition=1, count=count, strides=1, border=border,
            w=rng.normal(0, 0.05, (count, k, k, cin)).astype(np.float32),
            bias=np.zeros(count, np.float32))

    def pool(t, ir, ic, cin, size, strides):
        return ConvnetLayer(type=t, in_rows=ir, in_cols=ic, in_channels=cin,
                            in_partition=1, node_count=0, size=size,
                            strides=strides, border=0)

    def lrn(ir, ic, cin):
        return ConvnetLayer(type=LOCAL_RESPONSE_NORM, in_rows=ir, in_cols=ic,
                            in_channels=cin, in_partition=1, node_count=0,
                            size=3, kappa=1.0, alpha=1e-4, beta=0.75)

    layers = [
        conv(31, 31, 3, 32, 5, 2), lrn(31, 31, 32),
        pool(MAX_POOL, 31, 31, 32, 3, 2),
        conv(15, 15, 32, 32, 5, 2), lrn(15, 15, 32),
        pool(AVERAGE_POOL, 15, 15, 32, 3, 2),
        conv(7, 7, 32, 64, 5, 2),
        pool(AVERAGE_POOL, 7, 7, 64, 3, 2),
        ConvnetLayer(type=FULL_CONNECT, in_rows=3, in_cols=3, in_channels=64,
                     in_partition=1, node_count=3 * 3 * 64, count=10, relu=0,
                     w=rng.normal(0, 0.05, (10, 576)).astype(np.float32),
                     bias=np.zeros(10, np.float32)),
    ]
    return Convnet(layers, (31, 31), device=device)


def published_params(epochs: int) -> ConvnetTrainParams:
    return ConvnetTrainParams(max_epoch=epochs, mini_batch=128,
                              learn_rate=5e-4, momentum=0.9, decay=5e-4,
                              symmetric=True)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("args", nargs="*",
                    help="train.npz test.npz out.sqlite3 [epochs]")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA device)")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)
    if len(args.args) >= 3:
        tr, te = np.load(args.args[0]), np.load(args.args[1])
        out = args.args[2]
        epochs = int(args.args[3]) if len(args.args) > 3 else 20
        xtr, ytr, xte, yte = tr["x"], tr["y"], te["x"], te["y"]
    else:
        print("(no dataset given: synthetic self-test)")
        rng = np.random.default_rng(0)
        xtr = rng.integers(0, 256, (256, 31, 31, 3), dtype=np.uint8)
        ytr = (xtr.mean(axis=(1, 2, 3)) > 127.5).astype(np.int32)
        xte, yte = xtr[:64], ytr[:64]
        out = os.path.join(tempfile.gettempdir(),
                           "cifar10_selftest.sqlite3")
        epochs = 2
    net = cifar10_net(device=dev)
    hist = supervised_train(net, xtr, ytr, published_params(epochs),
                            filename=out, tests=(xte, yte))
    for e, (loss, acc) in enumerate(hist):
        print(f"epoch {e + 1}: loss {loss:.4f}"
              + (f", test acc {acc:.3f}" if acc is not None else ""))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
