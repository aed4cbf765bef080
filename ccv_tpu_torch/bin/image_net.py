"""bin/image-net twin: trains the reference's MattNet-C ImageNet convnet
(bin/image-net.c with bin/matt_models.inc's matt_c_params) with
ccv_convnet_supervised_train's semantics (SGD with momentum and decay, the
working file saved every epoch), on the card.

    python -m ccv_tpu_torch.bin.image_net --train-list train.txt \\
        --test-list test.txt --working-dir dir [--max-epoch 100] \\
        [--scale 1.0] [--device cpu]

List lines: ``<label> <image-path>``; images are read as RGB and resized to
the net's input by INTER_AREA on the device. ``--self-test`` runs a tiny
seeded end-to-end check instead (a scaled-down net, random data). Runs on
the first CUDA device unless ``--device`` says otherwise.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch

from ccv_tpu_torch import device as _device
from ccv_tpu_torch.core.io import IO_RGB_COLOR, read
from ccv_tpu_torch.models.convnet import (CONVOLUTIONAL, FULL_CONNECT,
                                          LOCAL_RESPONSE_NORM, MAX_POOL,
                                          Convnet, ConvnetLayer,
                                          ConvnetTrainParams,
                                          supervised_train)
from ccv_tpu_torch.ops import resample


def matt_c_net(num_classes: int = 1000, scale: float = 1.0,
               input_size: int = 225, seed: int = 0,
               device: _device.DeviceLike = None) -> Convnet:
    """matt_models.inc matt_c_params twin: 7 convolutions (four of them in
    2 partitions, as the 4-GPU model-parallel original split them) and 3
    full-connect layers, weights drawn as bin/image-net.py draws them;
    ``scale`` multiplies the channel widths (at least 8)."""
    rng = np.random.default_rng(seed)

    def ch(n):
        return max(int(n * scale), 8)

    def conv(ir, ic, cin, count, k, border, strides=1, parts=1):
        std = np.sqrt(2.0) / np.sqrt(k * k * cin / parts)
        return ConvnetLayer(
            type=CONVOLUTIONAL, in_rows=ir, in_cols=ic, in_channels=cin,
            in_partition=parts, node_count=0, rows=k, cols=k,
            channels=cin, partition=parts, count=count, strides=strides,
            border=border,
            w=rng.normal(0, std, (count, k, k, cin // parts))
            .astype(np.float32),
            bias=np.zeros(count, np.float32))

    def pool(ir, ic, cin, size=3, strides=2):
        return ConvnetLayer(type=MAX_POOL, in_rows=ir, in_cols=ic,
                            in_channels=cin, in_partition=1, node_count=0,
                            size=size, strides=strides, border=0)

    def lrn(ir, ic, cin, parts=1):
        return ConvnetLayer(type=LOCAL_RESPONSE_NORM, in_rows=ir,
                            in_cols=ic, in_channels=cin, in_partition=parts,
                            node_count=0, size=5, kappa=2.0, alpha=1e-4,
                            beta=0.75)

    def fc(nin, nout, relu=True):
        std = 1.0 / np.sqrt(nin)
        return ConvnetLayer(type=FULL_CONNECT, in_rows=1, in_cols=1,
                            in_channels=nin, in_partition=1, node_count=nin,
                            count=nout, relu=relu,
                            w=rng.normal(0, std, (nout, nin))
                            .astype(np.float32),
                            bias=np.zeros(nout, np.float32))

    s = input_size
    s1 = (s + 2 - 7) // 2 + 1                     # conv1 stride 2, border 1
    p1 = (s1 - 3 + 1) // 2 + 1                    # the pools ceil
    p2 = (p1 - 3 + 1) // 2 + 1
    p3 = (p2 - 3 + 1) // 2 + 1
    p4 = (p3 - 3 + 1) // 2 + 1
    layers = [
        conv(s, s, 3, ch(128), 7, 1, strides=2, parts=1),
        lrn(s1, s1, ch(128), parts=2),
        pool(s1, s1, ch(128)),
        conv(p1, p1, ch(128), ch(384), 3, 1, parts=2),
        lrn(p1, p1, ch(384), parts=2),
        pool(p1, p1, ch(384)),
        conv(p2, p2, ch(384), ch(512), 3, 1),
        conv(p2, p2, ch(512), ch(512), 3, 1, parts=2),
        conv(p2, p2, ch(512), ch(512), 3, 1, parts=2),
        pool(p2, p2, ch(512)),
        conv(p3, p3, ch(512), ch(512), 3, 1),
        conv(p3, p3, ch(512), ch(512), 3, 1, parts=2),
        pool(p3, p3, ch(512)),
        fc(p4 * p4 * ch(512), ch(4096)),
        fc(ch(4096), ch(4096)),
        fc(ch(4096), num_classes, relu=False),
    ]
    return Convnet(layers, (s, s), device=device)


def _load_list(path: str, size: int, device: _device.DeviceLike = None):
    """(images (N, size, size, 3) uint8, labels (N,) int64) of a list file,
    each image read as RGB on ``device`` and, where it is not size x size,
    resized by INTER_AREA there in float32 and clipped back to uint8."""
    dev = _device.resolve(device)
    xs, ys = [], []
    with open(path) as f:
        lines = f.read().splitlines()
    for line in lines:
        parts = line.split()
        if len(parts) < 2:
            continue
        label, p = int(parts[0]), parts[1]
        img = read(p, IO_RGB_COLOR, device=dev).tensor
        if tuple(img.shape[:2]) != (size, size):
            img = resample.resample(
                img.to(torch.float32), rows=size, cols=size,
                rows_scale=size / img.shape[0],
                cols_scale=size / img.shape[1], interp=resample.INTER_AREA)
        xs.append(torch.clamp(img, 0, 255).to(torch.uint8).cpu().numpy())
        ys.append(label)
    return np.stack(xs), np.array(ys, np.int64)


def self_test(learn_rate: float, device: _device.DeviceLike = None):
    """bin/image-net.py --self-test: MattNet-C at 4 classes, scale 0.08, 33
    x 33, 3 epochs over 32 seeded images in batches of 8; returns the
    history."""
    net = matt_c_net(num_classes=4, scale=0.08, input_size=33, seed=0,
                     device=device)
    rng = np.random.default_rng(0)
    X = rng.integers(0, 255, (32, 33, 33, 3)).astype(np.uint8)
    Y = rng.integers(0, 4, (32,))
    return supervised_train(
        net, X, Y, ConvnetTrainParams(max_epoch=3, mini_batch=8,
                                      learn_rate=learn_rate))


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--train-list")
    ap.add_argument("--test-list")
    ap.add_argument("--working-dir", default=".")
    ap.add_argument("--max-epoch", type=int, default=100)
    ap.add_argument("--mini-batch", type=int, default=64)
    ap.add_argument("--learn-rate", type=float, default=0.01)
    ap.add_argument("--scale", type=float, default=1.0,
                    help="channel-width multiplier (for small machines)")
    ap.add_argument("--num-classes", type=int, default=1000)
    ap.add_argument("--self-test", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA device)")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)
    if args.self_test:
        hist = self_test(args.learn_rate, dev)
        print(f"self-test losses: {[round(h[0], 3) for h in hist]}")
        return 0
    if not args.train_list:
        ap.error("--train-list is required (or --self-test)")
    net = matt_c_net(num_classes=args.num_classes, scale=args.scale,
                     device=dev)
    X, Y = _load_list(args.train_list, net.rows, dev)
    tests = (_load_list(args.test_list, net.rows, dev) if args.test_list
             else None)
    os.makedirs(args.working_dir, exist_ok=True)
    out = os.path.join(args.working_dir, "image-net.sqlite3")
    hist = supervised_train(
        net, X, Y, ConvnetTrainParams(max_epoch=args.max_epoch,
                                      mini_batch=args.mini_batch,
                                      learn_rate=args.learn_rate),
        filename=out, tests=tests)
    print(f"trained {len(hist)} epochs; model at {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
