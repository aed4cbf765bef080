"""bin/imdb_lstm.py twin: the LSTM sentiment classifier, on the card
(reference: bin/nnc/imdb_lstm.c: embedding, LSTM, a dense head).

    python -m ccv_tpu_torch.bin.imdb_lstm --demo [--device cpu]
    python -m ccv_tpu_torch.bin.imdb_lstm --train pos.txt neg.txt \\
        --vocab vocab.txt

A ``Sequential`` of Embedding, LSTM, the mean over time and Dense(2),
trained through ``compile(adam, "softmax_crossentropy")`` and ``fit``, on
the corpus of ``bin_imdb_shared`` (the same ids, pads and synthetic corpus
as ``bin/imdb_lstm.py``). Runs on the first CUDA device unless
``--device`` says otherwise.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ccv_tpu_torch import device as _device
from ccv_tpu_torch.bin.bin_imdb_shared import load_corpus
from ccv_tpu_torch.nn import layers, optimizers
from ccv_tpu_torch.nn.model import Sequential


def build(vocab_size: int, dim: int, batch: int, max_len: int, lr: float,
          device: torch.device) -> Sequential:
    """The classifier, built on ``device`` from seed 0 and compiled."""
    net = Sequential([
        layers.Embedding(vocab_size, dim),
        layers.LSTM(dim),
        layers._Stateless(lambda x: x.mean(dim=1),
                          shape_fn=lambda s: (s[0], s[2]), name="meanpool"),
        layers.Dense(2),
    ])
    net.build((batch, max_len), torch.Generator().manual_seed(0), device)
    net.compile(optimizers.adam(rate=lr), "softmax_crossentropy")
    return net


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--train", nargs=2, metavar=("POS", "NEG"))
    ap.add_argument("--vocab")
    ap.add_argument("--demo", action="store_true")
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA device)")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> float:
    """Trains as ``bin/imdb_lstm.py``; returns the last accuracy read."""
    args = parser().parse_args(argv)
    dev = _device.resolve(args.device)
    xs, ys, vocab_size, _pad = load_corpus(args)
    net = build(vocab_size, args.dim, args.batch, args.max_len, args.lr, dev)
    rng = np.random.default_rng(0)
    n = len(xs)
    t0 = time.time()
    it = 0
    loss = acc = 0.0
    for epoch in range(args.epochs):
        order = rng.permutation(n)
        for i in range(0, n - args.batch + 1, args.batch):
            sel = order[i:i + args.batch]
            x = _device.to_device(xs[sel].astype(np.int64), dev)
            y = _device.to_device(ys[sel].astype(np.int64), dev)
            loss = net.fit(x, y)
            it += 1
            if it % 10 == 0:
                acc = float((net.evaluate(x).argmax(-1) == y).float().mean())
                print(f"epoch {epoch} iter {it}: loss {loss:.4f} "
                      f"acc {acc:.3f} "
                      f"({(time.time() - t0) / it * 1000:.0f} ms/iter)")
    print(f"final: loss {loss:.4f} acc {acc:.3f}")
    return acc


if __name__ == "__main__":
    main()
