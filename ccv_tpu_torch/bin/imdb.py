"""bin/imdb.py twin: the transformer-encoder sentiment classifier, on the
card (reference: bin/nnc/imdb.c: a vocab file and tokenized reviews, the
encoder classifier trained with Adam).

    python -m ccv_tpu_torch.bin.imdb --train pos.txt neg.txt \\
        --vocab vocab.txt [--epochs 2] [--device cpu]
    python -m ccv_tpu_torch.bin.imdb --demo   # synthetic separable corpus

One whitespace-tokenized review per line; the last four vocab ids are
reserved as in the reference (unk/beg/end/pad). Runs on the first CUDA
device unless ``--device`` says otherwise. Every step masks the pads, so
attention takes the plain SDPA (the flash kernels take no key mask).
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ccv_tpu_torch import device as _device
from ccv_tpu_torch.bin.bin_imdb_shared import load_corpus
from ccv_tpu_torch.models import transformer as tfm
from ccv_tpu_torch.nn import optimizers


def classifier_step(params, opt: optimizers.Optimizer, state,
                    cfg: tfm.TransformerConfig, ids: torch.Tensor,
                    labels: torch.Tensor, pad_id: int,
                    key: Optional[torch.Generator]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step: NLL of log_softmax(logits in float32), backward, Adam in
    place. Returns (loss, accuracy of the batch), not synchronised."""
    ps = optimizers.leaves(params)
    for p in ps:
        p.grad = None
    logits = tfm.encoder_classifier_forward(params, cfg, ids,
                                            src_mask=ids != pad_id,
                                            train=True, key=key)
    logp = torch.log_softmax(logits.float(), -1)
    nll = -logp.gather(1, labels[:, None]).mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    nll.backward()
    opt.update([p.grad for p in ps], state, ps)
    return nll.detach(), acc


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--train", nargs=2, metavar=("POS", "NEG"))
    ap.add_argument("--vocab")
    ap.add_argument("--demo", action="store_true")
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA device)")
    return ap


def train(args: argparse.Namespace) -> Dict:
    """Trains as the CLI does; returns the last step's loss and accuracy,
    the steps taken, the mean ms a step (host clock, ending in a
    synchronising read), and the parameters and config."""
    dev = _device.resolve(args.device)
    rng = np.random.default_rng(0)
    xs, ys, vocab_size, pad_id = load_corpus(args)
    cfg = tfm.TransformerConfig(
        vocab_size=vocab_size, layers=args.layers, heads=args.heads,
        head_dim=args.dim // args.heads, ff=4 * args.dim,
        max_len=args.max_len, dropout=0.1, dtype=torch.bfloat16)
    params = tfm.init_encoder_classifier(
        torch.Generator(device=dev).manual_seed(0), cfg, 2)
    opt = optimizers.adam(rate=args.lr)
    state = opt.init(params)

    key = torch.Generator(device=dev).manual_seed(1)
    n = len(xs)
    t0 = time.time()
    it = 0
    loss = acc = None
    for epoch in range(args.epochs):
        order = rng.permutation(n)
        for i in range(0, n - args.batch + 1, args.batch):
            sel = order[i:i + args.batch]
            ids = _device.to_device(xs[sel].astype(np.int64), dev)
            labels = _device.to_device(ys[sel].astype(np.int64), dev)
            loss, acc = classifier_step(params, opt, state, cfg, ids, labels,
                                        pad_id, key)
            it += 1
            if it % 10 == 0:
                print(f"epoch {epoch} iter {it}: loss {float(loss):.4f} "
                      f"acc {float(acc):.3f} "
                      f"({(time.time() - t0) / it * 1000:.0f} ms/iter)")
    loss, acc = float(loss), float(acc)
    return {"loss": loss, "acc": acc, "iters": it,
            "ms_per_iter": (time.time() - t0) / it * 1000,
            "params": params, "cfg": cfg}


def main(argv: Optional[Sequence[str]] = None) -> float:
    res = train(parser().parse_args(argv))
    print(f"final: loss {res['loss']:.4f} acc {res['acc']:.3f}")
    return res["acc"]


if __name__ == "__main__":
    main()
