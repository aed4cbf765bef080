"""bin/iwslt.py twin: the encoder-decoder transformer on IWSLT-style paired
text, on the card (reference: bin/nnc/iwslt.c). Same data format as wmt
(``ccv_tpu_torch.bin.wmt``), with the tool's own features:

* the Noam warm-up learning rate (iwslt.c:774:
  lr = 1/sqrt(d_model) * min(1/sqrt(step), step / warmup^1.5));
* gradient accumulation over ``--big-step`` micro-batches before the
  optimizer step (iwslt.c's big_step loop);
* greedy autoregressive decoding of a test file after training
  (iwslt.c eval_wmt:288-419).

    python -m ccv_tpu_torch.bin.iwslt --src s.txt --tgt t.txt \\
        --src-vocab sv --tgt-vocab tv --tst x.txt [--device cpu]
    python -m ccv_tpu_torch.bin.iwslt --demo   # copy task + greedy decode

Runs on the first CUDA device unless ``--device`` says otherwise.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ccv_tpu_torch import device as _device
from ccv_tpu_torch.bin.wmt import (batch_on, encode, load_vocab, read_pairs,
                                   seq2seq_loss, synthetic_pairs)
from ccv_tpu_torch.models import transformer as tfm
from ccv_tpu_torch.nn import optimizers


def noam_lr(step: int, d_model: int, warmup: int) -> float:
    """iwslt.c:774 learning-rate schedule."""
    s = max(step, 1)
    return (1.0 / np.sqrt(d_model)
            * min(1.0 / np.sqrt(s), s / (np.sqrt(warmup) * warmup)))


@torch.no_grad()
def greedy_decode(params, cfg: tfm.TransformerConfig, src_b: torch.Tensor,
                  spad: int, tpad: int, max_len: int) -> np.ndarray:
    """eval_wmt (iwslt.c:288): feed the argmax token back until every row
    has emitted end. Each step runs the whole encoder_decoder_forward again,
    the encoder included, as ccv_tpu does. Returns (B, max_len) token ids:
    beg, the chosen tokens, and pad after a row's end."""
    B = src_b.shape[0]
    tv = cfg.tgt_vocab_size or cfg.vocab_size
    beg, end = tv - 3, tv - 2
    src_mask = src_b != spad
    tgt = torch.full((B, max_len), tpad, dtype=torch.int64,
                     device=src_b.device)
    tgt[:, 0] = beg
    done = torch.zeros(B, dtype=torch.bool, device=src_b.device)
    for t in range(1, max_len):
        logits = tfm.encoder_decoder_forward(params, cfg, src_b, tgt,
                                             src_mask=src_mask)
        nxt = logits[:, t - 1].argmax(-1)
        tgt[:, t] = torch.where(done, tpad, nxt)
        done |= nxt == end
        if bool(done.all()):
            break
    return tgt.cpu().numpy().astype(np.int32)


class Accumulator:
    """iwslt's optimizer step: the gradients of ``big`` micro-batches are
    summed (autograd adds into ``.grad``), divided by ``big``, and Adam
    (beta2 0.98, epsilon 1e-9) applies them at the Noam rate of its step."""

    def __init__(self, params, big: int, d_model: int, warmup: int):
        self.params = optimizers.leaves(params)
        self.big, self.d_model, self.warmup = big, d_model, warmup
        self.opt = optimizers.adam(rate=1.0, beta1=0.9, beta2=0.98,
                                   epsilon=1e-9)
        self.state = self.opt.init(self.params)
        self.micro = 0
        self.steps = 0

    def backward(self, loss: torch.Tensor) -> None:
        """Adds one micro-batch's gradients; every ``big``-th call applies
        their mean and zeroes them."""
        loss.backward()
        self.micro += 1
        if self.micro % self.big:
            return
        self.steps += 1
        lr = noam_lr(self.steps, self.d_model, self.warmup)
        grads = [p.grad / self.big for p in self.params]
        self.opt.update(grads, self.state, self.params, rate=float(lr))
        for p in self.params:
            p.grad = None


def main(argv: Optional[Sequence[str]] = None) -> float:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src")
    ap.add_argument("--tgt")
    ap.add_argument("--src-vocab")
    ap.add_argument("--tgt-vocab")
    ap.add_argument("--tst", help="test file to greedy-decode after training")
    ap.add_argument("--demo", action="store_true")
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--big-step", type=int, default=4,
                    help="gradient-accumulation micro-batches (iwslt.c)")
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--dim", type=int, default=512)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--ff", type=int, default=2048)
    ap.add_argument("--warmup", type=int, default=4000)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA device)")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)

    rng = np.random.default_rng(0)
    demo = args.demo or not args.src
    if demo:
        max_len = min(args.max_len, 16)
        src, tgt, out = synthetic_pairs(rng, max_len=max_len)
        sv = tv = 64
        layers, dim, ff = 2, 128, 256
        # the tiny demo stays in the linear warm-up (peak ~1e-3); the
        # 1/sqrt(step) tail only matters at real scale
        warmup = 200
    else:
        max_len = args.max_len
        src, tgt, out, sv, tv = read_pairs(args.src, args.tgt,
                                           args.src_vocab, args.tgt_vocab,
                                           max_len)
        layers, dim, ff = args.layers, args.dim, args.ff
        warmup = args.warmup
    spad, tpad = sv - 1, tv - 1

    cfg = tfm.TransformerConfig(
        vocab_size=sv, tgt_vocab_size=tv, layers=layers, heads=args.heads,
        head_dim=dim // args.heads, ff=ff, max_len=max_len,
        dropout=0.0 if demo else 0.1, dtype=torch.bfloat16)
    params = tfm.init_encoder_decoder(
        torch.Generator(device=dev).manual_seed(0), cfg)
    acc = Accumulator(params, max(1, args.big_step), dim, warmup)

    key = torch.Generator(device=dev).manual_seed(1)
    n, bs = len(src), args.batch
    t0 = time.time()
    it = 0
    loss = None
    for epoch in range(args.epochs):
        order = rng.permutation(n)
        for i in range(0, n - bs + 1, bs):
            batch = batch_on((src, tgt, out), order[i:i + bs], dev)
            loss = seq2seq_loss(params, cfg, *batch, spad, tpad,
                                0.0 if demo else 0.1, key)
            acc.backward(loss)
            loss = loss.detach()
            it += 1
            if it % 10 == 0:
                tok_s = it * bs * max_len / (time.time() - t0)
                print(f"epoch {epoch} iter {it}: loss {float(loss):.4f} "
                      f"lr {noam_lr(max(acc.steps, 1), dim, warmup):.2e} "
                      f"({tok_s:,.0f} tgt tok/s)")
    print(f"final loss {float(loss):.4f}")

    if demo:
        dec = greedy_decode(params, cfg, batch_on((src,), slice(0, 8),
                                                  dev)[0], spad, tpad,
                            max_len)
        ok = sum(int((dec[i, 1:] == out[i, :-1]).all()) for i in range(8))
        print(f"greedy decode: {ok}/8 demo sequences reproduced")
    elif args.tst:
        src_vocab = load_vocab(args.src_vocab)
        inv = {i: w for w, i in load_vocab(args.tgt_vocab).items()}
        with open(args.tst) as f:
            lines = [line.rstrip("\n") for line in f][:32]
        sb = np.stack([encode(line, src_vocab, max_len, False)[0]
                       for line in lines])
        dec = greedy_decode(params, cfg, batch_on((sb,), slice(None),
                                                  dev)[0], spad, tpad,
                            max_len)
        for row in dec:
            print(" ".join(inv.get(int(t), "<unk>") for t in row[1:]
                           if int(t) < tv - 4))
    return float(loss)


if __name__ == "__main__":
    main()
