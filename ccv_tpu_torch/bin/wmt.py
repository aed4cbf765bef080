"""bin/wmt.py twin: the encoder-decoder transformer translation trainer,
on the card (reference: bin/nnc/wmt.c: parallel src/tgt token files and
vocab files, teacher-forced decoder on targets shifted left, Adam; wmt.c
main()'s shape by default: 6 + 6 layers, d 512 = 8 heads x 64, ff 2048).

    python -m ccv_tpu_torch.bin.wmt --src src.txt --tgt tgt.txt \\
        --src-vocab sv.txt --tgt-vocab tv.txt [--device cpu]
    python -m ccv_tpu_torch.bin.wmt --demo    # synthetic copy task

Runs on the first CUDA device unless ``--device`` says otherwise.

Data parallelism, one process per rank (each on the card of its
``LOCAL_RANK``):

    torchrun --nproc-per-node N -m ccv_tpu_torch.bin.wmt --data-parallel N \\
        --dist-backend nccl --src ... --tgt ... --src-vocab ... --tgt-vocab ...

Every rank draws the same batches and runs its 1/N of each batch's rows;
dropout masks and the masked loss's token count are the global batch's,
the gradients are allreduced, and Adam runs alike on every rank, so the
step is the one-rank step on the whole batch. N must equal the world size
(1 without a process group); ``--dist-backend`` names the backend.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ccv_tpu_torch import device as _device
from ccv_tpu_torch.models import transformer as tfm
from ccv_tpu_torch.nn import optimizers
from ccv_tpu_torch.parallel import data as _data
from ccv_tpu_torch.parallel import distributed
from ccv_tpu_torch.parallel import mesh as _mesh


def load_vocab(path):
    vocab = {}
    with open(path) as f:
        for i, line in enumerate(f):
            vocab[line.strip()] = i
    return vocab


def encode(line, vocab, max_len, has_beg):
    """wmt.c _text_to_tensor_index: [beg?] tokens [end] pad; returns the
    row plus its valid length and the pad id."""
    n = len(vocab) + 4
    unk, beg, end, pad = n - 4, n - 3, n - 2, n - 1
    ids = ([beg] if has_beg else []) + [vocab.get(w, unk)
                                        for w in line.split()]
    ids = ids[:max_len - 1] + [end]
    length = len(ids)
    ids += [pad] * (max_len - len(ids))
    return np.array(ids[:max_len], np.int32), min(length, max_len), pad


def synthetic_pairs(rng, n=192, max_len=16, vocab=64):
    """Copy task: target = source sequence (beg-shifted)."""
    src = np.full((n, max_len), vocab - 1, np.int32)
    tgt = np.full((n, max_len), vocab - 1, np.int32)
    out = np.full((n, max_len), vocab - 1, np.int32)
    for i in range(n):
        ln = int(rng.integers(4, max_len - 2))
        seq = rng.integers(4, vocab - 4, ln).astype(np.int32)
        src[i, :ln] = seq
        src[i, ln] = vocab - 2
        tgt[i, 0] = vocab - 3
        tgt[i, 1:ln + 1] = seq
        out[i, :ln] = seq
        out[i, ln] = vocab - 2
    return src, tgt, out


def read_pairs(src_path, tgt_path, src_vocab_path, tgt_vocab_path,
               max_len) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int, int]:
    """(src, tgt, out, source vocab size, target vocab size) from parallel
    text files: out is tgt shifted left (wmt.c:106-108). Exits when the
    files hold no pair."""
    src_vocab, tgt_vocab = load_vocab(src_vocab_path), load_vocab(
        tgt_vocab_path)
    sv, tv = len(src_vocab) + 4, len(tgt_vocab) + 4
    rows = [[], [], []]
    with open(src_path) as fs, open(tgt_path) as ft:
        for sline, tline in zip(fs, ft):
            s, _, _ = encode(sline, src_vocab, max_len, False)
            t, _, _ = encode(tline, tgt_vocab, max_len, True)
            rows[0].append(s)
            rows[1].append(t)
            rows[2].append(np.concatenate([t[1:], [tv - 1]]).astype(np.int32))
    if not rows[0]:
        sys.exit(f"no sentence pairs read from {src_path} / {tgt_path}")
    src, tgt, out = (np.stack(r) for r in rows)
    return src, tgt, out, sv, tv


def seq2seq_loss(params, cfg: tfm.TransformerConfig, src_b, tgt_b, out_b,
                 spad: int, tpad: int, smoothing: float,
                 key: Optional[torch.Generator]) -> torch.Tensor:
    """Masked, label-smoothed token cross entropy of the teacher-forced
    decoder, the source masked by its pads (the wmt / iwslt loss)."""
    logits = tfm.encoder_decoder_forward(params, cfg, src_b, tgt_b,
                                         src_mask=src_b != spad, train=True,
                                         key=key)
    return tfm.cross_entropy(logits, out_b, label_smoothing=smoothing,
                             mask=out_b != tpad)


def train_step(params, opt: optimizers.Optimizer, state,
               cfg: tfm.TransformerConfig, batch, spad: int, tpad: int,
               key: Optional[torch.Generator],
               smoothing: float = 0.1, group=None) -> torch.Tensor:
    """One step: loss, backward, Adam in place; each parameter's ``.grad``
    is then the step's gradient. ``batch`` is (src, tgt, out) on the
    device. With a data-parallel ``group`` the batch is this rank's rows
    of the global batch: the forward runs inside ``parallel.data.sharded``,
    the gradients and the loss are allreduced (a group of one rank, or
    None, splits nothing: the one-rank step). Returns the loss (not
    synchronised)."""
    ps = optimizers.leaves(params)
    for p in ps:
        p.grad = None
    with _data.sharded((0, group)):
        loss = seq2seq_loss(params, cfg, *batch, spad, tpad, smoothing, key)
        total = _data.global_sum(loss.detach())
    loss.backward()
    for p, g in zip(ps, _data.allreduce_grads([p.grad for p in ps],
                                              [group])):
        p.grad = g
    opt.update([p.grad for p in ps], state, ps)
    return total


def batch_on(arrays, sel, dev: torch.device):
    """The rows ``sel`` of each array as int64 tensors on ``dev``."""
    return tuple(_device.to_device(a[sel].astype(np.int64), dev)
                 for a in arrays)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src")
    ap.add_argument("--tgt")
    ap.add_argument("--src-vocab")
    ap.add_argument("--tgt-vocab")
    ap.add_argument("--demo", action="store_true")
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--dim", type=int, default=512)   # k=64 x h=8
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--ff", type=int, default=2048)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--data-parallel", type=int, default=0,
                    help="split each batch over N ranks (the world size)")
    ap.add_argument("--dist-backend", choices=("nccl", "gloo"),
                    help="torch.distributed backend of --data-parallel")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA device; "
                         "with --data-parallel, the card of LOCAL_RANK)")
    return ap


def run(argv: Optional[Sequence[str]] = None):
    """Trains as ``main``; returns (final loss, the parameters)."""
    ap = parser()
    args = ap.parse_args(argv)
    group, rank = None, 0
    if args.data_parallel:
        if args.dist_backend is None:
            ap.error("--data-parallel needs --dist-backend (nccl or gloo)")
        if distributed.init(args.dist_backend):
            group = torch.distributed.group.WORLD
        world = _mesh.world_size(group)
        if args.data_parallel != world:
            ap.error(f"--data-parallel {args.data_parallel} against a world "
                     f"of {world} rank(s)")
        if args.batch % world:
            ap.error(f"--batch {args.batch} does not split over {world} "
                     f"ranks")
        rank = distributed.process_index()
        dev = distributed.local_device(args.device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
    else:
        dev = _device.resolve(args.device)

    rng = np.random.default_rng(0)
    demo = args.demo or not args.src
    if demo:
        max_len = min(args.max_len, 16)
        src, tgt, out = synthetic_pairs(rng, max_len=max_len)
        sv = tv = 64
        layers, dim, ff = 2, 128, 256
    else:
        max_len = args.max_len
        src, tgt, out, sv, tv = read_pairs(args.src, args.tgt,
                                           args.src_vocab, args.tgt_vocab,
                                           max_len)
        layers, dim, ff = args.layers, args.dim, args.ff
    spad, tpad = sv - 1, tv - 1   # encode: pad = vocab size - 1

    cfg = tfm.TransformerConfig(
        vocab_size=sv, tgt_vocab_size=tv, layers=layers, heads=args.heads,
        head_dim=dim // args.heads, ff=ff, max_len=max_len,
        dropout=0.0 if demo else 0.1, dtype=torch.bfloat16)
    params = tfm.init_encoder_decoder(
        torch.Generator(device=dev).manual_seed(0), cfg)
    opt = optimizers.adam(rate=args.lr)
    state = opt.init(params)

    key = torch.Generator(device=dev).manual_seed(1)
    n, bs = len(src), args.batch
    part = bs // _mesh.world_size(group)
    t0 = time.time()
    it = 0
    loss = None
    for epoch in range(args.epochs):
        order = rng.permutation(n)
        for i in range(0, n - bs + 1, bs):
            # every rank draws the same batch and takes its rows of it
            sel = order[i:i + bs][rank * part:(rank + 1) * part]
            batch = batch_on((src, tgt, out), sel, dev)
            loss = train_step(params, opt, state, cfg, batch, spad, tpad,
                              key, group=group)
            it += 1
            if it % 5 == 0 and rank == 0:
                tok_s = it * bs * max_len / (time.time() - t0)
                print(f"epoch {epoch} iter {it}: loss {float(loss):.4f} "
                      f"({tok_s:,.0f} tgt tok/s)")
    if rank == 0:
        print(f"final loss {float(loss):.4f}")
    return float(loss), params


def main(argv: Optional[Sequence[str]] = None) -> float:
    return run(argv)[0]


if __name__ == "__main__":
    main()
