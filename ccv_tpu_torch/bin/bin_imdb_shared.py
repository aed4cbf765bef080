"""Corpus loading for the port's imdb CLI (a copy of bin/bin_imdb_shared.py;
reference: bin/nnc/imdb.c _vocab_init + _text_to_tensor_index). Plain
numpy: the same ids, pads and synthetic corpus as ``ccv_tpu``'s."""

import numpy as np


def load_vocab(path):
    vocab = {}
    with open(path) as f:
        for i, line in enumerate(f):
            vocab[line.strip()] = i
    return vocab


def encode(line, vocab, max_len):
    """[beg] tokens [end] pad, reserved ids = last four of the vocab."""
    n = len(vocab) + 4
    unk, beg, end, pad = n - 4, n - 3, n - 2, n - 1
    ids = [beg] + [vocab.get(w, unk) for w in line.split()]
    ids = ids[:max_len - 1] + [end]
    ids += [pad] * (max_len - len(ids))
    return np.array(ids[:max_len], np.int32), pad


def synthetic_corpus(rng, n=256, max_len=32, vocab_size=200):
    """Separable toy task: positive lines draw from the low half of the
    vocab, negative from the high half."""
    xs, ys = [], []
    for i in range(n):
        label = i % 2
        lo, hi = (4, vocab_size // 2) if label else (vocab_size // 2,
                                                    vocab_size - 4)
        length = int(rng.integers(5, max_len - 2))
        ids = np.concatenate([[vocab_size - 3],
                              rng.integers(lo, hi, length),
                              [vocab_size - 2]])
        ids = np.pad(ids, (0, max_len - len(ids)),
                     constant_values=vocab_size - 1)[:max_len]
        xs.append(ids.astype(np.int32))
        ys.append(label)
    return np.stack(xs), np.array(ys, np.int32)


def load_corpus(args):
    """(xs, ys, vocab_size, pad_id) from --train/--vocab or --demo."""
    rng = np.random.default_rng(0)
    if getattr(args, "demo", False) or not args.train:
        xs, ys = synthetic_corpus(rng, max_len=args.max_len)
        return xs, ys, 200, 199
    vocab = load_vocab(args.vocab)
    vocab_size = len(vocab) + 4
    xs, ys = [], []
    pad_id = vocab_size - 1
    for path, label in ((args.train[0], 1), (args.train[1], 0)):
        with open(path) as f:
            for line in f:
                ids, pad_id = encode(line, vocab, args.max_len)
                xs.append(ids)
                ys.append(label)
    return np.stack(xs), np.array(ys, np.int32), vocab_size, pad_id
