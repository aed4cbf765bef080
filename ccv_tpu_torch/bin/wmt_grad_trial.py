"""The wmt step's gradients in bf16, with the flash kernels and with plain
attention, each against a float32 step with plain attention, at wmt.c's
widths (6 + 6 layers, d 512 = 8 heads of 64, ff 2048, vocab 32,768 a
side; B 16 x T 128, source mask, label smoothing 0.1, dropout 0), from
several parameter seeds.

    python -m ccv_tpu_torch.bin.wmt_grad_trial [--seeds 9 10 11]

Needs a CUDA device. Prints one JSON line per seed: for "kernel_vs_plain",
"kernel_vs_f32" and "plain_vs_f32", the worst gradients by max |diff| /
max |reference| (the key biases bk and xbk left out: their true gradient
is 0), and the float32 kernel step against the float32 plain step. It
shows how far a correct bf16 step lands from float32 at this depth, on
either path: the yardstick of ``chip_smoke.py``'s wmt gate.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ccv_tpu_torch.bin import lm_bench, wmt
from ccv_tpu_torch.device import default_device
from ccv_tpu_torch.models import transformer as tfm

WIDTHS = dict(vocab_size=32768, tgt_vocab_size=32768, layers=6, heads=8,
              head_dim=64, ff=2048, max_len=128)
PAD_RANGE = (8, 120)


def synthetic_batch(rng, b, t, sv, tv):
    """(src, tgt, out) int64 numpy rows laid out as wmt's ``encode`` lays
    them out: src = tokens, end, pads; tgt = beg, tokens, end, pads; out =
    tgt shifted left. Each row's padding length is drawn from PAD_RANGE
    (at most t - 3: beg, a token and end stay)."""
    src = np.full((b, t), sv - 1, np.int64)
    tgt = np.full((b, t), tv - 1, np.int64)
    for r in range(b):
        n = t - int(rng.integers(PAD_RANGE[0],
                                 min(PAD_RANGE[1], t - 3) + 1))
        src[r, :n - 1] = rng.integers(0, sv - 4, n - 1)
        src[r, n - 1] = sv - 2
        tgt[r, 0] = tv - 3
        tgt[r, 1:n - 1] = rng.integers(0, tv - 4, n - 2)
        tgt[r, n - 1] = tv - 2
    out = np.concatenate([tgt[:, 1:], np.full((b, 1), tv - 1)], 1)
    return src, tgt, out


def named_grads(tree, prefix="") -> Dict[str, torch.Tensor]:
    """{dotted name: .grad} of a nested dict/list of parameters."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = ((str(i), sub) for i, sub in enumerate(tree))
    else:
        return {prefix: tree.grad.float()}
    out = {}
    for key, sub in items:
        out.update(named_grads(sub, f"{prefix}.{key}" if prefix else key))
    return out


def grad_dist(a: Dict[str, torch.Tensor],
              b: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """{name: max |a - b| / max |b|}, bk and xbk left out."""
    return {name: float((a[name] - b[name]).abs().max()
                        / b[name].abs().max().clamp_min(1e-30))
            for name in b if not name.endswith((".bk", ".xbk"))}


def step_grads(seed: int, batch, dtype: torch.dtype, plain: bool,
               dev: torch.device) -> Dict[str, torch.Tensor]:
    """The gradients of one wmt loss at dropout 0 from the parameters of
    ``seed``, with the kernels or with plain attention."""
    cfg = tfm.TransformerConfig(**WIDTHS, dropout=0.0, dtype=dtype)
    params = tfm.init_encoder_decoder(
        torch.Generator(device=dev).manual_seed(seed), cfg)
    with lm_bench.plain_attention(plain):
        loss = wmt.seq2seq_loss(params, cfg, *batch, cfg.vocab_size - 1,
                                cfg.tgt_vocab_size - 1, 0.1, None)
        loss.backward()
    return named_grads(params)


def trial(seed: int, batch_seed: int, dev: torch.device,
          batch_size: int = 16) -> Dict:
    T = WIDTHS["max_len"]
    batch = tuple(torch.from_numpy(x).to(dev) for x in synthetic_batch(
        np.random.default_rng(batch_seed), batch_size, T,
        WIDTHS["vocab_size"], WIDTHS["tgt_vocab_size"]))
    f32 = step_grads(seed, batch, torch.float32, True, dev)
    f32_kernel = step_grads(seed, batch, torch.float32, False, dev)
    kernel = step_grads(seed, batch, torch.bfloat16, False, dev)
    plain = step_grads(seed, batch, torch.bfloat16, True, dev)

    def worst(dist, n=6):
        return dict(sorted(dist.items(), key=lambda kv: -kv[1])[:n])
    return {"seed": seed, "batch_seed": batch_seed,
            "f32_kernel_vs_f32": worst(grad_dist(f32_kernel, f32), 3),
            "kernel_vs_plain": worst(grad_dist(kernel, plain)),
            "kernel_vs_f32": worst(grad_dist(kernel, f32)),
            "plain_vs_f32": worst(grad_dist(plain, f32)),
            "device": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else str(dev))}


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[9, 10, 11])
    args = ap.parse_args(argv)
    dev = default_device()
    for i, seed in enumerate(args.seeds):
        print(json.dumps(trial(seed, 31 + i, dev)), flush=True)


if __name__ == "__main__":
    main()
