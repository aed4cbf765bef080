"""Transformer-LM training throughput and MFU on one CUDA card.

Counterpart of bin/lm_bench.py: a GPT-2-medium-shaped decoder LM
(24 layers, d=1024, h=16, ff=4096, vocab 32768, T=1024, batch 8) training
in bf16 with float32 parameters, Adam at 1e-4, the flash-attention kernels
(forward and backward) and per-block rematerialization (policy "dots").

MFU convention (PaLM appendix B), the formula of bin/lm_bench.py: model
FLOPs = 6*N*tokens for the weight matmuls + 3*12*L*B*T^2*d/2 for attention
(causal halves it), divided by the step's wall time and the card's peak
dense rate in the step's type (bf16 by default; float32 with TF32 off runs
outside the tensor cores). The step's wall time is a host clock around ``steps``
steps that end in ``torch.cuda.synchronize()``.

    python -m ccv_tpu_torch.bin.lm_bench [--layers 24 --dim 1024 --batch 8
        --seq 1024 --steps 20 --no-flash --profile DIR]

Needs a CUDA device; prints one JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
from typing import Dict

import torch

from ccv_tpu_torch.device import default_device
from ccv_tpu_torch.models import transformer as tfm
from ccv_tpu_torch.nn import optimizers

# card name (torch.cuda.get_device_name) -> peak dense TFLOP/s in bf16 and
# in float32 outside the tensor cores (NVIDIA's H100 SXM data sheet, at its
# 700 W limit)
PEAK_BF16 = {"NVIDIA H100 80GB HBM3": 989.0}
PEAK_F32 = {"NVIDIA H100 80GB HBM3": 67.0}


def peak_tflops(device: torch.device,
                dtype: torch.dtype = torch.bfloat16) -> float:
    """The card's peak dense TFLOP/s in ``dtype`` (bf16 or float32); raises
    for a card not listed."""
    table = PEAK_F32 if dtype == torch.float32 else PEAK_BF16
    name = torch.cuda.get_device_name(device)
    if name not in table:
        raise ValueError(f"no {dtype} peak known for {name!r}; add it to "
                         f"lm_bench's tables")
    return table[name]


@contextlib.contextmanager
def plain_attention(enabled: bool = True):
    """Within the block, the LM's attention takes the plain SDPA (the
    ``--no-flash`` switch, as bin/lm_bench.py swaps ``_use_flash``)."""
    if not enabled:
        yield
        return
    saved = tfm._use_flash
    tfm._use_flash = lambda *a: False
    try:
        yield
    finally:
        tfm._use_flash = saved


def loss_fn(params, cfg: tfm.TransformerConfig,
            ids: torch.Tensor) -> torch.Tensor:
    """Next-token cross entropy of ids (B, T+1)."""
    logits = tfm.lm_forward(params, cfg, ids[:, :-1], train=True)
    return tfm.cross_entropy(logits, ids[:, 1:])


def train_step(params, opt: optimizers.Optimizer, opt_state,
               cfg: tfm.TransformerConfig, ids: torch.Tensor) -> torch.Tensor:
    """One step: loss, backward, Adam in place. Returns the loss (on the
    device, not synchronised)."""
    ps = optimizers.leaves(params)
    for p in ps:
        p.grad = None
    loss = loss_fn(params, cfg, ids)
    loss.backward()
    opt.update([p.grad for p in ps], opt_state, ps)
    return loss.detach()


def model_flops(n: int, layers: int, batch: int, seq: int, dim: int) -> float:
    """Model FLOPs of one step (bin/lm_bench.py:96-102)."""
    tokens = batch * seq
    flops_weights = 6.0 * n * tokens
    flops_attn = 3 * 12.0 * layers * batch * seq * seq * dim / 2
    return flops_weights + flops_attn


def measure(layers=24, dim=1024, heads=16, ff=4096, batch=8, seq=1024,
            vocab=32768, steps=20, remat=True, remat_policy="dots",
            flash=True, profile=None, dtype=torch.bfloat16) -> Dict:
    """Run the LM training-throughput measurement on the first CUDA card.

    One warm-up step, then ``steps`` timed steps on one batch, activations
    in ``dtype`` (bf16 or float32). ``profile``:
    a directory for a ``torch.profiler`` trace of 3 more steps (trace.json,
    a table of device time by kernel, kernels.txt, and summary.json); the
    result then also holds the device's busy ms per step, its idle share
    of the timed step, and the flash kernels' device ms per step."""
    dev = default_device()
    peak = peak_tflops(dev, dtype) * 1e12
    cfg = tfm.TransformerConfig(
        vocab_size=vocab, layers=layers, heads=heads, head_dim=dim // heads,
        ff=ff, max_len=seq, dropout=0.0, dtype=dtype, remat=remat,
        remat_policy=remat_policy)
    params = tfm.init_lm(torch.Generator(device=dev).manual_seed(0), cfg)
    n = sum(p.numel() for p in optimizers.leaves(params))
    opt = optimizers.adam(rate=1e-4)
    opt_state = opt.init(params)
    B, T = batch, seq
    ids = torch.randint(0, vocab, (B, T + 1),
                        generator=torch.Generator(device=dev).manual_seed(1),
                        device=dev)

    with plain_attention(not flash):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = [train_step(params, opt, opt_state, cfg, ids)]
        torch.cuda.synchronize()
        warmup_s = time.perf_counter() - t0

        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        for _ in range(steps):
            losses.append(train_step(params, opt, opt_state, cfg, ids))
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / steps
        peak_mem = torch.cuda.max_memory_allocated(dev)

        prof = (_profile(profile, lambda: train_step(params, opt, opt_state,
                                                     cfg, ids))
                if profile else {})
        if prof:
            prof["idle_share"] = 1 - prof["device_busy_ms"] / (dt * 1e3)

    flops = model_flops(n, layers, B, T, cfg.dim)
    return {**prof,
        "model": f"L{layers} d{cfg.dim} h{heads} ff{ff}",
        "params_m": round(n / 1e6, 1),
        "batch": B, "seq": T,
        "step_ms": dt * 1e3,
        "tokens_per_s": B * T / dt,
        "model_tflops_per_s": flops / dt / 1e12,
        "mfu": flops / dt / peak,
        "loss": float(losses[-1]),
        "losses": [float(x) for x in losses],
        "warmup_s": warmup_s,
        "peak_mem_gb": peak_mem / 1e9,
        "remat": remat, "remat_policy": remat_policy, "flash": flash,
        "peak_tflops": peak / 1e12, "dtype": str(dtype).split(".")[1],
        "device": torch.cuda.get_device_name(dev),
    }


# the flash kernels by the names the profiler gives them: the "wgmma-tma"
# kernels (bf16 and float16, D 32, 64, 128 or 256), the "tc-f32" ones
# (float32; K2b and K2c at D 64 and 128 are dq_res_kernel and
# dkv_res_kernel), and the "tc-wide" ones above D 256 (K2a's
# fwd_wide_tc_kernel; K2b and K2c in 16-bit share dq_tc_kernel and
# dkv_tc_kernel with float32)
FLASH_KERNELS = {"fwd": ("fwd_sm90_kernel", "fwd_tc_kernel",
                         "fwd_wide_tc_kernel"),
                 "dq": ("dq_sm90_kernel", "dq_tc_kernel", "dq_res_kernel"),
                 "dkv": ("dkv_sm90_kernel", "dkv_tc_kernel",
                         "dkv_res_kernel")}


def _profile(out_dir: str, step, steps: int = 3) -> Dict:
    """Profiles ``steps`` calls of ``step``; returns the device's busy ms
    per step (the sum of the device-side events) and the flash kernels'
    share of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
    averages = prof.key_averages()
    with open(os.path.join(out_dir, "kernels.txt"), "w") as f:
        f.write(averages.table(sort_by="self_cuda_time_total", row_limit=40))
    # device events only: the host-side ops carry their kernels' time too
    dev_ms = {e.key: e.self_device_time_total / 1e3 / steps
              for e in averages if e.device_type == DeviceType.CUDA}
    out = {"device_busy_ms": sum(dev_ms.values()),
           "flash_ms": {k: sum(ms for name, ms in dev_ms.items()
                               if any(p in name for p in pats))
                        for k, pats in FLASH_KERNELS.items()},
           "device_ms_top": dict(sorted(dev_ms.items(),
                                        key=lambda kv: -kv[1])[:15])}
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(out, f, indent=1)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=24)
    ap.add_argument("--dim", type=int, default=1024)
    ap.add_argument("--heads", type=int, default=16)
    ap.add_argument("--ff", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--vocab", type=int, default=32768)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--remat-policy", default="dots",
                    choices=["full", "dots"],
                    help="dots: save the weight-matmul outputs and recompute "
                    "the rest of each block; full: recompute whole blocks")
    ap.add_argument("--no-flash", action="store_true")
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="write a torch.profiler trace of 3 steps into DIR")
    args = ap.parse_args()
    print(json.dumps(measure(
        layers=args.layers, dim=args.dim, heads=args.heads, ff=args.ff,
        batch=args.batch, seq=args.seq, vocab=args.vocab, steps=args.steps,
        remat=not args.no_remat, remat_policy=args.remat_policy,
        flash=not args.no_flash, profile=args.profile)))


if __name__ == "__main__":
    main()
