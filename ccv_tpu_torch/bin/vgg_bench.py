"""VGG-D forward throughput and MFU on one CUDA card.

Counterpart of bench.py's ``bench_vgg`` (the bin/cnnclassify north star):
``vgg_d()`` with float32 parameters drawn from a seed, a batch of 32
224x224x3 images in bf16 (standard normal, from a seed), each parameter
cast to bf16 in its op; one warm-up forward, then 8 timed forwards with a
``torch.cuda.synchronize()`` inside the timed window. Prints images/s, ms
per batch, GFLOP per image (bench.py's formula: each convolution
2 * res^2 * c * cin * 9, plus the three dense layers: 30.94) and MFU
against the card's dense bf16 peak (989 TFLOP/s for the H100 SXM, as
``lm_bench``).

    python -m ccv_tpu_torch.bin.vgg_bench [--profile]

``--profile`` adds 3 forwards under torch.profiler: the card's busy ms per
batch, the idle share (busy over the wall of the same batches), the
device ms of the convolution kernels, the matmuls and the dtype-cast
copies, and the kernels and torch ops that take the most. Needs a CUDA
device; prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Tuple

import numpy as np
import torch

from ccv_tpu_torch.bin.lm_bench import peak_tflops
from ccv_tpu_torch.device import default_device
from ccv_tpu_torch.models import vgg
from ccv_tpu_torch.nn.model import Sequential

BATCH, RES, STEPS = 32, 224, 8  # bench.py's bench_vgg


def build(device=None) -> Tuple[Sequential, torch.Tensor]:
    """VGG-D built on the card (float32 parameters, seed 0) and its bf16
    input batch of BATCH RES x RES x 3 images (seed 0)."""
    dev = device if device is not None else default_device()
    model = vgg.vgg_d()
    model.build((BATCH, RES, RES, 3), device=dev)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (BATCH, RES, RES, 3)).astype(np.float32)).to(dev, torch.bfloat16)
    return model, x


def measure(model: Sequential = None, x: torch.Tensor = None) -> Dict:
    """The timing of bench.py's ``bench_vgg`` on the card: a warm-up
    forward, then STEPS forwards on the host clock, ending in a
    synchronize. Builds the model and batch when not given."""
    if model is None:
        model, x = build()
    dev = x.device
    peak = peak_tflops(dev) * 1e12
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = model.evaluate(x)
    torch.cuda.synchronize(dev)
    warmup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(STEPS):
        out = model.evaluate(x)
    torch.cuda.synchronize(dev)
    dt = (time.perf_counter() - t0) / STEPS
    batch, res = x.shape[0], x.shape[1]
    flops = vgg.forward_flops(res, model.output_shape[-1])
    img_s = batch / dt
    return {"batch": batch, "res": res, "dtype": str(x.dtype),
            "images_per_s": img_s, "ms_per_batch": dt * 1e3,
            "gflops_per_image": flops / 1e9,
            "mfu": img_s * flops / peak, "peak_tflops": peak / 1e12,
            "warmup_s": warmup_s, "params_m": model.parameter_count() / 1e6,
            "logits_finite": bool(torch.isfinite(out).all()),
            "device": torch.cuda.get_device_name(dev)}


def split(by_name: Dict[str, float]) -> Dict[str, float]:
    """Device ms by kind of kernel: cuDNN's convolutions, the matmuls of
    the dense layers, the dtype-cast copies (float32 parameters to bf16),
    and the rest (ReLU, pools, bias adds)."""
    out = {"conv_ms": 0.0, "gemm_ms": 0.0, "cast_ms": 0.0, "other_ms": 0.0}
    for name, ms in by_name.items():
        low = name.lower()
        if "conv" in low or "fprop" in low or "implicit" in low:
            out["conv_ms"] += ms
        elif "gemm" in low or "nvjet" in low:
            out["gemm_ms"] += ms
        elif "copy" in low:
            out["cast_ms"] += ms
        else:
            out["other_ms"] += ms
    return out


def profile(model: Sequential, x: torch.Tensor, n: int = 3) -> Dict:
    """``n`` forwards under torch.profiler: device busy ms per batch (the
    device-side events only), the wall of the same batches on the host
    clock (profiler overhead included), the idle share, the ``split``, the
    eight kernels with the most device time, and the eight torch ops whose
    own launches took the most (which op a kernel serves: ``aten::add_``
    for a bias, ``aten::relu_``, ``aten::_to_copy`` for a cast)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as _profile
    model.evaluate(x)
    torch.cuda.synchronize(x.device)
    with _profile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            model.evaluate(x)
        torch.cuda.synchronize(x.device)
        wall = (time.perf_counter() - t0) * 1e3 / n
    events = prof.key_averages()
    by_name = {e.key: e.self_device_time_total / 1e3 / n for e in events
               if e.device_type == DeviceType.CUDA}
    by_op = {e.key: e.self_device_time_total / 1e3 / n for e in events
             if e.device_type == DeviceType.CPU
             and e.self_device_time_total > 0}
    busy = sum(by_name.values())

    def top(d):
        return [[k[:100], v] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:8]]

    return {"device_busy_ms": busy, "wall_ms": wall,
            "idle_share": 1 - busy / wall, **split(by_name),
            "top": top(by_name), "top_ops": top(by_op)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    model, x = build()
    res = measure(model, x)
    if args.profile:
        res.update(profile(model, x))
    print(json.dumps(res))


if __name__ == "__main__":
    main()
