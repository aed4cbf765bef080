"""K2's times and registers on one CUDA card, in the checkout it runs from.

    python -m ccv_tpu_torch.bin.k2_trial [--label NAME] [--ptxas]  # repo root

Times K2a, K2b and K2c (CUDA events: the least of three means of 20
launches) at the LMs' bf16 causal shapes, BH 128 x T 1024 at head dim 64,
BH 64 at 128 and BH 32 at 256, and prints one JSON line with the card's
name and power limit. It calls only ``flash_fwd``, ``flash_dq`` and
``flash_dkv``, which older checkouts have too, so copied into one it times
that checkout's kernels (a head dim they refuse is reported as refused): run
parent, change, change, parent in one call to compare two. ``--ptxas`` also
compiles each K2 source with ``nvcc -Xptxas -v`` and adds every kernel's
registers and spill bytes. Needs a CUDA card (and nvcc).
"""

import argparse
import json
import re
import subprocess
import tempfile

import numpy as np
import torch

from ccv_tpu_torch.ops.kernels import _build
from ccv_tpu_torch.ops.kernels import flash_attention as k2

SHAPES = ((128, 1024, 1024, 64, True), (64, 1024, 1024, 128, True),
          (32, 1024, 1024, 256, True))
SOURCES = ("flash_attention.cu", "flash_attention_sm90.cu")
TYPES = {"f": "float32", "nv_bfloat16": "bfloat16", "half": "float16"}


def time_cuda(fn, reps: int = 20) -> float:
    """Mean ms of ``reps`` calls, CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_ms(shape) -> dict:
    """{"fwd", "dq", "dkv": ms} at a bf16 (BH, Tq, Tk, D, causal) shape."""
    bh, t_q, t_k, d, causal = shape
    rng = np.random.default_rng(0)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((bh, t, d),
                                                        np.float32))
                   .to("cuda", torch.bfloat16) for t in (t_q, t_k, t_k, t_q))
    scale = 1.0 / np.sqrt(d)
    o, lse = k2.flash_fwd(q, k, v, scale, causal)
    delta = (do.float() * o.float()).sum(-1)
    bwd = (q, k, v, do, lse, delta, scale, causal)
    fns = {"fwd": lambda: k2.flash_fwd(q, k, v, scale, causal),
           "dq": lambda: k2.flash_dq(*bwd), "dkv": lambda: k2.flash_dkv(*bwd)}
    return {name: round(min(time_cuda(fn) for _ in range(3)), 4)
            for name, fn in fns.items()}


def kernel_name(mangled: str) -> tuple:
    """(kernel, type or None, head dim or None) of a mangled template
    kernel name such as ``..._cu_2e7b489815dkv_sm90_kernelI13__nv_bfloat16
    Li256EE...``: the kernel's name is the one its length prefix spells
    out; older kernels were templates on the head dim alone."""
    end = mangled.index("_kernelI") + len("_kernel")
    name = next(mangled[end - n:end] for n in range(6, end)
                if mangled[:end - n].endswith(str(n))
                and mangled[end - n].isalpha())
    args = re.match(r"I(?:\d*_*(?!Li)(\w+?))?(?:Li(\d+))?E", mangled[end:])
    return (name, TYPES.get(args.group(1), args.group(1)),
            int(args.group(2)) if args.group(2) else None)


def parse_ptxas(text: str) -> list:
    """[{kernel, type, head_dim, registers, spill_stores, spill_loads}] from
    ``nvcc -Xptxas -v`` output; head_dim is None for a kernel that takes it
    at run time."""
    out, name, spill = [], None, (0, 0)
    for line in text.splitlines():
        if "Compiling entry function" in line:
            name = kernel_name(line.split("'")[1])
        elif "spill stores" in line:
            spill = tuple(int(n) for n in re.findall(
                r"(\d+) bytes spill (?:stores|loads)", line))
        elif "Used" in line and name is not None:
            out.append(dict(zip(("kernel", "type", "head_dim"), name),
                            registers=int(re.search(r"Used (\d+) registers",
                                                    line).group(1)),
                            spill_stores=spill[0], spill_loads=spill[1]))
            name = None
    return out


def ptxas(source: str) -> list:
    """The registers and spills of every kernel of ``csrc/<source>``."""
    with tempfile.NamedTemporaryFile(suffix=".so") as so:
        proc = subprocess.run(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             so.name, str(_build.CSRC / source)],
            capture_output=True, text=True, check=True)
    return parse_ptxas(proc.stderr)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="")
    ap.add_argument("--ptxas", action="store_true")
    args = ap.parse_args()
    k2.build()
    out = {"label": args.label}
    for shape in SHAPES:
        try:
            out[f"D{shape[3]}"] = kernel_ms(shape)
        except ValueError as e:   # a checkout whose kernels refuse this D
            out[f"D{shape[3]}"] = f"refused: {e}"
    if args.ptxas:
        out["ptxas"] = {src: ptxas(src) for src in SOURCES}
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
