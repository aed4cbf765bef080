"""K2's times and registers on one CUDA card, in the checkout it runs from.

    python -m ccv_tpu_torch.bin.k2_trial [--label NAME] [--library] [--lm]
                                         [--ptxas]   # from the repo root

Times K2a, K2b and K2c (CUDA events: the least of three means of 20
launches; 5 at the wide shapes) at the LMs' bf16 causal shapes, BH 128 x T
1024 at head dim 64, BH 64 at 128 and BH 32 at 256, and at the wide
shapes, all causal at T 1024: float32 at D 64 (BH 128), 128 (BH 64), 256,
320, 512 and 576 (BH 32), bf16 at D 320 and 512 and float16 at D 512 (BH
32), bf16 at D 32 (BH 256, the wmma-smem kernels of phase 18's demo); and
float32 at D 32 (BH 256, the same operations), once through the
wrappers as they run it and once on the same tensors zero-padded to D 64
by the caller; prints one JSON line with the card's name and power
limit. ``--library`` adds, at the wide shapes, the plain
versions' times, each kernel's bound (``roofline``, of the kind its
design runs) and the PyTorch calls that compute the same functions
(yardsticks only: SDPA's memory-efficient forward, and its backward op,
which gives dq, dk and dv in one call; at bf16 D 32 SDPA's flash forward
and backward, which take it). ``--lm`` times float32 training
steps (host clock, the mean of 3 steps after a warm-up) with their K2
launches: the LM at Gemma-2B's widths (``LM_F32``: 2 layers, d 2048 = 8
heads of 256, ff 16384, vocab 256,000, B 4 x T 1024, remat "dots") and at
d 2048 = 16 heads of 128 (``LM_F32_D128``, chip_smoke.py's LM_D128: ff
8192, vocab 32,768), by a loop of its own, since older checkouts'
``lm_bench.measure`` runs bf16 alone; and one ``Model.fit`` of
chip_smoke.py phase 31's attention model (``FIT_F32``: LayerNorm, causal
ScaledDotProductAttention of 16 heads of 64, Add; B 4 x T 1024 x 1024;
adamw, "mse"). It calls only ``flash_fwd``, ``flash_dq``, ``flash_dkv``,
``build`` and the LM's and the graph model's public functions, which
older checkouts have too, so copied into one it times that checkout's
kernels (a head dim or route they refuse is reported as refused): run
parent, change, change, parent in one call to compare two.
``--ptxas`` also compiles each K2 source with ``nvcc -Xptxas -v`` and adds
every kernel's registers and spill bytes. Needs a CUDA card (and nvcc).
"""

import argparse
import json
import re
import subprocess
import tempfile
import time

import numpy as np
import torch

from ccv_tpu_torch.ops.kernels import _build, roofline
from ccv_tpu_torch.ops.kernels import flash_attention as k2

SHAPES = ((128, 1024, 1024, 64, True), (64, 1024, 1024, 128, True),
          (32, 1024, 1024, 256, True))
WIDE_SHAPES = ((torch.float32, (128, 1024, 1024, 64, True)),
               (torch.float32, (64, 1024, 1024, 128, True)),
               (torch.float32, (32, 1024, 1024, 256, True)),
               (torch.float32, (32, 1024, 1024, 320, True)),
               (torch.float32, (32, 1024, 1024, 512, True)),
               (torch.float32, (32, 1024, 1024, 576, True)),
               (torch.bfloat16, (32, 1024, 1024, 320, True)),
               (torch.bfloat16, (32, 1024, 1024, 512, True)),
               (torch.float16, (32, 1024, 1024, 512, True)),
               (torch.bfloat16, (256, 1024, 1024, 32, True)))
D32_SHAPE = (256, 1024, 1024, 32, True)  # float32, timed also padded to 64
HEADS = 16  # BH = B x 16 heads for the library calls
LM_F32 = dict(vocab_size=256000, layers=2, heads=8, head_dim=256, ff=16384,
              max_len=1024, batch=4)
LM_F32_D128 = dict(vocab_size=32768, layers=2, heads=16, head_dim=128,
                   ff=8192, max_len=1024, batch=4)
FIT_F32 = (4, 1024, 1024, 16, 64)  # B, T, d_model, heads, head dim
SOURCES = ("flash_attention.cu", "flash_attention_sm90.cu",
           "flash_attention_tf32.cu")
TYPES = {"f": "float32", "nv_bfloat16": "bfloat16", "half": "float16"}
KINDS = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16"}


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


def library_calls(q, k, v, do, scale, b=8, backend="flash"):
    """The PyTorch calls that compute K2's functions, used only as
    yardsticks: SDPA's flash forward (the flash backend forced, so a
    missing one raises instead of timing another), and the flash backward
    op, which gives dq, dk and dv in one call, fed from the flash forward
    op's outputs. Inputs are causal (BH, T, D) with BH = b x heads.
    ``backend="efficient"``: the memory-efficient forward and backward ops
    instead (float32, and head dims past the flash backend's 256)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    h = q.shape[0] // b
    q4, k4, v4, do4 = (x.view(b, h, *x.shape[1:]) for x in (q, k, v, do))
    if backend == "efficient":
        o, lse, seed, offset = (
            torch.ops.aten._scaled_dot_product_efficient_attention(
                q4, k4, v4, None, True, 0.0, True, scale=scale))

        def fwd():
            with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                return torch.nn.functional.scaled_dot_product_attention(
                    q4, k4, v4, is_causal=True, scale=scale)

        def bwd():
            return torch.ops.aten._scaled_dot_product_efficient_attention_backward(
                do4, q4, k4, v4, None, o, lse, seed, offset, 0.0,
                [True, True, True, False], True, scale=scale)[:3]
        return fwd, bwd
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        out = torch.ops.aten._scaled_dot_product_flash_attention(
            q4, k4, v4, 0.0, True, False, scale=scale)
    o, lse, cum_q, cum_k, max_q, max_k, seed, offset, _ = out

    def fwd():
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            return torch.nn.functional.scaled_dot_product_attention(
                q4, k4, v4, is_causal=True, scale=scale)

    def bwd():
        return torch.ops.aten._scaled_dot_product_flash_attention_backward(
            do4, q4, k4, v4, o, lse, cum_q, cum_k, max_q, max_k, 0.0, True,
            seed, offset, scale=scale)
    return fwd, bwd


def bound_kind(kernel: str, dtype: torch.dtype, d: int) -> str:
    """The roofline kind of ``kernel``'s design (a checkout without
    ``roofline_kind`` runs every type off the tensor cores' float32)."""
    kind = getattr(k2, "roofline_kind", None)
    return kind(kernel, dtype, d) if kind else KINDS[dtype]


def kernel_ms(shape, dtype=torch.bfloat16, reps=20, library=False,
              pad_to=None) -> dict:
    """{"fwd", "dq", "dkv": ms} at a causal (BH, Tq, Tk, D, causal) shape in
    ``dtype``; with ``library`` each is a dict of the kernel's ms, its
    plain version's, its bound and the library call's (SDPA's flash calls
    in 16-bit up to D 256, else the memory-efficient ones).
    ``pad_to``: the kernels (and plain versions) run on q, k, v and do
    zero-padded along D to that head dim, with D's scale; the bound counts
    D's work at the padded dim's kind, the library call runs unpadded."""
    bh, t_q, t_k, d, causal = shape
    rng = np.random.default_rng(0)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((bh, t, d),
                                                        np.float32))
                   .to("cuda", dtype) for t in (t_q, t_k, t_k, t_q))
    scale = 1.0 / np.sqrt(d)
    lib_args = (q, k, v, do, scale)
    if pad_to is not None:
        q, k, v, do = (torch.nn.functional.pad(x, (0, pad_to - d))
                       for x in (q, k, v, do))
    o, lse = k2.flash_fwd(q, k, v, scale, causal)
    delta = (do.float() * o.float()).sum(-1)
    bwd = (q, k, v, do, lse, delta, scale, causal)
    fns = {"fwd": lambda: k2.flash_fwd(q, k, v, scale, causal),
           "dq": lambda: k2.flash_dq(*bwd), "dkv": lambda: k2.flash_dkv(*bwd)}
    out = {name: round(min(time_cuda(fn, reps) for _ in range(3)), 4)
           for name, fn in fns.items()}
    if not library:
        return out
    backend = ("flash" if dtype != torch.float32 and d <= 256
               else "efficient")
    lib_fwd, lib_bwd = library_calls(*lib_args, b=bh // HEADS,
                                     backend=backend)
    plain = {"fwd": lambda: k2.flash_fwd_ref(q, k, v, scale, causal),
             "dq": lambda: k2.flash_dq_ref(*bwd),
             "dkv": lambda: k2.flash_dkv_ref(*bwd)}
    for name in fns:
        kind = bound_kind(name, dtype, q.shape[2])
        bound, by = roofline.bound_ms(*k2.flash_work(name, *shape, dtype),
                                      kind)
        out[name] = dict(
            ms=out[name], plain_ms=round(time_cuda(plain[name], 5), 4),
            bound_ms=round(bound, 4), bound_by=by, kind=kind,
            library_ms=round(min(time_cuda(lib_fwd if name == "fwd"
                                           else lib_bwd, reps)
                                 for _ in range(3)), 4))
    return out


def refused_or(fn, *args, **kwargs):
    """fn's result, or "refused: ..." where the checkout's kernels refuse
    the shape or route (older checkouts, other routes)."""
    try:
        return fn(*args, **kwargs)
    except (ValueError, RuntimeError) as e:
        return f"refused: {e}"


def launch_counts() -> dict:
    """K2's launches since the last reset, and by design where the
    checkout counts them."""
    designs = getattr(k2, "DESIGN_LAUNCHES", {})
    return dict(launches=dict(k2.LAUNCHES),
                by_design={key: {d: n for d, n in c.items() if n}
                           for key, c in designs.items()})


def lm_step_ms(widths: dict = LM_F32, steps: int = 3) -> dict:
    """One float32 training step of the LM at ``widths``: host ms (the
    mean of ``steps`` after a warm-up step), the loss, and K2's launches
    in the timed steps."""
    from ccv_tpu_torch.bin import lm_bench
    from ccv_tpu_torch.models import transformer as tfm
    from ccv_tpu_torch.nn import optimizers
    c = dict(widths)
    batch = c.pop("batch")
    cfg = tfm.TransformerConfig(**c, dropout=0.0, dtype=torch.float32,
                                remat=True, remat_policy="dots")
    dev = torch.device("cuda")
    params = tfm.init_lm(torch.Generator(device=dev).manual_seed(6), cfg)
    opt = optimizers.adam(rate=1e-4)
    state = opt.init(params)
    ids = torch.randint(0, cfg.vocab_size, (batch, cfg.max_len + 1),
                        generator=torch.Generator(device=dev).manual_seed(7),
                        device=dev)
    loss = float(lm_bench.train_step(params, opt, state, cfg, ids))
    torch.cuda.synchronize()
    k2.reset_launches()
    t0 = time.perf_counter()
    for _ in range(steps):
        loss = float(lm_bench.train_step(params, opt, state, cfg, ids))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    return dict(ms=round(ms, 2), loss=round(loss, 5), steps=steps,
                **launch_counts())


def fit_step_ms(steps: int = 5) -> dict:
    """One float32 ``Model.fit`` of FIT_F32's attention model (seeded as
    chip_smoke.py phase 31's): host ms (the mean of ``steps`` after a
    warm-up fit), the loss, and K2's launches in the timed fits."""
    from ccv_tpu_torch.nn import functional as F
    from ccv_tpu_torch.nn import layers as L
    from ccv_tpu_torch.nn import optimizers
    b, t, d, heads, hd = FIT_F32
    inp = F.Input()
    a = L.ScaledDotProductAttention(heads, hd, is_causal=True)(
        L.LayerNorm(name="ln")(inp))
    model = F.Model([inp], [F.Add()(inp, a)], name="attention")
    dev = torch.device("cuda")
    model.build((b, t, d), torch.Generator().manual_seed(4), device=dev)
    model.compile(optimizers.adamw(rate=1e-4), "mse")
    rng = np.random.default_rng(31)
    x, y = (torch.from_numpy(rng.normal(0, 1, (b, t, d)).astype(np.float32))
            .to(dev) for _ in range(2))
    model.fit(x, y)
    torch.cuda.synchronize()
    k2.reset_launches()
    t0 = time.perf_counter()
    for _ in range(steps):
        loss = float(model.fit(x, y))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    return dict(ms=round(ms, 3), loss=round(loss, 6), steps=steps,
                **launch_counts())


def kernel_name(mangled: str) -> tuple:
    """(kernel, type or None, head dim or None) of a mangled kernel name
    such as ``..._cu_2e7b489815dkv_sm90_kernelI13__nv_bfloat16Li256EE...``
    or, untemplated, ``..._cu_1a2b3c4d13fwd_tc_kernelEPKfS1_...``: the
    kernel's name is the one its length prefix spells out; older kernels
    were templates on the head dim alone."""
    end = mangled.index("_kernel") + len("_kernel")
    name = next(mangled[end - n:end] for n in range(6, end)
                if mangled[:end - n].endswith(str(n))
                and mangled[end - n].isalpha())
    args = re.match(r"I(?:\d*_*(?!Li)(\w+?))?(?:Li(\d+))?E", mangled[end:])
    if args is None:
        return name, None, None
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
    ap.add_argument("--library", action="store_true")
    ap.add_argument("--lm", action="store_true")
    ap.add_argument("--ptxas", action="store_true")
    args = ap.parse_args()
    k2.build()
    out = {"label": args.label}
    for shape in SHAPES:
        out[f"D{shape[3]}"] = refused_or(kernel_ms, shape)
    for dtype, shape in WIDE_SHAPES:
        out[f"{KINDS[dtype]}_D{shape[3]}"] = refused_or(
            kernel_ms, shape, dtype, reps=5, library=args.library)
    for key, pad in (("f32_D32", None), ("f32_D32_pad64", 64)):
        out[key] = refused_or(kernel_ms, D32_SHAPE, torch.float32, reps=5,
                              library=args.library, pad_to=pad)
    if args.lm:
        out["lm_f32_d256"] = lm_step_ms(LM_F32)
        out["lm_f32_d128"] = lm_step_ms(LM_F32_D128)
        out["fit_f32_d64"] = fit_step_ms()
    if args.ptxas:
        out["ptxas"] = {src: ptxas(src) for src in SOURCES
                        if (_build.CSRC / src).exists()}
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
