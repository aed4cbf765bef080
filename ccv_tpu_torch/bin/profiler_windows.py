"""Which torch.profiler windows keep their device events late in a process?

A diagnostic for the profiled phases of ``chip_smoke.py``: in a process
that has profiled once and then left the card busy and idle for a while,
a window can lose the first device records it should hold. Each run opens
one window in a fresh process, then (after 10 s of busy card and 10 s of
host sleep) windows of several contents, and prints per window the kernels
it launched and the kernels the profiler kept (spin kernels of
``torch.cuda._sleep`` counted apart). It repeats that under
``DISABLE_CUPTI_LAZY_REINIT=1``. Needs a CUDA device::

    python -m ccv_tpu_torch.bin.profiler_windows
"""

import os
import subprocess
import sys
import time

SPIN = 20_000_000  # cycles of torch.cuda._sleep: a ~10 ms kernel


def run_child():
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    a = torch.randn(1024, 1024, device=dev)
    big = torch.randn(8192, 8192, device=dev)

    def window(body, cuda_only=False):
        acts = [ProfilerActivity.CUDA] if cuda_only else [
            ProfilerActivity.CPU, ProfilerActivity.CUDA]
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            body()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
        spin = sum(e.count for e in ev if "spin_kernel" in e.key)
        return sum(e.count for e in ev) - spin, spin

    def paused(pre, post):
        def body():
            time.sleep(pre)
            a @ a
            torch.cuda.synchronize()
            time.sleep(post)
        return body

    def spin_then_small():
        torch.cuda._sleep(SPIN)
        a @ a

    def small_then_spin():
        a @ a
        torch.cuda._sleep(SPIN)

    def small_pause_big():
        a @ a
        torch.cuda.synchronize()
        time.sleep(0.1)
        big @ big

    def smalls(n, spin_before=0, spin_after=0):
        def body():
            for _ in range(spin_before):
                torch.cuda._sleep(1000)
            for _ in range(n):
                a @ a
            for _ in range(spin_after):
                torch.cuda._sleep(1000)
        return body

    # (name, body, kernels launched (spin kernels apart), CUDA activity
    # only)
    cases = [
        ("one matmul", smalls(1), 1, False),
        ("one matmul again", smalls(1), 1, False),
        ("one matmul, CUDA activity only", smalls(1), 1, True),
        ("0.25 s pause, one matmul, 1 s pause", paused(0.25, 1.0), 1, False),
        ("0.25 s pause, one matmul, 3 s pause", paused(0.25, 3.0), 1, False),
        ("10 ms spin kernel, one matmul", spin_then_small, 1, False),
        ("one matmul, 10 ms spin kernel", small_then_spin, 1, False),
        ("one matmul, 0.1 s pause, one 8192^2 matmul", small_pause_big, 2,
         False),
        ("2 matmuls", smalls(2), 2, False),
        ("8 matmuls", smalls(8), 8, False),
        ("24 matmuls", smalls(24), 24, False),
        ("96 matmuls", smalls(96), 96, False),
        ("1000 short spin kernels, then 8 matmuls", smalls(8, 1000), 8,
         False),
        ("8 matmuls, then 1000 short spin kernels", smalls(8, 0, 1000), 8,
         False),
        ("one matmul", smalls(1), 1, False),
    ]
    print(f"first window of the process, one matmul: kept (matmuls, spin "
          f"kernels) {window(smalls(1))} of 1", flush=True)
    end = time.perf_counter() + 10
    while time.perf_counter() < end:
        for _ in range(20):
            big @ big
        torch.cuda.synchronize()
    time.sleep(10)
    for name, body, n, cuda_only in cases:
        print(f"after 10 s busy and 10 s idle, {name}: kept (others, spin "
              f"kernels) {window(body, cuda_only)} of {n}", flush=True)


def main():
    import torch
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}",
          flush=True)
    for extra in ({}, {"DISABLE_CUPTI_LAZY_REINIT": "1"}):
        print(f"-- environment {extra or 'as is'}", flush=True)
        r = subprocess.run([sys.executable, "-m", __spec__.name, "--child"],
                           env=dict(os.environ, **extra), timeout=600)
        if r.returncode:
            return r.returncode
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--child"]:
        run_child()
    else:
        sys.exit(main())
