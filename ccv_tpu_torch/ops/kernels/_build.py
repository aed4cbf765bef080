"""Builds the port's CUDA sources into plain-C shared libraries on first use.

Each library is compiled with nvcc for Hopper (``sm_90a``) from the sources
in ``ccv_tpu_torch/csrc`` into ``ccv_tpu_torch/_build`` (not committed) and
loaded with ctypes. The file name carries a hash of the sources, the
shared headers (``csrc/*.cuh``) and the flags (a library's own flags
too), so an edited source is
rebuilt and a fresh checkout builds
everything it calls. Nothing here runs at import time: the CPU tests import
every module on machines with no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

PACKAGE = Path(__file__).resolve().parents[2]
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_loaded: Dict[str, ctypes.CDLL] = {}
_locks: Dict[str, threading.Lock] = {}   # one per library: builds overlap
_locks_lock = threading.Lock()


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, then $PATH, then the toolkit's usual place."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.isfile(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _key(sources: Sequence[Path], flags: Sequence[str]) -> str:
    h = hashlib.sha256(" ".join([*NVCC_FLAGS, *flags]).encode())
    for src in [*sources, *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def load_library(name: str, sources: Sequence[str],
                 flags: Sequence[str] = ()) -> ctypes.CDLL:
    """The ctypes handle of lib<name>, built from ``csrc/<sources>`` with
    ``flags`` (such as ``-D`` definitions) after NVCC_FLAGS. Different
    libraries may be built from different threads at once."""
    with _locks_lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        paths = [CSRC / s for s in sources]
        so = BUILD_DIR / f"lib{name}-{_key(paths, flags)}.so"
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, *flags, "-o", str(tmp),
                   *(str(p) for p in paths)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed building lib{name} (exit "
                    f"{proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        _loaded[name] = lib
        return lib
