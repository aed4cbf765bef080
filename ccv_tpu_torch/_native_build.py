"""Builds the port's native sources into plain-C shared libraries on first use.

A library is compiled from sources in ``ccv_tpu_torch/csrc`` into
``ccv_tpu_torch/_build`` (not committed) and loaded with ctypes: host C++
such as the JPEG decoder with g++ (``load_host_library``), CUDA kernels with
nvcc through ``ccv_tpu_torch.ops.kernels._build``. The file name carries a
hash of the sources, the headers they include and the flags, so an edited
source is rebuilt and a fresh checkout builds everything it calls. A build
that failed is not retried in the same process: each later call raises the
same error. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, List, Sequence

PACKAGE = Path(__file__).resolve().parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_build"

HOST_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

_loaded: Dict[str, ctypes.CDLL] = {}
_failed: Dict[str, RuntimeError] = {}
_locks: Dict[str, threading.Lock] = {}   # one per library: builds overlap
_locks_lock = threading.Lock()


def _key(files: Sequence[Path], flags: Sequence[str]) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for src in files:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def load(name: str, sources: Sequence[str],
         command: Callable[[Path, Sequence[Path]], List[str]],
         key_flags: Sequence[str], headers: str = "") -> ctypes.CDLL:
    """lib<name> built by ``command(output, sources)`` unless a library of
    the same sources, ``csrc`` headers matching the glob ``headers`` and
    ``key_flags`` is built already. A loaded library costs two locks and a
    dict lookup: kernel wrappers call this on every launch."""
    with _locks_lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        if name in _failed:
            raise _failed[name]
        paths = [CSRC / s for s in sources]
        deps = [*paths, *(sorted(CSRC.glob(headers)) if headers else ())]
        so = BUILD_DIR / f"lib{name}-{_key(deps, key_flags)}.so"
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = command(tmp, paths)
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                _failed[name] = RuntimeError(
                    f"{os.path.basename(cmd[0])} failed building lib{name} "
                    f"(exit {proc.returncode}):\n{' '.join(cmd)}\n"
                    f"{proc.stderr}")
                raise _failed[name]
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        _loaded[name] = lib
        return lib


def load_host_library(name: str, sources: Sequence[str],
                      libs: Sequence[str] = ()) -> ctypes.CDLL:
    """The ctypes handle of lib<name>, host C++ built from
    ``csrc/<sources>`` with g++ (``$CXX`` if set) and HOST_FLAGS, linked
    against ``libs`` (such as ``-ljpeg``)."""
    cxx = os.environ.get("CXX", "g++")
    return load(name, sources, lambda out, paths: [
        cxx, *HOST_FLAGS, "-o", str(out), *(str(p) for p in paths), *libs],
        [cxx, *HOST_FLAGS, *libs])
