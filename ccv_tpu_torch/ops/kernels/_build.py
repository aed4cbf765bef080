"""Builds the port's CUDA sources into plain-C shared libraries on first use.

Each library is compiled with nvcc for Hopper (``sm_90a``) from the sources
in ``ccv_tpu_torch/csrc`` into ``ccv_tpu_torch/_build`` (not committed) and
loaded with ctypes, through ``ccv_tpu_torch._native_build``. The file name
carries a hash of the sources, the shared headers (``csrc/*.cuh``) and the
flags (a library's own flags too), so an edited source is rebuilt and a
fresh checkout builds everything it calls. Nothing here runs at import
time: the CPU tests import every module on machines with no nvcc.
"""

from __future__ import annotations

import ctypes
import os
import shutil
from typing import Sequence

from ccv_tpu_torch import _native_build
from ccv_tpu_torch._native_build import BUILD_DIR, CSRC  # noqa: F401

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


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


def load_library(name: str, sources: Sequence[str],
                 flags: Sequence[str] = ()) -> ctypes.CDLL:
    """The ctypes handle of lib<name>, built from ``csrc/<sources>`` with
    ``flags`` (such as ``-D`` definitions) after NVCC_FLAGS. Different
    libraries may be built from different threads at once."""
    return _native_build.load(
        name, sources, lambda out, paths: [
            nvcc_path(), *NVCC_FLAGS, *flags, "-o", str(out),
            *(str(p) for p in paths)],
        [*NVCC_FLAGS, *flags], "*.cuh")
