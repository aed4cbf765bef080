"""The port stands alone: importing every module of ccv_tpu_torch loads
neither jax nor ccv_tpu."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import importlib, pkgutil, sys
import ccv_tpu_torch
names = sorted(m.name for m in pkgutil.walk_packages(ccv_tpu_torch.__path__,
                                                    "ccv_tpu_torch."))
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "ccv_tpu"))
print(len(names), leaked)
print(" ".join(names))
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    counts, names = out.stdout.splitlines()
    n, leaked = counts.split(" ", 1)
    assert int(n) >= 50, out.stdout  # every module was found and imported
    assert leaked.strip() == "[]", leaked
    # the staged SCD path's modules, the pyramids, the scorers, the
    # server, the JPEG decoder's binding and build, the classification
    # path, the NLP CLIs, and ICF, SWT and SIFT with their ops and CLIs
    # among them
    assert {"ccv_tpu_torch.detectors.scd",
            "ccv_tpu_torch.ops.kernels.scd_phase",
            "ccv_tpu_torch.ops.pyramid", "ccv_tpu_torch.utils.deteval",
            "ccv_tpu_torch.serve.server", "ccv_tpu_torch.core.native",
            "ccv_tpu_torch._native_build", "ccv_tpu_torch.nn.layers",
            "ccv_tpu_torch.nn.model", "ccv_tpu_torch.nn.tensor_io",
            "ccv_tpu_torch.models.vgg", "ccv_tpu_torch.models.convnet",
            "ccv_tpu_torch.bin.cnnclassify",
            "ccv_tpu_torch.bin.vgg_bench", "ccv_tpu_torch.bin.wmt",
            "ccv_tpu_torch.bin.iwslt", "ccv_tpu_torch.bin.imdb",
            "ccv_tpu_torch.bin.bin_imdb_shared",
            "ccv_tpu_torch.bin.wmt_grad_trial",
            "ccv_tpu_torch.detectors.icf", "ccv_tpu_torch.detectors.swt",
            "ccv_tpu_torch.detectors.sift", "ccv_tpu_torch.core.algebra",
            "ccv_tpu_torch.ops.classic", "ccv_tpu_torch.bin.icfdetect",
            "ccv_tpu_torch.bin.swtdetect",
            "ccv_tpu_torch.bin.siftmatch"} <= set(names.split())


def test_package_data_holds_every_native_source():
    """Every file of ccv_tpu_torch/csrc (the CUDA kernels, their headers, the
    host C++ of the JPEG decoder, SWT and MSER / MSCR) matches a glob of the
    port's package-data entry, so an installed port can build them."""
    import fnmatch
    import tomllib

    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        globs = tomllib.load(f)["tool"]["setuptools"]["package-data"][
            "ccv_tpu_torch"]
    csrc = os.path.join(ROOT, "ccv_tpu_torch", "csrc")
    files = sorted(os.listdir(csrc))
    assert {"ccv_tpu_mser.cpp", "ccv_tpu_mscr.cpp", "scd_planes.cuh",
            "image_decode.cpp", "ccv_tpu_native.cpp"} <= set(files)
    missing = [f for f in files
               if not any(fnmatch.fnmatch(f"csrc/{f}", g) for g in globs)]
    assert missing == [], (missing, globs)


def test_slice_modules_import_alone():
    """This slice's modules are among those the probe imports."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    counts, names = out.stdout.splitlines()
    assert counts.split(" ", 1)[1].strip() == "[]", counts
    assert {"ccv_tpu_torch.detectors.bbf", "ccv_tpu_torch.detectors.dpm",
            "ccv_tpu_torch.detectors.mser", "ccv_tpu_torch.detectors.daisy",
            "ccv_tpu_torch.detectors.ferns", "ccv_tpu_torch.detectors.tld",
            "ccv_tpu_torch.ops.transform", "ccv_tpu_torch.bin.bbfdetect",
            "ccv_tpu_torch.bin.dpmdetect", "ccv_tpu_torch.bin.msermatch",
            "ccv_tpu_torch.bin.tld",
            # the classic surface
            "ccv_tpu_torch.compat", "ccv_tpu_torch.core.cache",
            "ccv_tpu_torch.core.numeric", "ccv_tpu_torch.core.util",
            "ccv_tpu_torch.ops.color", "ccv_tpu_torch.utils.flags",
            "ccv_tpu_torch.utils.log",
            "ccv_tpu_torch.utils.profiler"} <= set(names.split())
    from ccv_tpu_torch.ops import classic
    assert callable(classic.hog)
    assert callable(classic.optical_flow_lucas_kanade)


def test_training_slice_modules_import_alone():
    """The training slice's modules (the dynamic graph, micro ops, the
    dataframe, the coco / imdb_lstm / csvtool twins) are among those the
    probe imports without jax, and chip_smoke.py imports neither jax nor
    ccv_tpu at any level."""
    import ast

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    counts, names = out.stdout.splitlines()
    assert counts.split(" ", 1)[1].strip() == "[]", counts
    assert {"ccv_tpu_torch.nn.dynamic", "ccv_tpu_torch.nn.micro",
            "ccv_tpu_torch.nn.dataframe", "ccv_tpu_torch.nn.optimizers",
            "ccv_tpu_torch.bin.coco", "ccv_tpu_torch.bin.imdb_lstm",
            "ccv_tpu_torch.bin.csvtool"} <= set(names.split())
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert not roots & {"jax", "jaxlib", "ccv_tpu", "bin"}, roots
