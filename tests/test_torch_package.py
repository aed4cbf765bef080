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
