"""Port parity: the subpackages re-export what ccv_tpu's do.

Each of ``core``, ``ops``, ``nn``, ``models`` and ``detectors`` of the port
has ccv_tpu's ``__all__``, and every name resolves, after a plain ``import
ccv_tpu_torch.<sub>`` in a fresh process that loads neither jax nor
ccv_tpu, to the port's counterpart of ccv_tpu's object (the module of the
same path, or the class or function of the same name and module).
"""

import importlib
import json
import os
import subprocess
import sys
import types

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBPACKAGES = ("core", "ops", "nn", "models", "detectors")

PROBE = """
import importlib, json, sys, types
out = {}
for sub in %r:
    m = importlib.import_module("ccv_tpu_torch." + sub)
    out[sub] = {"__all__": list(m.__all__), "names": {
        name: (getattr(m, name).__name__ if isinstance(getattr(m, name),
               types.ModuleType) else getattr(m, name).__module__ + "."
               + getattr(m, name).__name__)
        for name in m.__all__}}
out["leaked"] = sorted(k for k in sys.modules
                       if k.split(".")[0] in ("jax", "jaxlib", "ccv_tpu"))
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def port():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", PROBE % (SUBPACKAGES,)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.splitlines()[-1])


def test_fresh_import_loads_no_jax(port):
    assert port["leaked"] == []


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_reexports_ccv_tpu_s_names(port, sub):
    ref = importlib.import_module(f"ccv_tpu.{sub}")
    assert port[sub]["__all__"] == list(ref.__all__)
    for name in ref.__all__:
        obj = getattr(ref, name)
        want = (obj.__name__ if isinstance(obj, types.ModuleType)
                else f"{obj.__module__}.{obj.__name__}")
        assert port[sub]["names"][name] == want.replace(
            "ccv_tpu.", "ccv_tpu_torch.", 1), (sub, name)
