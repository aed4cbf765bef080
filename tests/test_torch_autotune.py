"""Port parity: nn/autotune (ccv_nnc_cmd_autotune's analog) in torch terms,
its key and store against ccv_tpu's, and core.algebra's ``sat_mxu`` and
``sat_auto``. Last, the slice's modules import no jax."""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccv_tpu.core import algebra as jalgebra
from ccv_tpu.nn import autotune as jautotune
from ccv_tpu_torch.core import algebra
from ccv_tpu_torch.nn import autotune

DATA = os.path.join(os.path.dirname(__file__), "data")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _isolated_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("CCV_TPU_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))
    monkeypatch.setattr(autotune, "_MEM", None)
    monkeypatch.setattr(jautotune, "_MEM", None)
    yield


def _slow(x):
    # an expensive variant with the same result: 60 sorts against one
    y = x
    for _ in range(60):
        y = torch.sort(y).values
    return y + torch.sum(x) * 0.0


def _fast(x):
    return torch.sort(x).values


def test_choose_picks_faster_variant_and_persists():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096)
                         .astype(np.float32))
    fn = autotune.choose("sorty", {"slow": _slow, "fast": _fast}, (x,))
    assert fn is _fast
    table = autotune.decisions()
    (key, rec), = table.items()
    assert rec["choice"] == "fast"
    assert rec["ms"]["slow"] > rec["ms"]["fast"] > 0
    assert "float32[4096]" in key
    # a fresh process (memory cleared) reloads the decision from disk
    autotune._MEM = None
    with open(autotune.cache_path()) as f:
        assert json.load(f)[key]["choice"] == "fast"
    fn2 = autotune.choose("sorty", {"slow": _slow, "fast": _fast}, (x,))
    assert fn2 is _fast


def test_choose_under_tracing_uses_cache_or_default(monkeypatch):
    """Under torch.compile (``torch.compiler.is_compiling``) a miss returns
    the default and keeps nothing; a kept winner is still found."""
    x = torch.zeros(512)
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    fn = autotune.choose("traced-op", {"a": _fast, "b": _slow}, (x,),
                         default="b")
    assert fn is _slow and autotune.decisions() == {}
    autotune.measure("traced-op", {"a": _fast, "b": _slow}, lambda: (x,))
    fn = autotune.choose("traced-op", {"a": _fast, "b": _slow}, (x,),
                         default="b")
    assert fn is _fast


def test_key_distinguishes_shape_dtype_and_extra():
    a = torch.zeros(64)
    b = torch.zeros(128)
    c = torch.zeros(64, dtype=torch.bfloat16)
    keys = {autotune._key("op", (t,), "") for t in (a, b, c)}
    assert len(keys) == 3
    assert autotune._key("op", (a,), "causal=True") != \
        autotune._key("op", (a,), "causal=False")


def test_failing_variant_never_wins():
    def broken(x):
        raise RuntimeError("no lowering")

    x = torch.zeros(32)
    fn = autotune.choose("maybe", {"broken": broken, "ok": _fast}, (x,),
                         default="broken")
    assert fn is _fast
    rec = next(iter(autotune.decisions().values()))
    assert rec["ms"]["broken"] is None
    assert "no lowering" in rec["errors"]["broken"]


def test_env_disable_skips_measurement(monkeypatch):
    monkeypatch.setenv("CCV_TPU_AUTOTUNE", "0")
    x = torch.zeros(32)
    fn = autotune.choose("gated", {"a": _slow, "b": _fast}, (x,),
                         default="a")
    assert fn is _slow
    assert autotune.decisions() == {}


def test_stats_accounting():
    before = autotune.stats()
    x = torch.zeros(32)
    autotune.choose("acct", {"a": _slow, "b": _fast}, (x,))  # a miss
    d1 = autotune.stats_delta(before)
    assert d1["measured"] == 1
    autotune.choose("acct", {"a": _slow, "b": _fast}, (x,))  # a hit
    d2 = autotune.stats_delta(before)
    assert d2["measured"] == 1 and d2["hits"] == d1["hits"] + 1


@pytest.mark.parametrize("shape,tdt,jdt", [
    ((4096,), torch.float32, jnp.float32), ((3, 5, 8), torch.uint8,
                                            jnp.uint8),
    ((), torch.float32, jnp.float32), ((7, 9), torch.bfloat16, jnp.bfloat16),
    ((2, 3), torch.int32, jnp.int32)])
def test_key_equals_ccv_tpu_s(shape, tdt, jdt):
    """The same op, shapes, dtypes and extra give ccv_tpu's key; the device
    field is the device kind, "cpu" on both here."""
    t = (torch.zeros(shape, dtype=tdt), torch.zeros((), dtype=torch.float32),
         3)
    j = (jnp.zeros(shape, jdt), jnp.zeros((), jnp.float32), 3)
    got = autotune._key("scd_octave_exact", t, "o180x180g33x33s4n6b0v5")
    want = jautotune._key("scd_octave_exact", j, "o180x180g33x33s4n6b0v5")
    assert got == want
    assert got.split("|")[1] == "cpu"


def test_store_written_by_ccv_tpu_loads_in_the_port():
    x = np.random.default_rng(1).standard_normal(2048).astype(np.float32)
    jautotune.measure("sorty", {"slow": lambda v: jnp.sort(jnp.sort(v)),
                                "fast": jnp.sort}, lambda: (jnp.asarray(x),))
    want = jautotune.recorded("sorty", (jnp.asarray(x),))
    autotune.measure("other", {"a": _fast, "b": _slow},
                     lambda: (torch.zeros(8),))  # merges into the file
    autotune._MEM = None
    assert autotune.recorded("sorty", (torch.from_numpy(x),)) == want
    before = autotune.stats()
    autotune.choose("sorty", {"slow": _slow, "fast": _fast},
                    (torch.from_numpy(x),))
    assert autotune.stats_delta(before) == {"hits": 1, "measured": 0}
    with open(autotune.cache_path()) as f:
        assert len(json.load(f)) == 2


def test_cache_path_default_is_the_port_s_own(monkeypatch):
    monkeypatch.delenv("CCV_TPU_AUTOTUNE_CACHE")
    assert autotune.cache_path() == os.path.join(REPO, "ccv_tpu_torch",
                                                 "autotune.json")


# -- sat_mxu and sat_auto ----------------------------------------------------

@pytest.mark.parametrize("shape", [(37, 53, 10), (61, 29), (1, 17, 3)])
@pytest.mark.parametrize("padding", [algebra.NO_PADDING,
                                     algebra.PADDING_ZERO])
def test_sat_mxu_matches_ccv_tpu(shape, padding):
    x = (np.random.default_rng(2).random(shape) * 255).astype(np.float32)
    want = np.asarray(jalgebra.sat_mxu(jnp.asarray(x), padding))
    got = algebra.sat_mxu(torch.from_numpy(x), padding).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    ref = algebra.sat(torch.from_numpy(x), padding).numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_sat_mxu_refuses_integers_and_4d():
    with pytest.raises(TypeError):
        algebra.sat_mxu(torch.zeros((4, 4), dtype=torch.int32))
    with pytest.raises(ValueError):
        algebra.sat_mxu(torch.zeros((2, 4, 4, 3)))


def test_sat_auto_takes_sat_and_records_nothing(monkeypatch):
    """Integers, more than 3 dims, a CPU tensor and CCV_TPU_SAT=sat take
    ``sat`` (bit for bit) and keep no decision; CCV_TPU_SAT=sat_mxu forces
    the matrix form."""
    rng = np.random.default_rng(3)
    xf = torch.from_numpy((rng.random((23, 31, 4)) * 99).astype(np.float32))
    xi = torch.from_numpy(rng.integers(0, 255, (23, 31), dtype=np.uint8))
    x4 = xf[None].repeat(2, 1, 1, 1)
    for x in (xf, xi, x4):
        for pad in (algebra.NO_PADDING, algebra.PADDING_ZERO):
            assert torch.equal(algebra.sat_auto(x, pad), algebra.sat(x, pad))
    monkeypatch.setenv("CCV_TPU_SAT", "sat")
    assert torch.equal(algebra.sat_auto(xf, 1), algebra.sat(xf, 1))
    monkeypatch.setenv("CCV_TPU_SAT", "sat_mxu")
    assert torch.equal(algebra.sat_auto(xf, 1), algebra.sat_mxu(xf, 1))
    assert torch.equal(algebra.sat_auto(xi), algebra.sat(xi))
    assert autotune.decisions() == {}
    assert autotune.stats_delta({"hits": 0, "measured": 0}) == \
        autotune.stats()


def test_sat_auto_measures_on_the_card(monkeypatch):
    """On the card (the device test patched) sat_auto asks autotune with op
    ``sat``, extra ``pad{padding}``, default ``sat_mxu``, and runs the
    variant it gets at the padding asked."""
    asked = []

    def choose(op, variants, args, default=None, extra=""):
        asked.append((op, sorted(variants), default, extra))
        return variants["sat_mxu"]

    x = torch.from_numpy(np.random.default_rng(4).random((9, 11, 2))
                         .astype(np.float32))
    monkeypatch.setattr(autotune, "choose", choose)
    monkeypatch.setattr(algebra, "_on_card", lambda t: True)
    got = algebra.sat_auto(x, algebra.PADDING_ZERO)
    assert asked == [("sat", ["sat", "sat_mxu"], "sat_mxu", "pad1")]
    assert torch.equal(got, algebra.sat_mxu(x, algebra.PADDING_ZERO))


# -- the slice stands alone --------------------------------------------------

def test_slice_imports_no_jax():
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from ccv_tpu_torch.nn import autotune\n"
        "from ccv_tpu_torch.models import supervised_train, "
        "ConvnetTrainParams\n"
        "from ccv_tpu_torch.bin import cifar_10, image_net, cnnvldtr\n"
        "from ccv_tpu_torch.core.io import read, IO_RGB_COLOR\n"
        "from ccv_tpu_torch.detectors import scd\n"
        "net = cifar_10.cifar10_net(device='cpu')\n"
        "rng = np.random.default_rng(0)\n"
        "x = rng.integers(0, 256, (8, 31, 31, 3), dtype=np.uint8)\n"
        "h = supervised_train(net, x, np.arange(8) % 10, "
        "ConvnetTrainParams(max_epoch=1, mini_batch=4))\n"
        "assert len(h) == 1 and np.isfinite(h[0][0]), h\n"
        f"img = read({os.path.join(DATA, 'crop180.png')!r}, IO_RGB_COLOR, "
        "device='cpu')\n"
        f"c = scd.load_cascade({os.path.join(DATA, 'face_low.sqlite3')!r})\n"
        "out = scd.detect(img, c, scd.ScdParams(interval=1), form='auto')\n"
        "assert len(out) == 1, out\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'ccv_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
