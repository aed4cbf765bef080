"""Port parity: the SCD face-detection main path.

Goldens (tests/data, made with the C implementation; see tests/test_scd.py):
crop180.scdmap.bin (the feature map); the window goldens crop180.scd_i1.txt
and crop180.scd_open.txt gate detect in tests/test_torch_scd_slow_paths.py,
which holds this slice's two longest tests so that a run spread over files
can spread them. The port is also held against ccv_tpu's own functions on
the same inputs.
"""

import dataclasses
import os
import shutil
import sqlite3
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccv_tpu.core import io as jio
from ccv_tpu.detectors import common as jcommon
from ccv_tpu.detectors import scd as jscd
from ccv_tpu.ops import resample as jresample
from ccv_tpu_torch import device as tdevice
from ccv_tpu_torch.bin import scddetect
from ccv_tpu_torch.core import io as tio
from ccv_tpu_torch.detectors import common as tcommon
from ccv_tpu_torch.detectors import scd as tscd
from ccv_tpu_torch.ops.kernels import scd_cascade as tkernel

DATA = os.path.join(os.path.dirname(__file__), "data")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASCADE = os.path.join(DATA, "face_low.sqlite3")
THREADS = torch.get_num_threads()


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One torch intra-op thread in each test: the suite runs in several
    worker processes, whose thread pools oversubscribe the cores
    (tests/test_torch_scd_staged.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def crop():
    return tio.read(os.path.join(DATA, "crop180.png"), tio.IO_RGB_COLOR,
                    device="cpu")


@pytest.fixture(scope="module")
def cascade():
    return tscd.load_cascade(CASCADE)


def test_scd_map_cf8_matches_golden(crop):
    golden = tio.read(os.path.join(DATA, "crop180.scdmap.bin"),
                      device="cpu").numpy()
    got = tscd.scd_map_cf8(crop.tensor).numpy()
    assert got.shape == (8,) + golden.shape[:2]
    np.testing.assert_array_equal(got, golden[..., :8].transpose(2, 0, 1))


@pytest.mark.parametrize("name,flags", [("crop180.png", jio.IO_RGB_COLOR),
                                        ("text_test.png", 0),
                                        ("crop120.png", jio.IO_RGB_COLOR)])
def test_scd_map_cf8_matches_jax(name, flags):
    img = np.array(jio.read(os.path.join(DATA, name), flags).numpy())
    if img.ndim == 2:
        img = img[..., None]
    want = np.asarray(jscd.scd_map_cf8(jnp.asarray(img)))
    got = tscd.scd_map_cf8(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(got, want)


def test_sat_cf8_matches_jax():
    x = np.random.default_rng(3).integers(-600, 600, (8, 97, 131)).astype(
        np.float32)
    x[4:] = np.abs(x[4:])
    want = np.asarray(jscd._sat_cf8(jnp.asarray(x)))
    got = tscd._sat_cf8(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (8, 98, 132)
    # summation order differs (cumsum vs a triangular matmul): 1e-6 of the
    # largest magnitude
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    assert not got[:, 0].any() and not got[:, :, 0].any()


@pytest.mark.parametrize("H,W", [(180, 180), (480, 640), (1080, 1920),
                                 (47, 300), (97, 61)])
@pytest.mark.parametrize("interval,step", [(5, 4), (1, 4), (3, 2)])
def test_level_specs_match_jax(cascade, H, W, interval, step):
    jc = jscd.load_cascade(CASCADE)
    params = dict(interval=interval, step_through=step)
    assert tscd._level_specs(H, W, cascade, tscd.ScdParams(**params)) == \
        jscd._level_specs(H, W, jc, jscd.ScdParams(**params))


def test_merge_detections_matches_jax():
    rng = np.random.default_rng(9)
    rects = []
    for _ in range(120):
        x, y = rng.integers(0, 200, 2)
        s = int(rng.integers(20, 60))
        # coarse confidences force ties: the first maximum must win
        rects.append((int(x), int(y), s, s, float(rng.integers(0, 6)) / 2,
                      int(rng.integers(1, 3))))
    for min_neighbors in (0, 1, 2, 3):
        want = jcommon.merge_detections(
            [jcommon.Comp(*r[:5], classification_id=r[5]) for r in rects],
            min_neighbors)
        got = tcommon.merge_detections(
            [tcommon.Comp(*r[:5], classification_id=r[5]) for r in rects],
            min_neighbors)
        assert [dataclasses.astuple(c) for c in got] == \
            [dataclasses.astuple(c) for c in want]


@pytest.fixture(scope="module")
def jax_detections():
    img = jio.read(os.path.join(DATA, "crop180.png"), jio.IO_RGB_COLOR)
    jc = jscd.load_cascade(CASCADE)
    return {mn: jscd.detect(img.array, jc, jscd.ScdParams(
        min_neighbors=mn, interval=1)) for mn in (0, 1)}


@pytest.mark.parametrize("min_neighbors", [0, 1])
def test_detect_matches_jax(crop, cascade, jax_detections, min_neighbors):
    """The slice end to end: same boxes in the same order, neighbors equal,
    confidences within 6e-3 (ccv_tpu's CPU path sums boxes by a matmul)."""
    got = tscd.detect(crop, cascade, tscd.ScdParams(
        min_neighbors=min_neighbors, interval=1))
    want = jax_detections[min_neighbors]
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g.x, g.y, g.width, g.height, g.neighbors) == \
            (w.x, w.y, w.width, w.height, w.neighbors)
        assert abs(g.confidence - w.confidence) < 6e-3


def test_detect_async_collect_equals_detect(crop, cascade):
    params = tscd.ScdParams(min_neighbors=0, interval=1)
    handle = tscd.detect_async(crop, cascade, params)
    planes = tscd.level_planes(handle)
    assert [p.shape for p, _c in planes] == [
        (ny, nx) for (*_r, ny, nx, _s) in handle.specs]
    assert tscd.detect_collect(handle) == tscd.detect(crop, cascade, params)


def test_scd_map_matches_golden(crop):
    """The 11-channel map against the C golden, with tests/test_scd.py's
    gate: the gradient channels exact, L, U and V within 1e-4 (the
    cube-root LUT)."""
    golden = tio.read(os.path.join(DATA, "crop180.scdmap.bin"),
                      device="cpu").numpy()
    got = tscd.scd_map(crop.tensor).numpy()
    assert got.shape == golden.shape and got.dtype == np.float32
    np.testing.assert_array_equal(got[..., :8], golden[..., :8])
    np.testing.assert_allclose(got[..., 8:], golden[..., 8:], atol=1e-4)


@pytest.mark.parametrize("name,flags", [("crop180.png", jio.IO_RGB_COLOR),
                                        ("crop120.png", jio.IO_GRAY),
                                        ("text_test.png", 0)])
def test_scd_map_matches_jax(name, flags):
    img = np.array(jio.read(os.path.join(DATA, name), flags).numpy())
    want = np.asarray(jscd.scd_map(jnp.asarray(img)))
    got = tscd.scd_map(torch.from_numpy(img)).numpy()
    assert got.shape == want.shape == img.shape[:2] + (11,)
    np.testing.assert_array_equal(got[..., :8], want[..., :8])
    np.testing.assert_allclose(got[..., 8:], want[..., 8:], atol=1e-4)
    if img.ndim == 2:  # gray: [gray / 255, 0, 0]
        np.testing.assert_array_equal(got[..., 8], img / np.float32(255))
        assert not got[..., 9:].any()


def test_luv_matches_jax():
    rgb = np.random.default_rng(4).random((37, 29, 3)).astype(np.float32)
    rgb[0, :3] = 0.0  # black: the denominator's floor
    rgb[1, :3] = 1.0
    want = jscd._luv(jnp.asarray(rgb))
    got = tscd._luv(torch.from_numpy(rgb))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)


# The up-scaled detect (ScdParams(size=(24, 24)) with the 48x48 cascade:
# crop180 becomes 360x360) at interval 1, with face_low's last stage
# threshold raised to UP_LAST_THRESHOLD so that 151 of its 10,414 windows
# pass (the threshold sits in a gap 0.019 wide between two windows' sums),
# which keeps the O(n^2) merge of min_neighbors=1 small in both packages.
UP_PARAMS = dict(size=(24, 24), interval=1)
UP_LAST_THRESHOLD = -4.0586


def raised_cascade(path, last_threshold):
    """A copy of face_low.sqlite3 at ``path`` with its last stage's
    threshold set to ``last_threshold``."""
    shutil.copy(CASCADE, path)
    con = sqlite3.connect(path)
    try:
        n = con.execute("SELECT MAX(classifier) FROM classifier_params"
                        ).fetchone()[0]
        con.execute("UPDATE classifier_params SET threshold = ? WHERE "
                    "classifier = ?", (last_threshold, n))
        con.commit()
    finally:
        con.close()
    return str(path)


@pytest.fixture(scope="module")
def up_cascade(tmp_path_factory):
    return raised_cascade(tmp_path_factory.mktemp("up") / "face.sqlite3",
                          UP_LAST_THRESHOLD)


@pytest.fixture(scope="module")
def jax_upscaled(up_cascade):
    img = jio.read(os.path.join(DATA, "crop180.png"), jio.IO_RGB_COLOR)
    jc = jscd.load_cascade(up_cascade)
    return {mn: jscd.detect(img.array, jc, jscd.ScdParams(
        min_neighbors=mn, **UP_PARAMS)) for mn in (0, 1)}


@pytest.mark.parametrize("form", tscd.FORMS)
@pytest.mark.parametrize("min_neighbors", [0, 1])
def test_upscaled_detect_matches_jax(crop, up_cascade, jax_upscaled, form,
                                     min_neighbors):
    """Both forms on the up-scaled image: the same rects (in the original
    image's coordinates) and neighbors as ccv_tpu, conf within 2e-4 +
    1e-5 |conf|."""
    params = tscd.ScdParams(min_neighbors=min_neighbors, **UP_PARAMS)
    torch.set_num_threads(1)
    try:
        got = tscd.detect(crop, tscd.load_cascade(up_cascade), params,
                          form=form)
    finally:
        torch.set_num_threads(THREADS)
    want = {(c.x, c.y, c.width, c.height): c
            for c in jax_upscaled[min_neighbors]}
    mine = {(c.x, c.y, c.width, c.height): c for c in got}
    assert len(mine) == len(got) and set(mine) == set(want)
    assert 10 <= len(jax_upscaled[0]) <= 200
    assert min(r[2] for r in mine) < 48  # windows finer than the cascade
    for r, w in want.items():
        assert mine[r].neighbors == w.neighbors
        assert abs(mine[r].confidence - w.confidence) <= \
            2e-4 + 1e-5 * abs(w.confidence)


def test_upscaled_image_matches_jax(crop, cascade):
    """detect's up-scale of crop180 (180 -> 360, INTER_CUBIC on uint8)
    equals ccv_tpu's resample bit for bit."""
    params = tscd.ScdParams(**UP_PARAMS)
    assert tscd.up_ratio(cascade, params) == 2.0
    got = tscd._image(crop, cascade, params, None).numpy()
    want = np.asarray(jresample.resample(
        jnp.asarray(crop.numpy()), rows=360, cols=360, rows_scale=2.0,
        cols_scale=2.0, interp=jresample.INTER_CUBIC))
    assert got.dtype == np.uint8 and got.shape == (360, 360, 3)
    np.testing.assert_array_equal(got, want)


def test_detect_launches_no_kernel_on_cpu(crop, cascade):
    before = tkernel.LAUNCHES
    tscd.detect(crop, cascade, tscd.ScdParams(min_neighbors=0, interval=1))
    assert tkernel.LAUNCHES == before


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "from ccv_tpu_torch.core.io import read, IO_RGB_COLOR\n"
        "from ccv_tpu_torch.detectors import scd\n"
        f"img = read({os.path.join(DATA, 'crop180.png')!r}, IO_RGB_COLOR, "
        "device='cpu')\n"
        f"c = scd.load_cascade({CASCADE!r})\n"
        "out = scd.detect(img, c, scd.ScdParams(interval=1))\n"
        "assert len(out) == 1, out\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'ccv_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_scddetect_cli(cascade):
    image = os.path.join(DATA, "crop120.png")
    proc = subprocess.run(
        [sys.executable, "-m", "ccv_tpu_torch.bin.scddetect", image,
         CASCADE, "--device", "cpu"], cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    want = tscd.detect(tio.read(image, tio.IO_RGB_COLOR, device="cpu"),
                       cascade)
    assert lines[-1].startswith(f"total : {len(want)} in time")
    assert [tuple(int(v) for v in ln.split()[:4]) for ln in lines[:-1]] == [
        (c.x, c.y, c.width, c.height) for c in want]


def test_no_card_raises_rather_than_running_on_the_cpu(cascade, monkeypatch):
    """With no card, the default device raises, and so does every entry
    point handed a numpy image or a file and no device; a CPU tensor or an
    explicit device="cpu" is the caller asking for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device is required"):
        tdevice.default_device()
    gray = np.zeros((60, 60), np.uint8)
    for call in (lambda: tscd.detect(gray, cascade),
                 lambda: tscd.detect_async(gray, cascade),
                 lambda: tscd.detect_batch(gray[None], cascade),
                 lambda: scddetect.main([os.path.join(DATA, "crop120.png"),
                                         CASCADE]),
                 lambda: tio.read(os.path.join(DATA, "crop120.png")),
                 lambda: tio.from_numpy(gray)):
        with pytest.raises(RuntimeError, match="CUDA device is required"):
            call()
    on_cpu = tscd.detect(gray, cascade, device="cpu")
    assert len(on_cpu) > 0  # face_low's open thresholds pass windows
    assert tscd.detect(torch.from_numpy(gray), cascade) == on_cpu


def test_scddetect_cpu_in_process_matches_detect(cascade, capsys):
    image = os.path.join(DATA, "crop180.png")
    assert scddetect.main([image, CASCADE, "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    want = tscd.detect(tio.read(image, tio.IO_RGB_COLOR, device="cpu"),
                       cascade)
    assert len(want) > 0
    assert lines[-1].startswith(f"total : {len(want)} in time")
    assert [tuple(int(v) for v in ln.split()[:4]) for ln in lines[:-1]] == [
        (c.x, c.y, c.width, c.height) for c in want]
