"""Port parity: core/io.write (PNG written by the port itself, CCVBINDM)
and bin/msermatch's out.png, on the CPU, against ccv_tpu.

- a PNG the port writes reads back to the same pixels through ccv_tpu's
  reader (libpng or PIL) and the port's own decoder: gray, RGB, gray +
  alpha, RGBA, odd widths, and float pixels rounded and clamped as
  ccv_tpu's write does;
- CCVBINDM written by each package reads back equal in the other,
  including the 4-byte step padding of odd widths, byte for byte the
  same file;
- .jpg / .jpeg raise, naming the missing encoder, and write nothing;
- ``python -m ccv_tpu_torch.bin.msermatch crop120.png out.png`` writes
  bin/msermatch.py's out.png pixel for pixel.
"""

import os
import runpy
import sys

import numpy as np
import pytest

from ccv_tpu.core import io as jio
from ccv_tpu_torch.bin import msermatch
from ccv_tpu_torch.core import io as tio
from ccv_tpu_torch.core.dense_matrix import from_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")


@pytest.mark.parametrize("shape", [(5, 7), (6, 9, 3), (3, 11, 3), (4, 3, 4),
                                   (1, 1)])
def test_png_reads_back_in_both_packages(tmp_path, shape):
    rng = np.random.default_rng(sum(shape))
    arr = rng.integers(0, 256, shape, dtype=np.uint8)
    path = str(tmp_path / "img.png")
    tio.write(from_numpy(arr, device="cpu"), path)
    mine = tio.read(path, device="cpu").numpy()
    theirs = jio.read(path).numpy()
    if arr.ndim == 2 or arr.shape[2] == 3:
        np.testing.assert_array_equal(mine, arr)
        np.testing.assert_array_equal(theirs, arr)
    else:  # alpha dropped by both readers
        np.testing.assert_array_equal(mine, arr[..., :3])
        np.testing.assert_array_equal(theirs, arr[..., :3])


def test_png_gray_alpha(tmp_path):
    """Two channels are written as gray + alpha: PIL reads them back as
    written; the port's reader drops the alpha and keeps the gray, as
    ccv_tpu's libpng route does (png_set_strip_alpha), with no flag, with
    IO_GRAY and with IO_RGB_COLOR (the gray stacked to RGB), byte for
    byte equal to ccv_tpu.core.io.read of the same file."""
    from PIL import Image
    from ccv_tpu.core import native
    assert native.decode_image(os.path.join(DATA, "crop120.png")), \
        "ccv_tpu's native libpng decoder is not built"
    arr = np.random.default_rng(5).integers(0, 256, (5, 7, 2), np.uint8)
    path = str(tmp_path / "la.png")
    tio.write(arr, path)
    with Image.open(path) as im:
        assert im.mode == "LA"
        np.testing.assert_array_equal(np.asarray(im), arr)
    for t_flag, j_flag in ((0, 0), (tio.IO_GRAY, jio.IO_GRAY),
                           (tio.IO_RGB_COLOR, jio.IO_RGB_COLOR)):
        mine = tio.read(path, t_flag, device="cpu").numpy()
        theirs = jio.read(path, j_flag).numpy()
        assert mine.shape == theirs.shape and mine.dtype == theirs.dtype
        assert mine.tobytes() == theirs.tobytes()
        gray = arr[..., 0]
        np.testing.assert_array_equal(
            mine, np.stack([gray] * 3, -1) if t_flag == tio.IO_RGB_COLOR
            else gray)


def test_png_of_float_and_gray_flag(tmp_path):
    f = np.linspace(-20, 300, 6 * 7 * 3).reshape(6, 7, 3).astype(np.float32)
    mine, theirs = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    tio.write(f, mine)
    jio.write(f, theirs)
    np.testing.assert_array_equal(tio.read(mine, device="cpu").numpy(),
                                  jio.read(theirs).numpy())
    np.testing.assert_array_equal(
        tio.read(mine, tio.IO_GRAY, device="cpu").numpy(),
        jio.read(mine, jio.IO_GRAY).numpy())


ARRAYS = [np.arange(15, dtype=np.uint8).reshape(3, 5),
          np.arange(35, dtype=np.uint8).reshape(5, 7),
          np.arange(60, dtype=np.int32).reshape(4, 5, 3),
          np.linspace(0, 1, 24, dtype=np.float32).reshape(4, 6),
          np.linspace(-3, 3, 27).reshape(3, 3, 3)]


@pytest.mark.parametrize("arr", ARRAYS, ids=lambda a: f"{a.dtype}-{a.shape}")
def test_ccvbindm_both_ways(tmp_path, arr):
    mine, theirs = str(tmp_path / "a.bin"), str(tmp_path / "b.bin")
    tio.write(arr, mine)
    jio.write_ccv_binary(arr, theirs)
    with open(mine, "rb") as f1, open(theirs, "rb") as f2:
        assert f1.read() == f2.read()
    back = jio.read(mine).numpy()  # float64 comes back as float32 there
    np.testing.assert_array_equal(back, arr.astype(back.dtype))
    np.testing.assert_array_equal(tio.read(theirs, device="cpu").numpy(), arr)
    tio.write(arr, str(tmp_path / "c"), format="binary")
    np.testing.assert_array_equal(
        tio.read(str(tmp_path / "c"), device="cpu").numpy(), arr)


@pytest.mark.parametrize("name", ["out.jpg", "out.JPEG"])
def test_jpeg_raises(tmp_path, name):
    """JPEG (and GIF) are saved by PIL, as ccv_tpu saves them: the same
    bytes as ccv_tpu's write; an extension PIL does not know raises, as it
    does in ccv_tpu, and writes nothing."""
    arr = np.random.default_rng(7).integers(0, 256, (4, 4), np.uint8)
    for out in (name, "out.gif"):
        mine, theirs = tmp_path / out, tmp_path / f"jax-{out}"
        tio.write(arr, str(mine))
        jio.write(arr, str(theirs))
        assert mine.read_bytes() == theirs.read_bytes()
    path = tmp_path / "out.nosuchformat"
    with pytest.raises(ValueError):
        tio.write(arr, str(path))
    with pytest.raises(ValueError):
        jio.write(arr, str(tmp_path / "jax-out.nosuchformat"))


def test_msermatch_out_png_equals_the_jax_cli(tmp_path, monkeypatch,
                                              capsys):
    image = os.path.join(DATA, "crop120.png")
    mine, theirs = str(tmp_path / "mine.png"), str(tmp_path / "jax.png")
    assert msermatch.main([image, mine, "--device", "cpu"]) == 0
    monkeypatch.setattr(sys, "argv", ["msermatch.py", image, theirs])
    runpy.run_path(os.path.join(ROOT, "bin", "msermatch.py"),
                   run_name="__main__")
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].split(" in ")[0] == lines[1].split(" in ")[0]
    want = jio.read(theirs).numpy()
    assert want.shape == (120, 120, 3) and (want[..., 0] != want[..., 1]).any()
    np.testing.assert_array_equal(tio.read(mine, device="cpu").numpy(), want)
