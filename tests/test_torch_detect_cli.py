"""The port's detector CLI twins on the CPU (ccv_tpu_torch/bin/icfdetect.py,
swtdetect.py and siftmatch.py): each prints the lines of its bin/ twin for
what the port's detector returns on the same input, and needs a card unless
``--device cpu`` is given."""

import os
import re
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

from ccv_tpu_torch.bin import icfdetect, siftmatch, swtdetect
from ccv_tpu_torch.core import io as tio
from ccv_tpu_torch.detectors import icf, sift, swt
from test_torch_icf import synth_cascade

DATA = os.path.join(os.path.dirname(__file__), "data")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CROP = os.path.join(DATA, "crop180.png")
TEXT = os.path.join(DATA, "text_test.png")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def gray_png(a: np.ndarray) -> bytes:
    """An 8-bit gray PNG of ``a``."""
    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    raw = b"".join(b"\x00" + row.tobytes() for row in a.astype(np.uint8))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", a.shape[1], a.shape[0],
                                         8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@pytest.fixture(scope="module")
def cascade_file(tmp_path_factory):
    """test_torch_icf's seeded synthetic cascade (120 trees: phases A and
    B1) whose last threshold keeps a few windows of crop180 at default
    params."""
    casc = icf.cascade_from_jax(synth_cascade(np.random.default_rng(21),
                                              120, False))
    img = tio.read(CROP, tio.IO_RGB_COLOR, device="cpu")
    conf = np.sort([c.confidence for c in icf.detect_objects(
        img, casc, icf.IcfParams(min_neighbors=0))])
    i = int(0.98 * len(conf))
    casc.thresholds[-1] = (conf[i] + conf[i + 1]) / 2
    path = str(tmp_path_factory.mktemp("icf") / "synthetic.icf")
    icf.write_cascade(casc, path)
    return path


def _lines(capsys):
    return capsys.readouterr().out.strip().splitlines()


def test_icfdetect(cascade_file, capsys):
    assert icfdetect.main([CROP, cascade_file, "--device", "cpu"]) == 0
    lines = _lines(capsys)
    want = icf.detect_objects(tio.read(CROP, tio.IO_RGB_COLOR, device="cpu"),
                              icf.load_cascade(cascade_file))
    assert len(want) > 0
    assert lines[:-1] == [f"{int(c.x)} {int(c.y)} {int(c.width)} "
                          f"{int(c.height)} {c.confidence:f}" for c in want]
    assert re.fullmatch(rf"total : {len(want)} in time \d+ms", lines[-1])


def test_swtdetect_as_a_program():
    out = subprocess.run(
        [sys.executable, "-m", "ccv_tpu_torch.bin.swtdetect", TEXT,
         "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=REPO), timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    want = swt.detect_words(tio.read(TEXT, tio.IO_GRAY, device="cpu"))
    assert lines[:-1] == [f"{int(w.x)} {int(w.y)} {int(w.width)} "
                          f"{int(w.height)}" for w in want]
    assert re.fullmatch(r"total : 2 in time \d+ms", lines[-1])


def test_siftmatch(tmp_path, capsys):
    text = np.array(tio.read(TEXT, tio.IO_GRAY, device="cpu").numpy())
    scene = text[96:224, 32:160]
    paths = []
    for name, a in (("object", scene[20:92, 16:112]), ("scene", scene)):
        paths.append(str(tmp_path / f"{name}.png"))
        with open(paths[-1], "wb") as f:
            f.write(gray_png(a))
    assert siftmatch.main(paths + ["--device", "cpu"]) == 0
    lines = _lines(capsys)
    k1, d1 = sift.sift(torch.from_numpy(np.ascontiguousarray(
        scene[20:92, 16:112])))
    k2, d2 = sift.sift(torch.from_numpy(np.ascontiguousarray(scene)))
    idx, ok = sift.match(d1, d2, device="cpu")
    want = [f"{k1[i]['x']:.2f} {k1[i]['y']:.2f} => {k2[j]['x']:.2f} "
            f"{k2[j]['y']:.2f}" for i, (j, m) in enumerate(zip(idx, ok)) if m]
    assert len(want) > 5
    assert lines[:-2] == want
    assert lines[-2] == f"{len(want)} keypoints out of {len(k1)} are matched"
    assert re.fullmatch(r"elpased time : \d+", lines[-1])


@pytest.mark.parametrize("tool,args", [
    (icfdetect, [CROP, "cascade"]), (swtdetect, [TEXT]),
    (siftmatch, [TEXT, TEXT])], ids=["icfdetect", "swtdetect", "siftmatch"])
def test_needs_a_card_by_default(tool, args, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device is required"):
        tool.main(args)
