"""Port parity: the ten CLIs of the slice on the CPU, each against its
ccv_tpu twin in bin/ on the same inputs.

- bbfcreate: the loaded patches equal, and the output directory byte-equal
  (cascade.txt and stage-N.txt) from the same image folders; bbfvldtr: the
  same line;
- swtcreate: the same text from the same list and search (both searches
  start from a bad min_height: from the defaults the crop is read
  perfectly and nothing moves); swtvldtr: the same three lines;
- dpmcreate: the same text and a model within 1e-3 of ccv_tpu's at a small
  setting (no relabel: the roots, the parts and the drift estimate);
  dpmext and dpmvldtr: the same text;
- aflw: the same files, their pixels equal (the port's PNG encoder writes
  other deflate bytes than PIL's, so the pixels are compared, as both
  packages read them back); draw: the same echoed text and pixels;
  kmeans1d: the same centroids at a small n and the same line format.
"""

import contextlib
import dataclasses
import io
import os
import re
import runpy
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from ccv_tpu.core import io as jio
from ccv_tpu.core.numeric import kmeans1d as j_kmeans1d
from ccv_tpu_torch.bin import (aflw, bbfcreate, bbfvldtr, dpmcreate, dpmext,
                               dpmvldtr, draw, icfcreate, kmeans1d,
                               swtcreate, swtvldtr)
from ccv_tpu_torch.core import io as tio
from ccv_tpu_torch.detectors import dpm as tdpm
from ccv_tpu_torch.detectors import swt as tswt
from test_train_bbf import _patches
from test_train_dpm import _scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
NEW_MODULES = ("train.bbf", "train.swt", "train.dpm", "bin.bbfcreate",
               "bin.bbfvldtr", "bin.swtcreate", "bin.swtvldtr",
               "bin.dpmcreate", "bin.dpmext", "bin.dpmvldtr", "bin.aflw",
               "bin.draw", "bin.kmeans1d")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this file runs: the port's many small CPU
    ops crawl when the test workers' thread pools contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_new_modules_import_without_jax():
    probe = ("import importlib, sys\n"
             f"for m in {NEW_MODULES!r}:\n"
             "    importlib.import_module('ccv_tpu_torch.' + m)\n"
             "print(sorted(m for m in sys.modules\n"
             "             if m.split('.')[0] in ('jax', 'jaxlib', "
             "'ccv_tpu')))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def image_folders(root):
    """30 x 30 positives (INTER_AREA to 24 x 24) and 64 x 80 negatives
    (8 random crops each) as PNG files."""
    rng = np.random.default_rng(11)
    pos, neg = os.path.join(root, "pos"), os.path.join(root, "neg")
    os.makedirs(pos)
    os.makedirs(neg)
    for i, p in enumerate(_patches(40, rng, True)):
        big = np.asarray(Image.fromarray(p).resize((30, 30)))
        Image.fromarray(big).save(os.path.join(pos, f"{i:03d}.png"))
    for i in range(12):
        img = np.clip(rng.normal(140, 30, (64, 80)), 0, 255).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(neg, f"{i:03d}.png"))
    Image.fromarray(np.zeros((20, 20), np.uint8)).save(
        os.path.join(neg, "small.png"))    # no crop fits: none drawn
    return pos, neg


def captured(fn, *args, stdin=None):
    out = io.StringIO()
    mp = pytest.MonkeyPatch()
    if stdin is not None:
        mp.setattr(sys, "stdin", io.StringIO(stdin))
    try:
        with contextlib.redirect_stdout(out):
            fn(*args)
    finally:
        mp.undo()
    return out.getvalue()


def run_ccv_tpu(script, argv, stdin=None):
    """bin/<script> of ccv_tpu run as a script: its standard output."""
    mp = pytest.MonkeyPatch()
    mp.setattr(sys, "argv", [script] + argv)
    try:
        return captured(runpy.run_path, os.path.join(ROOT, "bin", script),
                        {}, "__main__", stdin=stdin)
    finally:
        mp.undo()


def test_load_dir_equals_ccv_tpu(tmp_path):
    pos, neg = image_folders(str(tmp_path))
    ref_load = runpy.run_path(os.path.join(ROOT, "bin", "bbfcreate.py"),
                              run_name="bbfcreate_ref")["_load_dir"]
    for path, crop in ((pos, False), (neg, True)):
        got = icfcreate.load_dir(path, (24, 24), crop=crop,
                                 flags=tio.IO_GRAY)
        want = ref_load(path, (24, 24), crop=crop)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_bbfcreate_output_byte_equal(tmp_path):
    pos, neg = image_folders(str(tmp_path))
    flags = ["--stages", "2", "--features-per-stage", "4"]
    a, b = str(tmp_path / "port"), str(tmp_path / "ref")
    out_a = captured(bbfcreate.main, [pos, neg, a, *flags, "--device", "cpu"])
    out_b = run_ccv_tpu("bbfcreate.py", [pos, neg, b, *flags])
    assert out_a == out_b.replace(b, a)
    assert out_a.startswith("40 positives, 96 negative patches\n")
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for n in os.listdir(b):
        with open(os.path.join(a, n), "rb") as fa, \
                open(os.path.join(b, n), "rb") as fb:
            assert fa.read() == fb.read(), n


def test_bbfvldtr_prints_as_ccv_tpu(tmp_path):
    truth = tmp_path / "truth.txt"
    est = tmp_path / "est.txt"
    # two faces by their six landmarks; one found, one missed, one false
    truth.write_text(
        "a.png 20 20 40 20 30 30 22 40 30 41 38 40\n"
        "a.png 120 20 140 20 130 30 122 40 130 41 138 40\n"
        "B.jpg 10 10 20 10 15 15 11 20 15 21 19 20\n"
        "short line\n")
    est.write_text("a.png 14 10 34 36\nA.png 200 200 20 20\n"
                   "b.png 5 5 20 20\n")
    got = captured(bbfvldtr.main, [str(truth), str(est)])
    assert got == run_ccv_tpu("bbfvldtr.py", [str(truth), str(est)])
    assert got == "66.67% (1)\n"
    assert bbfvldtr.main([str(truth)]) == 2


# -- swtcreate / swtvldtr ----------------------------------------------------

CROP = (80, 170, 30, 460)       # rows, then columns, of text_test.png
BAD = 60                        # a min_height that finds nothing


def bad_start(module, params):
    """``module.optimize_params`` made to start from min_height BAD (the
    CLIs start from the default SwtParams)."""
    optimize = module.optimize_params

    def start(*args, **kwargs):
        return optimize(*args, base=params(min_height=BAD), **kwargs)
    return start


def test_swtcreate_prints_as_ccv_tpu(tmp_path, monkeypatch):
    from ccv_tpu.detectors import swt as jswt
    from ccv_tpu.train import swt as jtrain
    from ccv_tpu_torch.train import swt as ttrain

    y0, y1, x0, x1 = CROP
    img = tio.read(os.path.join(DATA, "text_test.png"), device="cpu").numpy()
    Image.fromarray(img[y0:y1, x0:x1]).save(str(tmp_path / "crop.png"))
    (tmp_path / "crop.txt").write_text(f"{54 - x0} {109 - y0} 385 37\n")
    lst = tmp_path / "list.txt"
    lst.write_text(f"{tmp_path / 'crop.png'} {tmp_path / 'crop.txt'}\n"
                   "a line without its truth\n")
    search = [str(lst), "--min-height", "8,26,34", "--iterations", "1"]
    monkeypatch.setattr(ttrain, "optimize_params",
                        bad_start(ttrain, tswt.SwtParams))
    monkeypatch.setattr(jtrain, "optimize_params",
                        bad_start(jtrain, jswt.SwtParams))
    got = captured(swtcreate.main, search + ["--device", "cpu"])
    assert got == run_ccv_tpu("swtcreate.py", search)
    lines = got.splitlines()
    assert lines[:2] == ["1 images; searching ['min_height']", "best params:"]
    fields = [f.name for f in dataclasses.fields(tswt.SwtParams)]
    assert [line.split(" = ")[0].strip() for line in lines[2:]] == fields
    assert "  min_height = 8" in lines


def test_swtvldtr_prints_as_ccv_tpu(tmp_path):
    truth, est = tmp_path / "truth.txt", tmp_path / "est.txt"
    truth.write_text("img1.png\n10 10 50 20\n100 10 40 20\nimg2.png\n"
                     "0 0 100 20\n")
    est.write_text("img1.png\n11 11 49 19\n300 300 5 5\nimg2.png\n"
                   "0 0 45 20\n50 0 50 20\n")
    got = captured(swtvldtr.main, [str(truth), str(est)])
    assert got == run_ccv_tpu("swtvldtr.py", [str(truth), str(est)])
    assert [line.split(":")[0] for line in got.splitlines()] == [
        "precision", "recall", "harmonic mean"]
    assert swtvldtr.main([str(truth)]) == 2


# -- dpmcreate / dpmext / dpmvldtr --------------------------------------------

DPM_FLAGS = ["--negative-count", "8", "--model-part", "4", "--relabels", "0",
             "--data-minings", "0", "--iterations", "1",
             "--negative-cache-size", "8"]


def test_dpmcreate_as_ccv_tpu(tmp_path):
    rng = np.random.default_rng(17)
    pos_lines, bg_lines = [], []
    for i in range(3):
        img, (x, y, w, h) = _scene(rng, obj=True, size=160, osize=56)
        path = str(tmp_path / f"pos{i}.png")
        Image.fromarray(img).save(path)
        pos_lines.append(f"{path} {x} {y} {w} {h}\n")
    for i in range(3):
        path = str(tmp_path / f"bg{i}.png")
        Image.fromarray(_scene(rng, obj=False, size=160)[0]).save(path)
        bg_lines.append(path + "\n")
    (tmp_path / "pos.txt").write_text("".join(pos_lines) + "short 1 2\n")
    (tmp_path / "bg.txt").write_text("".join(bg_lines) + "\n")
    lists = ["--positive-list", str(tmp_path / "pos.txt"),
             "--background-list", str(tmp_path / "bg.txt")]
    a, b = str(tmp_path / "port"), str(tmp_path / "ref")
    got = captured(dpmcreate.main, lists + ["--working-dir", a, *DPM_FLAGS,
                                            "--device", "cpu"])
    want = run_ccv_tpu("dpmcreate.py", lists + ["--working-dir", b,
                                                *DPM_FLAGS])
    assert got == want.replace(b, a)
    assert got.startswith("3 positives, 3 backgrounds\n")
    assert sorted(os.listdir(a)) == sorted(os.listdir(b)) == [
        "init.model", "model"]
    mine = tdpm.read_mixture_model(os.path.join(a, "model"))
    ref = tdpm.read_mixture_model(os.path.join(b, "model"))
    for r, q in zip(mine.roots, ref.roots):
        scale = np.abs(q.w).max()
        assert r.w.shape == q.w.shape == (7, 7, 31)
        assert np.abs(r.w - q.w).max() <= 1e-3 * scale
        np.testing.assert_allclose(r.alpha, q.alpha, atol=1e-3)
        for p, s in zip(r.parts, q.parts):
            assert (p.x, p.y, p.w.shape, p.counterpart) == (
                s.x, s.y, s.w.shape, s.counterpart)
            assert np.abs(p.w - s.w).max() <= 1e-3 * scale
            np.testing.assert_allclose(p.alpha, s.alpha, atol=1e-3)


VOC = {
    "000012.txt": ("# PASCAL Annotation Version 1.00\n"
                   'Image filename : "VOC2007/JPEGImages/000012.jpg"\n'
                   "Image size (X x Y x C) : 500 x 333 x 3\n"
                   'Original label for object 1 "PAScar" : "PAScar"\n'
                   'Bounding box for object 1 "PAScar" (Xmin, Ymin) - '
                   "(Xmax, Ymax) : (156, 97) - (351, 270)\n"),
    "000005.txt": ('Image filename : "VOC2007/JPEGImages/000005.jpg"\n'
                   'Bounding box for object 2 "PASperson" (Xmin, Ymin) - '
                   "(Xmax, Ymax) : (10, 20) - (60, 140)\n"
                   'Bounding box for object 1 "PASperson" (Xmin, Ymin) - '
                   "(Xmax, Ymax) : (263, 211) - (324, 339)\n"
                   "# a comment: Bounding box for nothing\n"),
}


def voc_dir(root):
    d = os.path.join(root, "Annotations")
    os.makedirs(d)
    for name, text in VOC.items():
        with open(os.path.join(d, name), "w") as f:
            f.write(text)
    return d


def test_dpmext_prints_as_ccv_tpu(tmp_path):
    d = voc_dir(str(tmp_path))
    got = captured(dpmext.main, [d])
    assert got == run_ccv_tpu("dpmext.py", [d])
    assert got == ("000005.jpg 263 211 61 128\n000005.jpg 10 20 50 120\n"
                   "000012.jpg 156 97 195 173\n")
    assert dpmext.main([]) == 2


def test_dpmvldtr_prints_as_ccv_tpu(tmp_path):
    d = voc_dir(str(tmp_path))
    est = tmp_path / "est.txt"
    est.write_text("| a header line\n000012.jpg 150 90 200 180 0.9\n"
                   "000012.jpg 150 90 200 180 0.8\n"
                   "dir/000005.jpg 263 211 61 128 0.7\n"
                   "000005.jpg 400 10 30 30 0.1\n\n")
    got = captured(dpmvldtr.main, [d, str(est)])
    assert got == run_ccv_tpu("dpmvldtr.py", [d, str(est)])
    assert got == "66.67% (1)\n"
    assert dpmvldtr.main([d]) == 2


# -- aflw / draw / kmeans1d ---------------------------------------------------

AFLW = ("crop180.png 40 30 90 90 0.1 -0.2 0.05\n"      # down: INTER_AREA
        "crop120.png 30 20 30 30 0.0 0.0 0.0\n"         # up: INTER_CUBIC
        "crop180.png -10 150 60 60 0.2 0.1 -0.1\n"      # past the corner
        "crop120.png 10 10 40 40 0.0 0.5 0.0\n"         # pitch: not frontal
        "crop120.png 10 10 12 12 0.0 0.0 0.0\n"         # too small
        "text_test.png 100 100 50 50 0.0 0.0 0.36\n"    # yaw just past 20
        "a line that is not an annotation\n")


def pixels(path):
    with Image.open(path) as im:
        return im.mode, np.asarray(im)


def test_aflw_as_ccv_tpu(tmp_path):
    ann = tmp_path / "ann.txt"
    ann.write_text(AFLW)
    a, b = str(tmp_path / "port"), str(tmp_path / "ref")
    got = captured(aflw.main, [str(ann), DATA, a, "--seed", "4",
                               "--device", "cpu"])
    want = run_ccv_tpu("aflw.py", [str(ann), DATA, b, "--seed", "4"])
    assert got == want.replace(b, a) == f"wrote 3 crops to {a}\n"
    names = sorted(os.listdir(b))
    assert sorted(os.listdir(a)) == names == [
        f"aflw-{i:07d}-{s}.png" for i in range(3) for s in ("bw", "rgb")]
    for n in names:
        (mode_a, pa), (mode_b, pb) = (pixels(os.path.join(a, n)),
                                      pixels(os.path.join(b, n)))
        assert mode_a == mode_b == ("L" if "-bw" in n else "RGB")
        assert pa.shape[:2] == (48, 48)
        assert pa.tobytes() == pb.tobytes(), n
        np.testing.assert_array_equal(
            tio.read(os.path.join(a, n), device="cpu").numpy(),
            jio.read(os.path.join(b, n)).numpy())


def test_aflw_rejects_a_rect_that_is_not_square():
    with pytest.raises(ValueError, match="square"):
        aflw.slice_with_rect(np.random.default_rng(0),
                             torch.zeros(20, 20, dtype=torch.uint8),
                             (0, 0, 10, 12))
    assert aflw.frontal(0.1, -0.3, 0.2, 20, 20)
    assert not aflw.frontal(0.0, 0.0, 0.4, 20, 20)


def test_draw_as_ccv_tpu(tmp_path):
    lines = ("10 12 40 30 0.9\n-5 -5 20 20\n170 170 30 30\nnot a rect\n"
             "\ntotal : 3 in time 12ms\n")
    img = os.path.join(DATA, "crop180.png")
    a, b = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    got = captured(draw.main, [img, a], stdin=lines)
    assert got == run_ccv_tpu("draw.py", [img, b], stdin=lines) == lines
    (mode_a, pa), (mode_b, pb) = pixels(a), pixels(b)
    assert mode_a == mode_b == "RGB"
    assert pa.tobytes() == pb.tobytes()
    assert (pa[12, 10:51] == 255).all() and (pa[0, 0:16] == 255).all()
    assert draw.main([img]) == 2


@pytest.mark.parametrize("n,k", [(2000, 16), (777, 5), (64, 64)])
def test_kmeans1d_as_ccv_tpu(n, k):
    clusters, centroids, ms = kmeans1d.run(n, k)
    a = np.random.default_rng(0).uniform(0.0, 1.0, n).astype(np.float32)
    want_c, want = j_kmeans1d(a, k)
    np.testing.assert_array_equal(clusters, want_c)
    np.testing.assert_allclose(centroids, want, rtol=1e-12)
    assert len(centroids) == k and ms >= 0


def test_kmeans1d_prints_as_ccv_tpu():
    got = captured(kmeans1d.main, ["3000", "8"])
    want = run_ccv_tpu("kmeans1d.py", ["3000", "8"])
    pattern = re.compile(r"^elapsed: \d+ms\n$")
    assert pattern.match(got) and pattern.match(want), (got, want)
