"""Port parity: ICF cascade training (ccv_tpu_torch/train/icf.py) and the
icfcreate / icfoptimize / icfvldtr / icf_profile CLIs.

ICF training draws only from a ``np.random.Generator`` (its random
features), so the port is held to ccv_tpu end to end on the same seeded
numpy patches, on the CPU: equal features, trees and splits, thresholds
and votes within 1e-5, the same written file, and the same thresholds
after ``optimize_soft_cascade``. The feature values are held within 1e-5 of
the largest (the same float32 sums; XLA may contract a product and a sum
into one FMA). The patches are tests/test_train_icf.py's synthetic task (a
bright vertical bar against noise) at 16 x 32.
"""

import os
import runpy
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from ccv_tpu.detectors import icf as jicf
from ccv_tpu.train import icf as J
from ccv_tpu_torch.bin import icf_profile, icfcreate, icfoptimize, icfvldtr
from ccv_tpu_torch.detectors import icf as ticf
from ccv_tpu_torch.train import icf as T

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = (16, 32)
SMALL = dict(size=SIZE, feature_size=400, weak_classifier=12, seed=1)
CASCADE_FIELDS = ("pass_bits", "channel", "sat0", "sat1")
VALUE_FIELDS = ("weigh", "thresholds", "alpha", "beta")


def make_patches(n, size, rng, positive):
    """Positives: a bright vertical bar; negatives: noise."""
    W, H = size
    out = np.zeros((n, H, W, 3), np.uint8)
    for i in range(n):
        img = rng.normal(60, 15, (H, W, 3))
        if positive:
            cx = W // 2 + rng.integers(-2, 3)
            w = max(3, W // 4) + rng.integers(-1, 2)
            img[H // 6: H - H // 6, cx - w // 2: cx + w // 2] += 110
        out[i] = np.clip(img, 0, 255).astype(np.uint8)
    return out


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    return (make_patches(100, SIZE, rng, True),
            make_patches(240, SIZE, rng, False))


@pytest.fixture(scope="module")
def ref(data):
    """ccv_tpu's cascade on the patches (the file's one ccv_tpu run)."""
    return J.train_cascade(*data, J.IcfTrainParams(**SMALL))


@pytest.fixture(scope="module")
def mine(data):
    torch.set_num_threads(1)
    return T.train_cascade(*data, T.IcfTrainParams(**SMALL), "cpu")


def same_cascade(got, want, tol=1e-5):
    assert got.n_weak == want.n_weak
    assert (got.width, got.height, got.grayscale, tuple(got.margin)) == (
        want.width, want.height, want.grayscale, tuple(want.margin))
    for k in CASCADE_FIELDS:
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    for k in VALUE_FIELDS:
        a, b = getattr(got, k), getattr(want, k)
        assert np.abs(a - b).max() <= tol * max(1.0, np.abs(b).max()), k


@pytest.mark.parametrize("params", [SMALL, dict(grayscale=True, seed=4,
                                                feature_size=50),
                                    dict(margin=(2, 1, 3, 4), seed=9,
                                         feature_size=50)],
                         ids=["small", "gray", "margin"])
def test_random_features_equal(params):
    got = T.random_features(T.IcfTrainParams(**params),
                            np.random.default_rng(params["seed"]))
    want = J.random_features(J.IcfTrainParams(**params),
                             np.random.default_rng(params["seed"]))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("gray", [False, True], ids=["rgb", "gray"])
def test_feature_values_match(data, gray):
    params = T.IcfTrainParams(**SMALL, grayscale=gray)
    feats = T.random_features(params, np.random.default_rng(2))
    x = np.concatenate([data[0][:30], data[1][:30]])
    if gray:
        x = x[..., :1]
    got = T.precompute_feature_values(x, feats, "cpu").numpy()
    want = J.precompute_feature_values(x, feats)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_best_split_equal(data):
    feats = T.random_features(T.IcfTrainParams(**SMALL),
                              np.random.default_rng(3))
    x = np.concatenate([data[0][:40], data[1][:60]])
    values = np.array(J.precompute_feature_values(x, feats))
    y = np.arange(100) < 40
    rng = np.random.default_rng(4)
    for weights in (np.where(y, 0.5 / 40, 0.5 / 60), rng.random(100)):
        weights = weights / weights.sum()
        f, thr, pol, err = T._best_split(torch.from_numpy(values), weights,
                                         y)
        f_j, thr_j, pol_j, err_j = J._best_split(values, weights, y)
        assert (f, pol) == (f_j, pol_j)
        assert abs(thr - thr_j) <= 1e-5 * max(1.0, abs(thr_j))
        assert abs(err - err_j) <= 1e-6


def test_train_cascade_equals_ccv_tpu_s(mine, ref):
    same_cascade(mine, ref)


def test_written_files_equal_and_load_in_both(mine, ref, tmp_path):
    """The port writes ccv_tpu's file for the same cascade, and the file
    loads in both packages."""
    ours, theirs = tmp_path / "port.icf", tmp_path / "jax.icf"
    T.write_cascade(mine, str(ours))
    J.write_cascade(ref, str(theirs))
    assert ours.read_text() == theirs.read_text()
    same_cascade(ticf.load_cascade(str(ours)), mine, 0)
    same_cascade(jicf.load_cascade(str(ours)), mine, 0)


def test_optimize_soft_cascade_equals_ccv_tpu_s(mine, ref):
    rng = np.random.default_rng(8)
    vals = make_patches(50, SIZE, rng, True)
    ours = ticf.cascade_from_jax(mine)
    theirs = jicf.IcfCascade(**{**vars(ref), "thresholds":
                                ref.thresholds.copy()})
    T.optimize_soft_cascade(ours, vals, 0.96, "cpu")
    J.optimize_soft_cascade(theirs, vals, 0.96)
    assert np.abs(ours.thresholds - theirs.thresholds).max() <= 1e-5 * max(
        1.0, np.abs(theirs.thresholds).max())
    assert not np.array_equal(ours.thresholds, mine.thresholds)


def test_trained_cascade_detects_the_bar(mine):
    """tests/test_train_icf.py's property on the port's detector."""
    rng = np.random.default_rng(9)
    scene = np.clip(rng.normal(60, 15, (96, 96, 3)), 0, 255).astype(
        np.uint8)
    scene[20:52, 40:56] = make_patches(1, SIZE, np.random.default_rng(3),
                                       True)[0]
    out = ticf.detect_objects(torch.from_numpy(scene), mine,
                              ticf.IcfParams(min_neighbors=0, interval=1))

    def iou(c):
        ix = max(0, min(c.x + c.width, 56) - max(c.x, 40))
        iy = max(0, min(c.y + c.height, 52) - max(c.y, 20))
        inter = ix * iy
        return inter / (c.width * c.height + 16 * 32 - inter)
    assert out and max(iou(c) for c in out) > 0.5


@pytest.fixture(scope="module")
def patch_dirs(tmp_path_factory):
    """Positives at 20 x 40 (resized to 16 x 32) as PNG, BMP and JPEG;
    negatives as 64 x 80 images to crop; validation positives."""
    d = tmp_path_factory.mktemp("icf_cli")
    rng = np.random.default_rng(31)
    out = []
    for name, n, size, positive in (("pos", 36, (20, 40), True),
                                    ("neg", 9, (64, 80), False),
                                    ("val", 12, (20, 40), True)):
        sub = d / name
        sub.mkdir()
        for i, p in enumerate(make_patches(n, size, rng, positive)):
            ext = ("png", "bmp", "jpg")[i % 3]
            Image.fromarray(p).save(str(sub / f"{i:02d}.{ext}"), quality=95)
        out.append(str(sub))
    return out


def test_icfcreate_and_icfoptimize_clis(patch_dirs, tmp_path, capsys):
    """icfcreate writes the cascade train_cascade gives on its loader's
    patches (the loader is ccv_tpu's: decode, resize, seeded crops);
    icfoptimize writes optimize_soft_cascade's thresholds."""
    tool = runpy.run_path(os.path.join(ROOT, "bin", "icfcreate.py"))
    pos = icfcreate.load_dir(patch_dirs[0], SIZE)
    neg = icfcreate.load_dir(patch_dirs[1], SIZE, crop=True)
    np.testing.assert_array_equal(pos, tool["_load_dir"](patch_dirs[0], SIZE))
    np.testing.assert_array_equal(
        neg, tool["_load_dir"](patch_dirs[1], SIZE, crop=True))
    out = str(tmp_path / "cli.icf")
    assert icfcreate.main([patch_dirs[0], patch_dirs[1], out, "--size",
                           "16", "32", "--feature-size", "300",
                           "--weak-classifier", "6", "--device",
                           "cpu"]) == 0
    assert "36 positives, 72 negative patches" in capsys.readouterr().out
    want = T.train_cascade(pos, neg, T.IcfTrainParams(
        size=SIZE, feature_size=300, weak_classifier=6), "cpu")
    same_cascade(ticf.load_cascade(out), want, 0)
    opt = str(tmp_path / "opt.icf")
    assert icfoptimize.main([out, patch_dirs[2], opt, "--accept", "0.9",
                             "--device", "cpu"]) == 0
    T.optimize_soft_cascade(want, icfcreate.load_dir(patch_dirs[2], SIZE),
                            0.9, "cpu")
    same_cascade(ticf.load_cascade(opt), want, 0)


def test_icfvldtr_equals_ccv_tpu_s(tmp_path, monkeypatch, capsys):
    voc = tmp_path / "voc"
    voc.mkdir()
    boxes = {"a.png": [(10, 10, 50, 90), (100, 20, 140, 100)],
             "b.png": [(5, 5, 45, 85)]}
    for name, bs in boxes.items():
        lines = [f'Image filename : "PennFudanPed/PNGImages/{name}"']
        lines += [f"Bounding box for object {i + 1} \"PASpersonWalking\" "
                  f"(Xmin, Ymin) - (Xmax, Ymax) : ({x0}, {y0}) - ({x1}, {y1})"
                  for i, (x0, y0, x1, y1) in enumerate(bs)]
        (voc / f"{name[0]}.txt").write_text("\n".join(lines) + "\n")
    est = tmp_path / "est.txt"
    est.write_text("| a header line\na.png 12 11 38 80 1.5\n"
                   "a.png 300 300 20 40 0.1\nb.png 60 60 10 10 0.2\n"
                   "b.png 6 4 40 82 2.0\n")
    assert icfvldtr.main([str(voc), str(est)]) == 0
    ours = capsys.readouterr().out
    sys.path.insert(0, os.path.join(ROOT, "bin"))
    try:
        tool = runpy.run_path(os.path.join(ROOT, "bin", "dpmvldtr.py"))
    finally:
        sys.path.remove(os.path.join(ROOT, "bin"))
    monkeypatch.setattr(sys, "argv", ["icfvldtr.py", str(voc), str(est)])
    tool["main"]()
    assert ours == capsys.readouterr().out
    assert ours.strip() == "66.67% (2)"


def test_icf_profile_on_the_cpu(mine, tmp_path, capsys):
    path = str(tmp_path / "bar.icf")
    T.write_cascade(mine, path)
    scene = np.clip(np.random.default_rng(2).normal(60, 15, (64, 48, 3)),
                    0, 255).astype(np.uint8)
    Image.fromarray(scene).save(str(tmp_path / "scene.png"))
    assert icf_profile.main([str(tmp_path / "scene.png"), path, "--steps",
                             "1", "--device", "cpu"]) == 0
    import json
    got = json.loads(capsys.readouterr().out)
    assert got["device"] == "cpu" and got["ms_per_image"] > 0
    assert got["detections"] == len(ticf.detect_objects(
        torch.from_numpy(scene), ticf.load_cascade(path)))
