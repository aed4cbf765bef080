"""Port parity: SCD cascade training (ccv_tpu_torch/train/scd.py) and the
scdcreate / scdfmt CLIs.

The same seeded numpy patches go through ccv_tpu.train.scd and the port on
the CPU. ccv_tpu draws each boosting round's starting stumps with
jax.random; the port takes them from the caller (``init``), so here it is
started from ccv_tpu's draws (PRNGKey(seed), split as ccv_tpu splits it).
Tolerances: feature vectors within 1e-5 of the largest (the same float32
arithmetic in another order); 20 Adam steps within 1e-4 of the largest;
thresholds within 1e-4. Started from the port's own draws, the trainer is
held to tests/test_train_scd.py's properties. The patches are
tests/test_train_scd.py's synthetic task (a bright cross against noise and
gradients) at 24 x 24.
"""

import os
import runpy
import sqlite3

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from ccv_tpu.detectors import scd as jscd
from ccv_tpu.train import scd as J
from ccv_tpu_torch.bin import scdcreate, scdfmt
from ccv_tpu_torch.bin.icfcreate import load_dir
from ccv_tpu_torch.detectors import scd as tscd
from ccv_tpu_torch.train import scd as T

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = (24, 24)
SMALL = dict(size=SIZE, boosting=2, maximum_feature=6, prune_stage=1,
             prune_feature=4, train_steps=90, hit_rate=0.98,
             accu_false_positive_rate=1e-6)


def make_patches(n, size, rng, positive):
    """Positives: a bright cross on dark; negatives: noise or gradients."""
    W, H = size
    out = np.zeros((n, H, W, 3), np.uint8)
    for i in range(n):
        base = rng.integers(20, 60)
        img = rng.normal(base, 12, (H, W, 3))
        if positive:
            cx = W // 2 + rng.integers(-2, 3)
            cy = H // 2 + rng.integers(-2, 3)
            t = max(2, W // 8) + rng.integers(-1, 2)
            img[cy - t:cy + t, :, :] += 140
            img[:, cx - t:cx + t, :] += 140
        elif rng.random() < 0.5:  # gradient distractor
            img += np.linspace(0, 80, W)[None, :, None]
        out[i] = np.clip(img, 0, 255).astype(np.uint8)
    return out


def jax_init(seed):
    """ccv_tpu's draws as the port's ``init``: each round splits the key,
    then splits the subkey for W and B (ccv_tpu/train/scd.py:137, :214)."""
    key = [jax.random.PRNGKey(seed)]

    def draw(nf):
        key[0], sub = jax.random.split(key[0])
        k1, k2 = jax.random.split(sub)
        w = jax.random.uniform(k1, (nf, 32), jnp.float32, -1.0, 1.0)
        b = jax.random.uniform(k2, (nf,), jnp.float32, -1.0, 1.0)
        return torch.from_numpy(np.array(w)), torch.from_numpy(np.array(b))
    return draw


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    return (make_patches(64, SIZE, rng, True),
            make_patches(150, SIZE, rng, False))


@pytest.fixture(scope="module")
def ref(data):
    """ccv_tpu's cascade on the patches (the file's one ccv_tpu run)."""
    return J.train_cascade(*data, J.ScdTrainParams(**SMALL))


@pytest.fixture(scope="module")
def mine(data):
    """The port's cascade from its own draws."""
    torch.set_num_threads(1)
    return T.train_cascade(*data, T.ScdTrainParams(**SMALL), "cpu")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("params", [{}, SMALL, dict(size=(48, 32))],
                         ids=["published", "small", "48x32"])
def test_stump_features_equal(params):
    np.testing.assert_array_equal(
        T.stump_features(T.ScdTrainParams(**params)),
        J.stump_features(J.ScdTrainParams(**params)))


def test_published_patch_has_1631_features():
    assert len(T.stump_features(T.ScdTrainParams())) == 1631


def test_feature_vectors_match(data):
    x = np.concatenate([data[0][:20], data[1][:20]])
    feats = T.stump_features(T.ScdTrainParams(**SMALL))
    got = T.precompute_feature_vectors(x, feats, "cpu")
    want = np.asarray(J.precompute_feature_vectors(x, feats))
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= 1e-5
    # a gray batch (N, H, W) reads as one channel
    gray = x[..., 0]
    assert _rel(T.precompute_feature_vectors(gray, feats, "cpu").numpy(),
                np.asarray(J.precompute_feature_vectors(gray[..., None],
                                                        feats))) <= 1e-5


def test_train_all_stumps_from_ccv_tpu_s_draws(data):
    """20 Adam steps of every stump, from ccv_tpu's W and B: W, B and the
    weighted errors within 1e-4 of the largest."""
    x = np.concatenate([data[0][:32], data[1][:48]])
    feats = T.stump_features(T.ScdTrainParams(**SMALL))
    fv = np.array(J.precompute_feature_vectors(x, feats))
    y = np.concatenate([np.ones(32), -np.ones(48)]).astype(np.float32)
    w = np.random.default_rng(3).random(80)
    w = (w / w.sum()).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = J._train_all_stumps(jnp.asarray(fv), jnp.asarray(y),
                               jnp.asarray(w), 0.002, 20, 0.05, key)
    k1, k2 = jax.random.split(key)
    init = (torch.from_numpy(np.array(jax.random.uniform(
                k1, (len(feats), 32), jnp.float32, -1.0, 1.0))),
            torch.from_numpy(np.array(jax.random.uniform(
                k2, (len(feats),), jnp.float32, -1.0, 1.0))))
    got = T._train_all_stumps(torch.from_numpy(fv).transpose(0, 1)
                              .contiguous(), torch.from_numpy(y),
                              torch.from_numpy(w), 0.002, 20, 0.05, init)
    for g, r in zip(got, want):
        assert _rel(g.numpy(), np.asarray(r)) <= 1e-4


def test_auc_and_threshold_equal():
    rng = np.random.default_rng(11)
    for n_pos in (1, 7, 40):
        s = rng.normal(size=n_pos + 33)
        s[n_pos:n_pos + 3] = s[0]   # ties across the classes
        assert T._auc(s, n_pos) == J._auc(s, n_pos)
        for rate in (0.5, 0.98, 1.0):
            assert T._threshold_at_hit_rate(s, n_pos, rate) == \
                J._threshold_at_hit_rate(s, n_pos, rate)


def test_train_cascade_from_ccv_tpu_s_draws(data, ref):
    """From ccv_tpu's draws the port trains ccv_tpu's cascade: the same
    first-stage features and stage sizes, thresholds within 1e-4."""
    got = T.train_cascade(*data, T.ScdTrainParams(**SMALL), "cpu",
                          init=jax_init(0))
    np.testing.assert_array_equal(got.stage_counts, ref.stage_counts)
    first = ref.stage_of == 0
    for k in ("sx", "sy", "dx", "dy"):
        np.testing.assert_array_equal(getattr(got, k)[first],
                                      getattr(ref, k)[first])
    assert np.abs(got.thresholds - ref.thresholds).max() <= 1e-4
    assert _rel(got.w, ref.w) <= 1e-4


def test_trained_cascade_separates_heldout(mine):
    """tests/test_train_scd.py's property, for the port's own draws."""
    rng = np.random.default_rng(99)
    pos = make_patches(40, SIZE, rng, True)
    neg = make_patches(40, SIZE, rng, False)
    feats = np.stack([mine.sx, mine.sy, mine.dx, mine.dy], axis=-1)
    fv = T.precompute_feature_vectors(np.concatenate([pos, neg]), feats,
                                      "cpu").numpy()
    h = np.tanh(0.5 * (np.einsum("nfk,fk->nf", fv, mine.w) + mine.bias))
    onehot = np.zeros((mine.n_features, mine.n_stages), np.float32)
    onehot[np.arange(mine.n_features), mine.stage_of] = 1
    passed = (h @ onehot > mine.thresholds).all(axis=1)
    assert passed[:40].mean() > 0.9 and passed[40:].mean() < 0.2


def test_written_cascade_loads_in_both_and_detects_alike(mine, tmp_path):
    """The port's file loads in both packages, and both detect the same
    rects with it on a scene with one planted cross (the port on a CPU
    tensor)."""
    path = str(tmp_path / "cross.sqlite3")
    T.write_cascade(mine, path)
    theirs, ours = jscd.load_cascade(path), tscd.load_cascade(path)
    for c in (theirs, ours):
        assert c.n_features == mine.n_features
        np.testing.assert_array_equal(c.sx, mine.sx)
        np.testing.assert_array_equal(c.w, mine.w)
        np.testing.assert_array_equal(c.thresholds, mine.thresholds)
    rng = np.random.default_rng(7)
    scene = np.clip(rng.normal(40, 12, (96, 128, 3)), 0, 255).astype(
        np.uint8)
    scene[30:54, 60:84] = make_patches(1, SIZE, np.random.default_rng(5),
                                       True)[0]
    kw = dict(min_neighbors=1, interval=1, size=SIZE)
    got = tscd.detect(torch.from_numpy(scene), ours, tscd.ScdParams(**kw))
    want = jscd.detect(scene, theirs, jscd.ScdParams(**kw))
    assert got, "the trained cascade found nothing"
    assert [(c.x, c.y, c.width, c.height) for c in got] == [
        (c.x, c.y, c.width, c.height) for c in want]
    np.testing.assert_allclose([c.confidence for c in got],
                               [c.confidence for c in want], atol=1e-4)
    best = max(got, key=lambda c: c.confidence)
    assert abs(best.x - 60) < 10 and abs(best.y - 30) < 10


@pytest.fixture(scope="module")
def patch_dirs(tmp_path_factory, data):
    """Positives at 28 x 28 (resized to 24 by the loader) as PNG, BMP and
    JPEG; negatives as 64 x 48 PNG, BMP and JPEG images to crop."""
    d = tmp_path_factory.mktemp("scd_cli")
    pos, neg = d / "pos", d / "neg"
    pos.mkdir()
    neg.mkdir()
    big = make_patches(24, (28, 28), np.random.default_rng(21), True)
    for i, p in enumerate(big):
        ext = ("png", "bmp", "jpg")[i % 3]
        Image.fromarray(p).save(str(pos / f"{i:02d}.{ext}"), quality=95)
    rng = np.random.default_rng(22)
    for i in range(6):
        img = make_patches(1, (64, 48), rng, False)[0]
        ext = ("png", "bmp", "jpg")[i % 3]
        Image.fromarray(img).save(str(neg / f"{i}.{ext}"), quality=95)
    return str(pos), str(neg)


def test_loader_equals_ccv_tpu_s(patch_dirs):
    """The CLIs' loader (icfcreate.load_dir, scdcreate's too) gives
    ccv_tpu's tool's patches: decode, INTER_AREA resize, seeded crops."""
    tool = runpy.run_path(os.path.join(ROOT, "bin", "scdcreate.py"))
    for crop, path in ((False, patch_dirs[0]), (True, patch_dirs[1])):
        np.testing.assert_array_equal(
            load_dir(path, SIZE, crop=crop),
            tool["_load_dir"](path, SIZE, crop_negatives=crop))


def test_scdcreate_cli_writes_the_trained_cascade(patch_dirs, tmp_path,
                                                  capsys):
    out = str(tmp_path / "cli.sqlite3")
    argv = [*patch_dirs, out, "--size", "24", "24", "--boosting", "2",
            "--max-feature", "4", "--hit-rate", "0.98", "--device", "cpu"]
    assert scdcreate.main(argv) == 0
    assert "24 positives, 48 negative patches" in capsys.readouterr().out
    got = tscd.load_cascade(out)
    want = T.train_cascade(
        load_dir(patch_dirs[0], SIZE), load_dir(patch_dirs[1], SIZE, True),
        T.ScdTrainParams(size=SIZE, boosting=2, maximum_feature=4,
                         hit_rate=0.98), "cpu")
    np.testing.assert_array_equal(got.sx, want.sx)
    np.testing.assert_array_equal(got.w, want.w)
    np.testing.assert_array_equal(got.thresholds, want.thresholds)
    with sqlite3.connect(out) as con:
        assert con.execute("SELECT size_width, size_height FROM "
                           "cascade_params").fetchone() == SIZE
    assert jscd.load_cascade(out).n_features == got.n_features


def test_scdfmt_equals_ccv_tpu_s():
    tool = runpy.run_path(os.path.join(ROOT, "bin", "scdfmt.py"))
    for line in ("faces/2002/07/19/big/img_130.jpg 3",
                 "10 20 33 41 12.5", "1 2 3", "", "0 0 7 9 -0.25"):
        assert scdfmt.convert(line) == tool["convert"](line)
