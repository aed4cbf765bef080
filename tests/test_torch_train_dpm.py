"""Port parity: DPM mixture-model training (ccv_tpu_torch/train/dpm.py), on
the CPU (the dpmcreate / dpmext / dpmvldtr CLIs:
tests/test_torch_train_tools.py).

The file's one ccv_tpu training is tests/test_train_dpm.py's task (six
positive scenes with an H-shaped object, five backgrounds, seed 3). While
it runs, its steps are recorded (their inputs, results and the Generator's
state), and the port's steps are fed the same inputs:

- ``_summon_positive`` and ``_collect_randomly`` within 1e-5 of the
  largest value, the Generator left in the same state;
- ``_svm_fit`` on ccv_tpu's X and y within 1e-4 of the largest weight;
- the parts of ccv_tpu's root at the same anchors and sizes;
- ``_collect_best`` and ``_collect_all`` at the same placements;
- one ``_sgd`` and one ``_regularize`` step within 1e-6.

The port's whole training from the same seed gives the same shapes and
part anchors, weights within 1e-3 of the largest, and the properties of
test_train_dpm.py (symmetry, held-out separation, the checkpoint round
trip, detection). Checkpoints are byte-equal both ways, and a run resumed
from ccv_tpu's init.model and gradient_descent_progress ends at ccv_tpu's
model.
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from ccv_tpu.detectors import dpm as jdpm
from ccv_tpu.train import dpm as J
from ccv_tpu_torch.detectors import dpm as tdpm
from ccv_tpu_torch.train import dpm as T
from test_train_dpm import _scene

CPU = torch.device("cpu")
CONFIG = dict(components=1, parts=4, min_area=1200, max_area=2500,
              symmetric=True, relabels=1, data_minings=1, iterations=6,
              negative_cache_size=20, include_overlap=0.6, seed=3)
RECORDED = ("_summon_positive", "_collect_randomly", "_svm_fit",
            "_initialize_part_classifiers", "_collect_best", "_collect_all")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this file runs: the port's many small CPU
    ops crawl when the test workers' thread pools contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def params(M):
    return M.DpmTrainParams(detector=M.DpmParams(interval=2, threshold=0.0),
                            **CONFIG)


@pytest.fixture(scope="module")
def scenes():
    rng = np.random.default_rng(7)
    posimgs, bboxes, bgimgs = [], [], []
    for _ in range(6):
        img, bbox = _scene(rng, obj=True)
        posimgs.append(img)
        bboxes.append(bbox)
    for _ in range(5):
        bgimgs.append(_scene(rng, obj=False)[0])
    return posimgs, bboxes, bgimgs, rng


def snapshot(v):
    """A copy of a model, a Generator's state or anything else, as it is
    at the call."""
    if isinstance(v, jdpm.DpmMixtureModel):
        return J._model_copy(v)
    if isinstance(v, jdpm.DpmRootClassifier):
        return J._model_copy(jdpm.DpmMixtureModel([v])).roots[0]
    if isinstance(v, np.random.Generator):
        return v.bit_generator.state
    return v


@pytest.fixture(scope="module")
def ref(scenes, tmp_path_factory):
    """ccv_tpu's training (the file's one): (model, workdir, calls), calls
    mapping each recorded step to its [(arguments, result, after)]: the
    positional arguments, then the keyword ones, as they were at the call,
    and in ``after`` the Generator's state or the root after it."""
    posimgs, bboxes, bgimgs, _ = scenes
    calls = {name: [] for name in RECORDED}
    mp = pytest.MonkeyPatch()
    for name in RECORDED:
        fn = getattr(J, name)

        def spy(*args, _fn=fn, _name=name, **kwargs):
            before = [snapshot(a) for a in args + tuple(kwargs.values())]
            out = _fn(*args, **kwargs)
            after = [snapshot(a) for a in args
                     if isinstance(a, (np.random.Generator,
                                       jdpm.DpmRootClassifier))]
            calls[_name].append((before, out, after))
            return out
        mp.setattr(J, name, spy)
    workdir = str(tmp_path_factory.mktemp("dpm_ref"))
    try:
        model = J.mixture_model_new(posimgs, bboxes, bgimgs, negnum=16,
                                    dir=workdir, params=params(J),
                                    log=lambda *a: None)
    finally:
        mp.undo()
    return model, workdir, calls


@pytest.fixture(scope="module")
def mine(scenes, tmp_path_factory):
    posimgs, bboxes, bgimgs, _ = scenes
    workdir = str(tmp_path_factory.mktemp("dpm_port"))
    timings = {}
    model = T.mixture_model_new(posimgs, bboxes, bgimgs, negnum=16,
                                dir=workdir, params=params(T),
                                log=lambda *a: None, device="cpu",
                                timings=timings)
    return model, workdir, timings


def port_model(m):
    """ccv_tpu's model as the port's classes (arrays copied)."""
    return tdpm.DpmMixtureModel([tdpm.DpmRootClassifier(
        r.beta, r.alpha.copy(), r.w.copy(),
        [tdpm.DpmPartClassifier(**{
            f.name: (getattr(p, f.name).copy()
                     if isinstance(getattr(p, f.name), np.ndarray)
                     else getattr(p, f.name))
            for f in dataclasses.fields(p)}) for p in r.parts])
        for r in m.roots])


def rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / max(np.abs(np.asarray(b)).max(), 1e-30))


def same_model(got, want, tol):
    assert got.count == want.count
    for a, b in zip(got.roots, want.roots):
        assert a.w.shape == b.w.shape and len(a.parts) == len(b.parts)
        scale = np.abs(b.w).max()
        assert np.abs(a.w - b.w).max() <= tol * scale
        assert abs(a.beta - b.beta) <= tol * max(1.0, abs(b.beta))
        np.testing.assert_allclose(a.alpha, b.alpha, atol=tol)
        for p, q in zip(a.parts, b.parts):
            assert (p.x, p.y, p.z, p.w.shape, p.counterpart) == (
                q.x, q.y, q.z, q.w.shape, q.counterpart)
            assert np.abs(p.w - q.w).max() <= tol * scale
            np.testing.assert_allclose([p.dx, p.dy, p.dxx, p.dyy],
                                       [q.dx, q.dy, q.dxx, q.dyy], atol=tol)
            np.testing.assert_allclose(p.alpha, q.alpha, atol=tol)


def test_constants_match():
    np.testing.assert_array_equal(T.SYM_LUT, J.SYM_LUT)
    assert (T.REGQ, T.MINI_BATCH) == (J.REGQ, J.MINI_BATCH)
    want = dataclasses.asdict(J.DpmTrainParams())
    got = dataclasses.asdict(T.DpmTrainParams())
    assert got == want
    r = np.random.default_rng(0).normal(size=(3, 5, 31)).astype(np.float32)
    np.testing.assert_array_equal(T._mirror(r), J._mirror(r))
    np.testing.assert_array_equal(T._mirror(T._mirror(r)), r)


def test_summon_positive_as_ccv_tpu(ref):
    calls = ref[2]["_summon_positive"]
    assert len(calls) == 6
    for (img, bbox, rows, cols), want, _ in calls:
        got = T._summon_positive(img, bbox, rows, cols, CPU)
        assert got is not None and got.shape == want.shape
        assert rel(got, want) <= 1e-5
    # a box too small for the root window gives nothing in both
    assert T._summon_positive(img, (0, 0, 6, 6), rows, cols, CPU) is None
    assert J._summon_positive(img, (0, 0, 6, 6), rows, cols) is None


def test_collect_randomly_as_ccv_tpu(ref):
    (args, want, after), = ref[2]["_collect_randomly"]
    state, bgimgs, negnum, rows, cols, gray = args
    rng = np.random.default_rng()
    rng.bit_generator.state = state
    got = T._collect_randomly(rng, bgimgs, negnum, rows, cols, gray, CPU)
    assert rng.bit_generator.state == after[0]
    assert [len(g) for g in got] == [len(w) for w in want]
    assert len(got[0]) == negnum
    for g, w in zip(got[0], want[0]):
        assert rel(g, w) <= 1e-5


def test_svm_fit_on_ccv_tpu_examples(ref):
    (X, y, C), w_ref, _ = ref[2]["_svm_fit"][0]
    X, y = np.asarray(X), np.asarray(y)
    assert X.shape[0] == 2 * (6 + 16)   # every example and its mirror
    w = T._svm_fit(torch.from_numpy(X.copy()), torch.from_numpy(y.copy()),
                   C).numpy()
    assert w.dtype == np.float32
    assert rel(w, np.asarray(w_ref)) <= 1e-4
    # the fit separates its examples
    assert ((X @ w) * y > 0).mean() > 0.9


def test_part_initialisation_as_ccv_tpu(ref):
    (root, parts, sym), _, after = ref[2]["_initialize_part_classifiers"][0]
    mine = port_model(jdpm.DpmMixtureModel([root])).roots[0]
    T._initialize_part_classifiers(mine, parts, sym, CPU)
    want = after[0].parts
    assert len(mine.parts) == len(want) == parts
    for p, q in zip(mine.parts, want):
        assert (p.x, p.y, p.z, p.w.shape, p.counterpart) == (
            q.x, q.y, q.z, q.w.shape, q.counterpart)
        assert (p.dx, p.dy, p.dxx, p.dyy) == (q.dx, q.dy, q.dxx, q.dyy)
        assert np.abs(p.w - q.w).max() <= 1e-5 * np.abs(root.w).max()


def same_vector(got, want, tol=1e-5):
    assert (got.id, got.x, got.y, got.scale_x, got.scale_y) == (
        want.id, want.x, want.y, want.scale_x, want.scale_y)
    np.testing.assert_array_equal(got.part_dx, want.part_dx)
    np.testing.assert_array_equal(got.part_dy, want.part_dy)
    assert abs(got.score - want.score) <= tol * max(1.0, abs(want.score))
    assert rel(got.root_w, want.root_w) <= tol
    for a, b in zip(got.part_w, want.part_w):
        assert np.abs(a - b).max() <= tol * np.abs(want.root_w).max()


def test_collect_best_as_ccv_tpu(ref):
    calls = ref[2]["_collect_best"]
    assert len(calls) == 12        # the relabel, then the drift estimate
    for (img, model, bbox, overlap, dparams), want, _ in calls:
        got = T._collect_best(img, port_model(model), bbox, overlap,
                              tdpm.DpmParams(**vars(dparams)), CPU)
        assert want is not None and got is not None
        same_vector(got, want)


def test_collect_all_as_ccv_tpu(ref):
    calls = ref[2]["_collect_all"]
    assert calls
    for (state, img, model, dparams, threshold), want, after in calls:
        rng = np.random.default_rng()
        rng.bit_generator.state = state
        got = T._collect_all(rng, img, port_model(model),
                             tdpm.DpmParams(**vars(dparams)), threshold,
                             device=CPU)
        assert rng.bit_generator.state == after[0]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            same_vector(g, w)


def test_sgd_and_regularize_as_ccv_tpu(ref):
    model, _, calls = ref
    (_, _, bbox, *_), v, _ = calls["_collect_best"][0]
    for y, symmetric in ((1, True), (-1, True), (1, False)):
        a, b = J._model_copy(model), port_model(model)
        J._sgd(a, v, y, 0.01 * 1.3, 0.002, symmetric)
        T._sgd(b, v, y, 0.01 * 1.3, 0.002, symmetric)
        same_model(b, a, 1e-6)
        assert not np.array_equal(a.roots[0].w, model.roots[0].w)
        J._regularize(a, 0, 0.003)
        T._regularize(b, 0, 0.003)
        same_model(b, a, 1e-6)
        assert T._vector_score(b, v) == pytest.approx(
            J._vector_score(a, v), rel=1e-6)


def test_training_equals_ccv_tpu(ref, mine):
    model, _, timings = mine
    same_model(model, ref[0], 1e-3)
    assert model.count == 1 and len(model.roots[0].parts) == CONFIG["parts"]
    assert len(timings["relabel_s"]) == CONFIG["relabels"]
    assert len(timings["mining_s"]) == CONFIG["data_minings"]
    assert len(timings["svm_fit_ms"]) == CONFIG["components"]


def test_training_symmetric(mine):
    root = mine[0].roots[0]
    assert root.w.shape[2] == 31
    np.testing.assert_allclose(root.w, T._mirror(root.w), atol=5e-3)


def test_training_separates_heldout(mine, scenes):
    model = mine[0]
    rng = np.random.default_rng(21)
    p = params(T)
    pos_scores, neg_scores = [], []
    for _ in range(4):
        img, bbox = _scene(rng, obj=True)
        v = T._collect_best(img.astype(np.float32), model, bbox,
                            p.include_overlap, p.detector, CPU)
        assert v is not None
        pos_scores.append(T._vector_score(model, v))
    for _ in range(4):
        img, _ = _scene(rng, obj=False)
        vs = T._collect_all(np.random.default_rng(0), img.astype(np.float32),
                            model, p.detector, threshold=-np.inf, enough=1,
                            device=CPU)
        neg_scores.append(T._vector_score(model, vs[0]))
    assert np.mean(pos_scores) > np.mean(neg_scores)


def test_checkpoint_round_trip_and_detect(mine):
    model, workdir, _ = mine
    path = os.path.join(workdir, "model")
    with open(path) as f:
        assert f.read(1) == "."   # the done marker
    assert not os.path.exists(os.path.join(workdir,
                                           "gradient_descent_progress"))
    again = tdpm.read_mixture_model(path)
    same_model(again, model, 0.0)
    rng = np.random.default_rng(33)
    img, (x, y, w, h) = _scene(rng, obj=True)
    comps = tdpm.detect(img.astype(np.float32), again,
                        tdpm.DpmParams(interval=2, threshold=-0.5,
                                       min_neighbors=1), device="cpu")
    assert comps, "the trained model found nothing on a positive scene"
    best = 0.0
    for c in comps:
        ix = max(0, min(c.x + c.width, x + w) - max(c.x, x))
        iy = max(0, min(c.y + c.height, y + h) - max(c.y, y))
        best = max(best, ix * iy / (c.width * c.height + w * h - ix * iy))
    assert best > 0.3, best


def test_checkpoints_byte_equal_both_ways(ref, mine, tmp_path):
    for theirs in (os.path.join(ref[1], "model"),
                   os.path.join(ref[1], "init.model")):
        with open(theirs, "rb") as f:
            want = f.read()
        done = want[:1] == b"."
        m = T._read_checkpoint(theirs)
        out = str(tmp_path / "port")
        T.write_mixture_model(m, out, done=done,
                              total=None if done else CONFIG["components"])
        with open(out, "rb") as f:
            assert f.read() == want, theirs
    assert want[:1] == b"," and b"\n1 1\n" in want[:6]
    for mine_path in (os.path.join(mine[1], "model"),
                      os.path.join(mine[1], "init.model")):
        with open(mine_path, "rb") as f:
            want = f.read()
        done = want[:1] == b"."
        m = J._read_checkpoint(mine_path)
        out = str(tmp_path / "ref")
        J.write_mixture_model(m, out, done=done,
                              total=None if done else CONFIG["components"])
        with open(out, "rb") as f:
            assert f.read() == want, mine_path
    # a checkpoint that declares more roots than it holds reads its roots
    m = T._read_checkpoint(os.path.join(ref[1], "init.model"))
    out = str(tmp_path / "partial")
    T.write_mixture_model(m, out, done=False, total=3)
    with open(out) as f:
        assert f.read().startswith(",\n3 1\n")
    assert T._read_checkpoint(out).count == 1
    assert J._read_checkpoint(out).count == 1
    assert T._read_checkpoint(str(tmp_path / "missing")) is None


def test_resume_from_ccv_tpu_checkpoint(ref, scenes, tmp_path):
    """The port resumed from ccv_tpu's init.model (the roots and parts)
    with gradient_descent_progress "0 0" skips the initialisation and
    ends at ccv_tpu's model. At this configuration the data mining
    gathers fewer negatives than half the cache, so the mining adjusts
    the model's constant from the positives alone: the Generator, whose
    state differs after a skipped initialisation, decides nothing."""
    posimgs, bboxes, bgimgs, _ = scenes
    d = str(tmp_path / "resume")
    os.makedirs(d)
    shutil.copy(os.path.join(ref[1], "init.model"), os.path.join(d, "model"))
    with open(os.path.join(d, "gradient_descent_progress"), "w") as f:
        f.write("0 0\n")
    logs, timings = [], {}
    model = T.mixture_model_new(posimgs, bboxes, bgimgs, negnum=16, dir=d,
                                params=params(T), log=logs.append,
                                device="cpu", timings=timings)
    assert "dpm: resuming root mixture model from checkpoint" in logs
    assert not any("initializing" in line for line in logs)
    assert timings["svm_fit_ms"] == [] and timings["sgd_s"] == [0.0]
    same_model(model, ref[0], 1e-3)
    assert not os.path.exists(os.path.join(d, "gradient_descent_progress"))
