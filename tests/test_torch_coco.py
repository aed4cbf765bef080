"""Port parity: the coco trainer twin (ccv_tpu_torch/bin/coco.py) against
bin/coco.py on the CPU: the anchor helpers give equal arrays, the loss
composition agrees within 1e-6, and three demo steps of the port alone
train (ccv_tpu's full ResNet50-FPN training step is not compiled here: it
costs minutes on the CPU)."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccv_tpu.nn import ops as jops
from ccv_tpu_torch.bin import coco as tcoco
from ccv_tpu_torch.models import resnet

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "bin"))
import coco as jcoco  # noqa: E402  (bin/coco.py)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("rows,cols", [(64, 64), (96, 96), (128, 160),
                                       (800, 1344)])
def test_level_grids_and_anchor_shapes(rows, cols):
    assert tcoco.level_grids(rows, cols) == jcoco.level_grids(rows, cols)
    for s in tcoco.STRIDES:
        assert tcoco.anchor_shapes(s) == jcoco.anchor_shapes(s)


def test_level_grids_match_the_built_model():
    m = resnet.resnet50_v1d_fpn()
    m.build((1, 96, 128, 3), device="cpu")
    assert [tuple(s[1:3]) for s in m.output_shape] == \
        tcoco.level_grids(96, 128)


def _boxes(rng, n, rows, cols):
    w = rng.uniform(8, min(70, cols - 1), n)
    h = rng.uniform(8, min(70, rows - 1), n)
    return np.stack([rng.uniform(0, cols - w), rng.uniform(0, rows - h),
                     w, h], 1).astype(np.float32)


@pytest.mark.parametrize("seed,n", [(0, 1), (1, 3), (2, 7), (3, 0)])
def test_rpn_gt_and_select_anchors(seed, n):
    """The ground truth of random boxes (thin ones included, which only
    the missing-gt pass assigns) and the selection from one seed: equal
    arrays."""
    rng = np.random.default_rng(seed)
    grids = tcoco.level_grids(96, 128)
    boxes = _boxes(rng, n, 96, 128)
    if n:
        boxes[0, 2:] = (11.0, 45.0)
    want = jcoco.rpn_gt(grids, boxes)
    got = tcoco.rpn_gt(grids, boxes)
    np.testing.assert_array_equal(got, want)
    sel_j = jcoco.select_anchors(want, 64, np.random.default_rng(seed))
    sel_t = tcoco.select_anchors(got, 64, np.random.default_rng(seed))
    np.testing.assert_array_equal(sel_t, sel_j)


def test_synthetic_scene_and_load_list(tmp_path):
    a = jcoco.synthetic_scene(np.random.default_rng(4), 96, 96)
    b = tcoco.synthetic_scene(np.random.default_rng(4), 96, 96)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    p = tmp_path / "list.txt"
    p.write_text("1 a.png 1 2 3 4\n2 a.png 5 6 7 8\nbad line\n"
                 "1 b.png 9 9 9 9\n")
    for (pa, ba), (pb, bb) in zip(jcoco.load_list(str(p), "imgs"),
                                  tcoco.load_list(str(p), "imgs")):
        assert pa == pb
        np.testing.assert_array_equal(ba, bb)


def _jax_loss(flat, gt, sel):
    """bin/coco.py's loss_fn after the forward (lines 238-254), in JAX."""
    out_sel = jnp.take(flat, sel, axis=0)
    gt_sel = jnp.take(gt.reshape(-1, 5), sel, axis=0)
    bce, _ = jops.sigmoid_binary_crossentropy(out_sel[:, :1], gt_sel[:, :1])
    cls_loss = jnp.mean(bce)
    pos = gt_sel[:, 0] == 1.0
    l1 = jops.smooth_l1_loss(out_sel[:, 1:], gt_sel[:, 1:])
    l1_loss = (jnp.sum(jnp.where(pos, l1, 0.0))
               / jnp.maximum(jnp.sum(pos), 1))
    acc = jnp.mean(((out_sel[:, 0] > 0) == (gt_sel[:, 0] > 0.5))
                   .astype(jnp.float32))
    return cls_loss + l1_loss, acc


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rpn_loss_composition(seed):
    """Random RPN maps against the ground truth of random boxes, B 2: the
    selection, BCE, smooth-L1 over the positives and the accuracy."""
    rng = np.random.default_rng(seed)
    rows, cols = 64, 96
    grids = tcoco.level_grids(rows, cols)
    total = sum(gh * gw for gh, gw in grids) * 3
    maps = [rng.normal(0, 1, (2, gh, gw, 15)).astype(np.float32)
            for gh, gw in grids]
    gts, sels = [], []
    for b in range(2):
        g = tcoco.rpn_gt(grids, _boxes(rng, 3, rows, cols))
        gts.append(g)
        sels.append(tcoco.select_anchors(g, 32, rng) + b * total)
    gt, sel = np.stack(gts), np.concatenate(sels)
    flat = np.concatenate([m.reshape(2, -1, 5) for m in maps], 1)
    jl, ja = _jax_loss(jnp.asarray(flat.reshape(-1, 5)), jnp.asarray(gt),
                       jnp.asarray(sel))
    tl, ta = tcoco.rpn_loss([torch.from_numpy(m) for m in maps],
                            torch.from_numpy(gt),
                            torch.from_numpy(sel.astype(np.int64)))
    assert abs(float(tl) - float(jl)) <= 1e-6 * abs(float(jl))
    assert float(ta) == float(ja)


def test_trainer_grads_and_step():
    """The trainer's step = its gradients, clipped to norm 5, through SGD
    with momentum 0.9; the batch-norm running statistics move."""
    t = tcoco.Trainer(1, 64, 64, lr=0.01, select_count=32, device="cpu")
    rng = np.random.default_rng(5)
    host = t.batch([tcoco.synthetic_scene(rng, 64, 64)], rng)
    args = t.to_device(*host)
    before = [p.clone() for p in tcoco.optimizers.leaves(t.params)]
    state0 = [s.clone() for s in tcoco.optimizers.leaves(t.state)]
    loss, _acc, grads, _ = t.grads(*args)
    total = torch.sqrt(sum((g ** 2).sum() for g in grads))
    factor = min(1.0, 5.0 / float(total))
    loss2, _ = t.step(*args)
    assert float(loss2) == float(loss)
    for p0, p1, g in zip(before, tcoco.optimizers.leaves(t.params), grads):
        torch.testing.assert_close(p1, p0 - 0.01 * g * factor, rtol=0,
                                   atol=1e-6)
    assert any(not torch.equal(a, b) for a, b in zip(
        state0, tcoco.optimizers.leaves(t.state)))


def test_demo_three_steps():
    """``--demo`` for three steps at 64 x 64, B 1, on the CPU: every loss
    finite. Each demo step draws a new scene, so its losses need not fall;
    descent is held on one fixed batch instead: three steps at the demo's
    own size, batch and rate, in float64, lower that batch's loss (from
    1.511 to 1.160 here; the float32 gradient norm of ``clip_grad_norm``
    moves the end by ~3e-4 from one build's leaf order to another's)."""
    loss, acc = tcoco.main(["--demo", "--steps", "3", "--size", "64",
                            "--batch", "1", "--device", "cpu"])
    losses = tcoco.main.losses
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert 0.0 <= acc <= 1.0 and loss == losses[-1]
    demo = tcoco.parser().parse_args(["--demo"])
    t = tcoco.Trainer(demo.batch, demo.size, demo.size, lr=demo.lr,
                      select_count=demo.select_count, device="cpu",
                      dtype=torch.float64)
    rng = np.random.default_rng(0)
    scenes = [tcoco.synthetic_scene(rng, demo.size, demo.size)
              for _ in range(demo.batch)]
    args = t.to_device(*t.batch(scenes, rng))
    first = float(t.grads(*args)[0])
    for _ in range(3):
        t.step(*args)
    last = float(t.grads(*args)[0])
    assert last < first, (first, last)


def _params_by_position(t):
    """A trainer's parameter tensors by topological position (node uids,
    and so ``leaves()`` order, differ from build to build)."""
    fpn = t.fpn
    out = [fpn.params[str(n.uid)][k] for n in fpn.order
           if str(n.uid) in fpn.params for k in sorted(fpn.params[str(n.uid)])]
    return out + [t.params["rpn"][k] for k in sorted(t.params["rpn"])]


# |float32 loss - float64 loss| / |float64 loss| of this step: 1.24e-4 on
# one CPU, 9.93e-06 on an H100 80GB HBM3 (chip_smoke.py phase 31); how
# far float32 lands after 53 convolutions depends on the convolution
# algorithm the device picks, so the bound is set above both
F32_LOSS_GAP = 1e-3


def test_trainer_float64_step():
    """A Trainer in float64 draws the float32 trainer's weights and casts
    them (equal to the bit); its loss equals a second float64 evaluation
    of the same graph and loss within 1e-10; the float32 loss lies within
    ``F32_LOSS_GAP`` of the float64 one; float64 gradients shaped as the
    parameters and finite float64 batch-norm statistics."""
    rng = np.random.default_rng(31)
    scene = tcoco.synthetic_scene(rng, 64, 64)
    out = {}
    for dtype in (torch.float32, torch.float64):
        t = tcoco.Trainer(1, 64, 64, select_count=32, device="cpu",
                          dtype=dtype)
        args = t.to_device(*t.batch([scene], np.random.default_rng(32)))
        out[dtype] = t, args, t.grads(*args)
    t64, args64, (loss64, _acc, grads, state) = out[torch.float64]
    t32, _, (loss32, _, grads32, _) = out[torch.float32]
    for a, b in zip(_params_by_position(t64), _params_by_position(t32)):
        assert a.dtype == torch.float64 and torch.equal(a, b.double())
    with torch.no_grad():
        feats, _ = t64.fpn._forward(t64.params["fpn"], t64.state,
                                    [args64[0]], True, None)
        again, _ = tcoco.rpn_loss(
            resnet.rpn_apply(t64.params["rpn"], feats), *args64[1:])
    assert abs(float(again) - float(loss64)) <= 1e-10 * abs(float(loss64))
    gap = abs(float(loss64) - float(loss32)) / abs(float(loss64))
    assert gap <= F32_LOSS_GAP, gap
    for t, g in ((t64, grads), (t32, grads32)):  # each build's leaf order
        assert [x.shape for x in g] == [
            p.shape for p in tcoco.optimizers.leaves(t.params)]
    assert all(g.dtype == torch.float64 and bool(torch.isfinite(g).all())
               for g in grads)
    assert all(s.dtype == torch.float64 and bool(torch.isfinite(s).all())
               for s in tcoco.optimizers.leaves(state))
