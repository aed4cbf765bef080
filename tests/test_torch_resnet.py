"""Port parity: ccv_tpu_torch/models/resnet.py (ResNet50-v1d + FPN and the
shared RPN head, on the graph model) against ccv_tpu/models/resnet.py on
the CPU.

- narrow stacks built with ``_block_layer`` and ``_fpn`` (filters 4-8),
  float32 and bf16;
- one full ``resnet50_v1d_fpn`` at (1, 64, 64, 3) float32 (the fixture;
  ccv_tpu's weights with seeded batch-norm statistics): the five level
  shapes equal ``bin/coco.level_grids``, and P2..P6 and the RPN maps match
  ``ccv_tpu``'s within rtol 1e-4 of each output's largest magnitude, with
  the weights carried by ``params_from_jax`` and, separately, through a
  checkpoint that ``ccv_tpu`` wrote.

Tolerances: float32 within 1e-4 of each output's largest magnitude (53
convolutions deep, the same float32 sums in another order); the narrow
stacks 1e-5 + 1e-5 * max in float32, 3e-2 of the largest in bf16 (every
layer rounds to bf16 on both sides).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccv_tpu.models import resnet as jres
from ccv_tpu.nn import functional as JF
from ccv_tpu_torch.models import resnet as tres
from ccv_tpu_torch.nn import functional as TF

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "bin"))
import coco  # noqa: E402  (bin/coco.py)

FULL_IN = (1, 64, 64, 3)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tier-1 run has six workers a machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seeded_stats(jm, seed):
    """Batch-norm statistics and affine terms, and the biases, drawn from a
    seed (ccv_tpu initialises them to constants)."""
    rng = np.random.default_rng(seed)
    for tree in (jm.params, jm.state):
        for uid, d in tree.items():
            for k, v in d.items():
                shape = np.shape(v)
                if k in ("scale", "var"):
                    a = rng.uniform(0.5, 1.0, shape)
                elif k in ("b", "bias", "mean"):
                    a = rng.normal(0, 0.1, shape)
                else:
                    continue
                d[k] = jnp.asarray(a, jnp.float32)


def _close(got, want, rel):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (err, scale)


def _narrow(mod, F):
    x = F.Input()
    c2 = mod._block_layer(x, 4, 2, 1, 2)
    c3 = mod._block_layer(c2, 6, 2, 2, 2)
    c4 = mod._block_layer(c3, 8, 2, 2, 1)
    return F.Model([x], mod._fpn([c2, c3, c4], d=8), name="narrow")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_narrow_blocks_and_fpn(dtype):
    jm, tm = _narrow(jres, JF), _narrow(tres, TF)
    shape = (2, 16, 20, 3)
    assert tm.build(shape, device="cpu") == \
        jm.build(shape, key=jax.random.PRNGKey(1))
    _seeded_stats(jm, 2)
    TF.params_from_jax(jm, tm, "cpu")
    x = np.random.default_rng(3).normal(0, 1, shape).astype(np.float32)
    want = jm.evaluate(jnp.asarray(x, dtype))
    got = tm.evaluate(torch.from_numpy(x).to(getattr(torch, dtype)))
    for g, w in zip(got, want):
        assert g.dtype == getattr(torch, dtype)
        if dtype == "float32":
            w = np.asarray(w)
            tol = 1e-5 + 1e-5 * float(np.abs(w).max())
            assert float(np.abs(g.numpy() - w).max()) <= tol
        else:
            _close(g, w, 3e-2)


@pytest.fixture(scope="module")
def full():
    """ccv_tpu's full model, built once, and its outputs and RPN maps."""
    jm = jres.resnet50_v1d_fpn()
    jm.build(FULL_IN, key=jax.random.PRNGKey(0))
    _seeded_stats(jm, 4)
    rpn = jres.rpn_init(jax.random.PRNGKey(1))
    rpn = {"w": rpn["w"], "b": jnp.asarray(np.random.default_rng(5).normal(
        0, 0.1, (tres.RPN_CHANNELS,)), jnp.float32)}
    x = np.random.default_rng(6).normal(0, 1, FULL_IN).astype(np.float32)
    feats = jm.evaluate(jnp.asarray(x))
    maps = jres.rpn_apply(rpn, feats)
    return jm, rpn, x, feats, maps


def _check_full(tm, rpn, x, feats, maps):
    got = tm.evaluate(torch.from_numpy(x))
    assert [tuple(g.shape[1:3]) for g in got] == coco.level_grids(64, 64)
    for g, w in zip(got, feats):
        _close(g, w, 1e-4)
    trpn = {k: torch.from_numpy(np.array(v)) for k, v in rpn.items()}
    for g, w in zip(tres.rpn_apply(trpn, got), maps):
        assert g.shape[-1] == tres.RPN_CHANNELS
        _close(g, w, 1e-4)


def test_full_model_with_weights_carried_across(full):
    jm, rpn, x, feats, maps = full
    tm = tres.resnet50_v1d_fpn()
    assert tm.build(FULL_IN, device="cpu") == jm.output_shape
    assert [n.layer.name for n in tm.order] == \
        [n.layer.name for n in jm.order]
    TF.params_from_jax(jm, tm, "cpu")
    assert tm.parameter_count() == jm.parameter_count()
    _check_full(tm, rpn, x, feats, maps)
    # 2 Ho Wo Cout Cin kh kw over the convolutions, from the built shapes
    assert tres.conv_flops(tm) > tres.conv_flops(tm, rpn=False) > 0


def test_full_model_from_a_ccv_tpu_checkpoint(full, tmp_path):
    jm, rpn, x, feats, maps = full
    path = str(tmp_path / "resnet.sqlite3")
    jm.write(path)
    tm = tres.resnet50_v1d_fpn()
    tm.build(FULL_IN, torch.Generator().manual_seed(7), device="cpu")
    tm.read(path)
    _check_full(tm, rpn, x, feats, maps)


def test_rpn_init_by_distribution():
    p = tres.rpn_init(torch.Generator().manual_seed(0), device="cpu")
    assert p["w"].shape == (tres.RPN_CHANNELS, 1, 1, tres.FPN_DIM)
    assert abs(float(p["w"].std()) - 0.01) < 1e-3
    assert not p["b"].any()


def test_conv_flops_counts_the_graph():
    """One 3x3 convolution and the RPN head, by hand."""
    x = TF.Input()
    from ccv_tpu_torch.nn import layers as TL

    m = TF.Model([x], [TL.Convolution(8, (3, 3), stride=(2, 2))(x)])
    m.build((2, 10, 12, 3), device="cpu")
    conv = 2 * 2 * 5 * 6 * 8 * 3 * 9
    assert tres.conv_flops(m, rpn=False) == conv
    assert tres.conv_flops(m) == conv + 2 * 2 * 5 * 6 * 15 * 8
