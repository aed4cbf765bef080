"""Port parity: data parallelism on gloo ranks. ``set_data_parallel(4)`` on
tests/test_nn.py:146's toy against ccv_tpu's one-device fit (what GSPMD
gives its data-parallel fit; parameters within 1e-5); a batch-norm and
dropout model under ``set_data_parallel(4)`` against the port's own
one-rank step (running statistics and parameters within 1e-6, the same
on every rank); ``wmt --data-parallel 2`` on text with pads, dropout 0.1,
against the port's one-rank step in float32 (loss within 1e-6 relative,
the step's gradients within 1e-6 of their largest), and the CLI's step on
two ranks (the ranks' parameters equal)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_parallel_ranks as torch_ranks
from ccv_tpu.nn import layers as JL
from ccv_tpu.nn import optimizers as jopt
from ccv_tpu.nn.model import Sequential as JSequential
from ccv_tpu_torch.nn import layers as TL
from ccv_tpu_torch.nn import model as tmodel
from ccv_tpu_torch.nn import ops as tops
from ccv_tpu_torch.nn import optimizers as topt

N = 4
TOY = [("Dense", {"count": 16, "name": "d1"}), ("ReLU", {}),
       ("Dense", {"count": 2, "name": "d2"})]
BN = [("Dense", {"count": 8}), ("BatchNorm", {}), ("ReLU", {}),
      ("Dropout", {"rate": 0.25}), ("Dense", {"count": 3})]
SGD = dict(rate=0.1, momentum=0.9)


def _np_tree(tree):
    return [{k: np.array(v) for k, v in d.items()} for d in tree]


def _toy_case():
    """tests/test_nn.py:146's inputs and ccv_tpu's fit on them."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((32, 8), np.float32)
    y = (rng.standard_normal(32) > 0).astype(np.int64)
    jm = JSequential([getattr(JL, n)(**kw) for n, kw in TOY])
    jm.build((32, 8), key=jax.random.PRNGKey(3))
    params, state = _np_tree(jm.params), _np_tree(jm.state)
    jm.compile(jopt.sgd(**SGD), "softmax_crossentropy")
    loss = jm.fit(jnp.asarray(x), jnp.asarray(y.astype(np.int32)))
    want = [np.asarray(p) for p in jax.tree_util.tree_leaves(jm.params)]
    return (TOY, params, state, x, y, SGD, "softmax_crossentropy"), \
        (loss, want)


def _bn_case():
    """A batch-norm and dropout model and the port's one-rank fit."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((16, 6), np.float32)
    y = rng.integers(0, 3, 16)
    m = tmodel.Sequential([getattr(TL, n)(**kw) for n, kw in BN])
    m.build((16, 6), torch.Generator().manual_seed(5), device="cpu")
    params = [{k: v.numpy().copy() for k, v in d.items()} for d in m.params]
    state = [{k: v.numpy().copy() for k, v in d.items()} for d in m.state]
    m.compile(topt.sgd(**SGD), "softmax_crossentropy")
    loss = m.fit(x, y)
    return (BN, params, state, x, y, SGD, "softmax_crossentropy"), \
        (loss, [p.numpy() for p in topt.leaves(m.params)],
         [s.numpy() for s in topt.leaves(m.state)])


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    toy, toy_ref = _toy_case()
    bn, bn_ref = _bn_case()
    ranks = torch_ranks.run(torch_ranks.sequential_fits, N,
                            tmp_path_factory.mktemp("dp"), [toy, bn])
    return ranks, toy_ref, bn_ref


def test_sequential_data_parallel_matches_ccv_tpu(fits):
    ranks, (loss, want), _ = fits
    for r in range(N):
        got_loss, got, _ = ranks[r][0][0]
        assert abs(got_loss - loss) <= 1e-5 * abs(loss)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_batch_norm_and_dropout_under_data_parallel(fits):
    """Global batch statistics and the global batch's dropout mask: the
    four ranks' step is the one-rank step, and the ranks stay equal."""
    ranks, _, (loss, params, stats) = fits
    for r in range(N):
        got_loss, got_params, got_stats = ranks[r][0][1]
        assert abs(got_loss - loss) <= 1e-6 * abs(loss)
        for a, b in zip(got_stats, stats):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
        for a, b in zip(got_params, params):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
        for a, b in zip(got_params + got_stats,
                        ranks[0][0][1][1] + ranks[0][0][1][2]):
            assert np.array_equal(a, b)


# (mesh axes, batch norm's axis, x's shape, the statistics' shape, {mesh
# axis: the statistics' dimension it splits}): a split dimension outside
# the axis indexes the statistics, so its ranks keep their own
BN_AXES = {
    "rows_kept": ({"data": 4}, (1, 2), (8, 3, 5, 2), (8, 1, 1, 2),
                  {"data": 0}),
    "over_data_not_seq": ({"data": 2, "seq": 2}, (0,), (4, 6, 3), (6, 3),
                          {"seq": 0}),
    "over_both": ({"data": 2, "seq": 2}, (0, 1), (4, 6, 3), (3,), {}),
}


@pytest.fixture(scope="module")
def bn_axes(tmp_path_factory):
    rng = np.random.default_rng(9)
    xs = {k: rng.standard_normal(c[2]).astype(np.float32)
          for k, c in BN_AXES.items()}
    ranks = torch_ranks.run(
        torch_ranks.batch_norm_axes, N, tmp_path_factory.mktemp("bn"),
        [(xs[k], axes, axis, stat, split)
         for k, (axes, axis, _, stat, split) in BN_AXES.items()])
    return xs, {k: [r[i] for r in ranks] for i, k in enumerate(BN_AXES)}


@pytest.mark.parametrize("case", sorted(BN_AXES))
def test_batch_norm_axis_under_sharding(bn_axes, case):
    """Each rank's block of batch norm in training, with the sharded
    dimensions in or out of its axis, is its block of the one-rank result
    (1e-6)."""
    xs, got = bn_axes
    axes, axis, shape, stat, split = BN_AXES[case]
    c = shape[-1]
    y, m, v = tops.batch_norm(torch.tensor(xs[case]), torch.ones(c),
                              torch.zeros(c), torch.zeros(stat),
                              torch.ones(stat), is_training=True, axis=axis)
    for gy, gm, gv, coords in got[case]:
        want_y, want_m, want_v = y, m, v
        for name, i in coords.items():
            n = axes[name]
            want_y = want_y.chunk(n, 0 if name == "data" else 1)[i]
            if name in split:
                want_m = want_m.chunk(n, split[name])[i]
                want_v = want_v.chunk(n, split[name])[i]
        for g, w in ((gy, want_y), (gm, want_m), (gv, want_v)):
            np.testing.assert_allclose(g, w.numpy(), rtol=0, atol=1e-6)


def test_loss_without_global_batch_share_is_refused(fits):
    """Under data parallelism a loss must return this rank's share of the
    global batch's loss; an unmarked function (here a local mean, whose
    gradients would come out n times too large) is refused."""
    ranks, _, _ = fits
    for _, refused in ranks:
        assert refused is not None and "global_batch_loss" in refused


def _wmt_files(tmp):
    """A tiny parallel corpus whose sentences run 2-9 words (pads in every
    batch) and its vocabularies: (src, tgt, src-vocab, tgt-vocab)."""
    rng = np.random.default_rng(7)
    (tmp / "sv").write_text("\n".join(f"s{i}" for i in range(20)))
    (tmp / "tv").write_text("\n".join(f"t{i}" for i in range(24)))
    lines = [[], []]
    for _ in range(8):
        for side, (p, n) in enumerate((("s", 22), ("t", 26))):
            words = rng.integers(0, n, rng.integers(2, 10))
            lines[side].append(" ".join(f"{p}{j}" for j in words))
    (tmp / "src").write_text("\n".join(lines[0]) + "\n")
    (tmp / "tgt").write_text("\n".join(lines[1]) + "\n")
    return [str(tmp / k) for k in ("src", "tgt", "sv", "tv")]


def test_wmt_data_parallel_matches_one_rank(tmp_path):
    """One float32 step (8 sentences) of real-data wmt, dropout 0.1, on two
    ranks against one; then the CLI's ``--data-parallel 2`` step, whose
    ranks end with the same parameters."""
    files = _wmt_files(tmp_path)
    loss, grads, _ = torch_ranks.wmt_step(0, 1, files, one_rank=True)
    ranks = torch_ranks.run(torch_ranks.wmt_step, 2, tmp_path, files)
    scale = max(np.abs(g).max() for g in grads)
    for got_loss, got_grads, *_ in ranks:
        assert abs(got_loss - loss) <= 1e-6 * abs(loss)
        for a, b in zip(got_grads, grads):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6 * scale)
    (_, _, p0, cli0, cli_p0), (_, _, p1, cli1, cli_p1) = ranks
    for a, b in zip(p0 + cli_p0, p1 + cli_p1):
        assert np.array_equal(a, b)
    assert np.isfinite(cli0) and cli0 == cli1
