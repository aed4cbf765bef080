"""Port parity: the LM's composed data x model x seq training step on 8
gloo ranks against ccv_tpu's on the 8 virtual CPU devices
(tests/test_composed_parallel.py's model and batch): on a 2 x 2 x 2 mesh
(Megatron blocks and ring attention inside them) and a data 4 x model 2
mesh (tensor parallelism alone), the loss within 1e-5 relative of
ccv_tpu's composed step's and every gradient, reassembled from the
ranks' blocks, within 1e-4 of the largest; and ``shardings()``'s
placements, dimensions that do not divide replicated, as ccv_tpu's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import test_torch_parallel_ranks as torch_ranks
from ccv_tpu.models import transformer as jtfm

TP = 2
CFG = dict(vocab_size=64, layers=2, heads=2 * TP, head_dim=8, ff=16 * TP,
           max_len=16, dropout=0.0)
B, T = 4, 16
MESHES = [{"data": 2, "model": 2, "seq": 2}, {"data": 4, "model": 2}]


def _composed(params, ids):
    """ccv_tpu's composed step (RingSpec over 'seq', shardings on the
    mesh): loss and gradient leaves."""
    cfg = jtfm.TransformerConfig(**CFG, dtype=jnp.float32)
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 2, 2),
                ("data", "model", "seq"))
    ring = jtfm.RingSpec(mesh, seq_axis="seq", batch_axis="data",
                         head_axis="model")
    sh = jtfm.shardings(params, mesh)
    ps = jax.tree_util.tree_map(jax.device_put, params, sh)
    ids_s = jax.device_put(ids, NamedSharding(mesh, P("data", None)))

    @jax.jit
    def step(p, ids):
        def loss_fn(p):
            logits = jtfm.lm_forward(p, cfg, ids[:, :-1], ring=ring)
            return jtfm.cross_entropy(logits, ids[:, 1:])
        return jax.value_and_grad(loss_fn)(p)
    loss, g = step(ps, ids_s)
    return float(loss), [np.asarray(a) for a in jax.tree_util.tree_leaves(g)]


def _odd_tree():
    """A model whose vocabulary (63) and ff (17) do not divide over 2."""
    cfg = jtfm.TransformerConfig(**{**CFG, "vocab_size": 63, "ff": 17},
                                 dtype=jnp.float32)
    return jax.tree_util.tree_map(
        np.asarray, jtfm.init_lm(jax.random.PRNGKey(4), cfg)), cfg


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    cfg = jtfm.TransformerConfig(**CFG, dtype=jnp.float32)
    params = jtfm.init_lm(jax.random.PRNGKey(0), cfg)
    ids = jax.random.randint(jax.random.PRNGKey(1), (B, T + 1), 0,
                             cfg.vocab_size, dtype=jnp.int32)
    tree = jax.tree_util.tree_map(np.asarray, params)
    odd, _ = _odd_tree()
    ranks = torch_ranks.run(torch_ranks.lm_steps, 8,
                            tmp_path_factory.mktemp("lm"), tree, CFG,
                            np.asarray(ids), MESHES, odd)
    return ranks, _composed(params, ids)


def _whole(ranks, case):
    """Each gradient leaf from the blocks of the ranks at data 0 (and seq
    0), concatenated over 'model' along its split dimension."""
    by_model = {}
    for res, _ in ranks:
        loss, grads, split, coord = res[case]
        if coord.get("data", 0) == 0 and coord.get("seq", 0) == 0:
            by_model[coord["model"]] = (grads, split)
    grads0, split = by_model[0]
    return [g if d < 0 else np.concatenate(
        [by_model[m][0][i] for m in range(TP)], d)
        for i, (g, d) in enumerate(zip(grads0, split))]


@pytest.mark.parametrize("case", [0, 1], ids=["data_model_seq",
                                              "data_model"])
def test_lm_step_matches_ccv_tpu_composed(results, case):
    ranks, (loss, grads) = results
    for res, _ in ranks:
        got = res[case][0]
        assert abs(got - loss) <= 1e-5 * abs(loss), (got, loss)
    gmax = max(np.abs(g).max() for g in grads)
    got = _whole(ranks, case)
    assert [g.shape for g in got] == [g.shape for g in grads]
    for a, b in zip(got, grads):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * gmax)


def test_shardings_replicate_what_does_not_divide(results):
    """The port's placements name, per tensor dimension, the mesh axis
    ccv_tpu's shardings() shard it on (odd vocabulary and ff whole)."""
    ranks, _ = results
    odd, _ = _odd_tree()
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2),
                ("data", "model"))
    want = [tuple(s.spec) + (None,) * (np.ndim(p) - len(s.spec))
            for s, p in zip(jax.tree_util.tree_leaves(
                jtfm.shardings(odd, mesh)), jax.tree_util.tree_leaves(odd))]
    names = ("data", "model")
    for _, specs in ranks:
        got = [tuple(None if i < 0 else names[i] for i in s) for s in specs]
        assert got == want
    assert ("model", None) in want and (None, "model") in want
    # leaves in sorted-key order: ..., out (63 columns: whole), src_embed
    assert want[-2:] == [(None, None), (None, "model")]
