"""Port parity: ring attention (ccv_tpu_torch/parallel/sequence.py) on 4
gloo ranks against ccv_tpu's ring_attention on 4 virtual CPU devices:
the output and the gradients of sum(out * w) for q, k and v, causal and
not, within 1e-5 of the largest; and the regression of
tests/test_sequence_parallel.py:35, two meshes with one axis name and two
sizes (the ring's length comes from the mesh passed in)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import test_torch_parallel_ranks as torch_ranks
from ccv_tpu.parallel.sequence import ring_attention

N = 4
REL = 1e-5
B, T, H, D = 2, 32, 2, 8


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, T, H, D)).astype(np.float32)
            for _ in range(4)]


def _jax_ring(q, k, v, w, causal, n):
    mesh = Mesh(np.array(jax.devices()[:n]), ("seq",))

    @jax.jit
    def out_and_grads(q, k, v):
        out, vjp = jax.vjp(lambda *a: ring_attention(
            *a, mesh, "seq", is_causal=causal), q, k, v)
        return (out, *vjp(jnp.asarray(w)))
    return [np.asarray(a) for a in out_and_grads(q, k, v)]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The port's ranks for each case (one spawn of 4 ranks), and
    ccv_tpu's global results."""
    cases, refs = [], {}
    for causal in (False, True):
        q, k, v, w = _inputs(int(causal))
        cases.append((q, k, v, w, causal, {"seq": N}))
        refs[causal] = _jax_ring(q, k, v, w, causal, N)
    # one axis name, two sizes: a ring of 4, then (data 2, seq 2)
    q, k, v, w = _inputs(5)
    cases += [(q, k, v, w, True, {"seq": 4}),
              (q, k, v, w, True, {"data": 2, "seq": 2})]
    refs["two_meshes"] = _jax_ring(q, k, v, w, True, 4)
    ranks = torch_ranks.run(torch_ranks.ring, N,
                            tmp_path_factory.mktemp("ring"), cases)
    return [[r[i] for r in ranks] for i in range(len(cases))], cases, refs


def _blocks(axes):
    """Rank -> (batch slice, sequence slice) of its block."""
    names = list(axes)
    sizes = [axes[n] for n in names]
    out = []
    for r in range(int(np.prod(sizes))):
        coord = dict(zip(names, np.unravel_index(r, sizes)))
        b = axes.get("data", 1)
        db, i = B // b, int(coord.get("data", 0))
        t = T // axes["seq"]
        s = int(coord["seq"])
        out.append((slice(i * db, (i + 1) * db), slice(s * t, (s + 1) * t)))
    return out


def _check(ranks, ref, axes):
    for r, (bs, ts) in enumerate(_blocks(axes)):
        for got, want in zip(ranks[r], ref):
            err = np.abs(got - want[bs, ts]).max() / np.abs(want).max()
            assert err <= REL, (r, err)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_and_its_gradients_match(results, causal):
    """out, dq, dk and dv, each against its own largest magnitude."""
    ranks, cases, refs = results
    _check(ranks[int(causal)], refs[causal], cases[int(causal)][5])


def test_two_meshes_same_axis_name_different_sizes(results):
    ranks, cases, refs = results
    for i in (2, 3):
        _check(ranks[i], refs["two_meshes"], cases[i][5])
