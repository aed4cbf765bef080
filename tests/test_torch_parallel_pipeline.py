"""Port parity: GPipe (ccv_tpu_torch/parallel/pipeline.py) and the
expert-parallel MoE (nn/moe.py) on 4 gloo ranks against ccv_tpu on the
virtual CPU devices: gpipe's output and, under grad, every stage's
gradients within 1e-5 of ccv_tpu's 4-stage pipeline; the MoE forward with
2 experts a rank equal to the dense forward and to ccv_tpu's (output and
aux loss within 1e-5), its gradients (sum(out^2) + aux) equal to the
dense forward's, and moe.shardings' placements."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import test_torch_parallel_ranks as torch_ranks
from ccv_tpu.nn import moe as jmoe
from ccv_tpu.parallel import pipeline as jpipe
from ccv_tpu_torch.nn import moe as tmoe

N = 4
TOL = 1e-5
S, M, B, D = 4, 6, 2, 8
MOE = dict(dim=16, ff=32, experts=8, top_k=2, capacity_factor=4.0)


def _gpipe_ref(w, b, x_mb):
    """ccv_tpu's gpipe: output and the gradients of sum(out^2)."""
    mesh = Mesh(np.array(jax.devices()[:S]), ("stage",))

    def stage_fn(p, x):
        return jnp.tanh(x @ p["w"] + p["b"])

    @jax.jit
    def run(params):
        def loss(params):
            out = jpipe.gpipe(stage_fn, params, jnp.asarray(x_mb), mesh,
                              axis="stage")
            return jnp.sum(out ** 2), out
        (_, out), g = jax.value_and_grad(loss, has_aux=True)(params)
        return out, g
    out, g = run({"w": jnp.asarray(w), "b": jnp.asarray(b)})
    return np.asarray(out), np.asarray(g["w"]), np.asarray(g["b"])


def _moe_ref(params, x):
    """ccv_tpu's MoE, dense and expert-parallel over 8 devices."""
    cfg = jmoe.MoEConfig(**MOE)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    dense = jmoe.forward(jp, cfg, jnp.asarray(x))
    mesh = Mesh(np.array(jax.devices()[:8]), ("expert",))
    psh = jmoe.shardings(jp, mesh, axis="expert")
    sh = jax.tree_util.tree_map(jax.device_put, jp, psh)
    with mesh:
        split = jax.jit(lambda p, v: jmoe.forward(p, cfg, v))(
            sh, jax.device_put(jnp.asarray(x), NamedSharding(mesh, P())))
    return [(np.asarray(o), float(a)) for o, a in (dense, split)]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((S, D, D)) * 0.3).astype(np.float32)
    b = (rng.standard_normal((S, D)) * 0.1).astype(np.float32)
    x_mb = rng.standard_normal((M, B, D)).astype(np.float32)
    moe_params = {k: np.asarray(v) for k, v in jmoe.init(
        jax.random.PRNGKey(2), jmoe.MoEConfig(**MOE)).items()}
    moe_x = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (4, 8, 16)))
    ranks = torch_ranks.run(torch_ranks.pipeline_and_moe, N,
                            tmp_path_factory.mktemp("pipe"), w, b, x_mb,
                            moe_params, MOE, moe_x)
    return dict(ranks=ranks, gpipe=_gpipe_ref(w, b, x_mb),
                moe=_moe_ref(moe_params, moe_x), moe_params=moe_params,
                moe_x=moe_x)


def test_gpipe_matches_ccv_tpu(results):
    out, _, _ = results["gpipe"]
    for r in range(N):
        np.testing.assert_allclose(results["ranks"][r]["gpipe"][0], out,
                                   rtol=0, atol=TOL)


def test_gpipe_under_grad_matches_ccv_tpu(results):
    """Each rank's stage gradients are ccv_tpu's for that stage."""
    _, gw, gb = results["gpipe"]
    for r in range(N):
        _, got_w, got_b = results["ranks"][r]["gpipe"]
        np.testing.assert_allclose(got_w[0], gw[r], rtol=0, atol=TOL)
        np.testing.assert_allclose(got_b[0], gb[r], rtol=0, atol=TOL)


def _dense_port(params, x):
    """The port's dense forward: output, aux and the gradients of
    sum(out^2) + aux."""
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    out, aux = tmoe.forward(tp, tmoe.MoEConfig(**MOE), torch.tensor(x))
    ((out ** 2).sum() + aux).backward()
    return (out.detach().numpy(), float(aux.detach()),
            {k: v.grad.numpy() for k, v in tp.items()})


def test_expert_parallel_moe_matches_dense_and_ccv_tpu(results):
    (j_dense, j_aux), (j_split, j_split_aux) = results["moe"]
    out, aux, _ = _dense_port(results["moe_params"], results["moe_x"])
    np.testing.assert_allclose(out, j_dense, rtol=0, atol=TOL)
    for r in range(N):
        got, got_aux, _, _ = results["ranks"][r]["moe"]
        for want, want_aux in ((out, aux), (j_dense, j_aux),
                               (j_split, j_split_aux)):
            np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
            assert abs(got_aux - want_aux) <= TOL * abs(want_aux)


def test_expert_parallel_moe_gradients_match_dense(results):
    """Each rank's experts' gradients are the dense forward's for those
    experts, and every rank's router gradient is the dense one."""
    _, _, grads = _dense_port(results["moe_params"], results["moe_x"])
    e = MOE["experts"] // N
    for r in range(N):
        got, places = results["ranks"][r]["moe"][2:]
        assert "Replicate" in places["router"] and "Shard(dim=0)" in \
            places["w1"]
        for k, g in got.items():
            want = grads[k] if k == "router" else grads[k][r * e:(r + 1) * e]
            scale = np.abs(grads[k]).max()
            np.testing.assert_allclose(g, want, rtol=0, atol=TOL * scale)
