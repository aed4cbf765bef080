"""Port parity: ccv_tpu_torch.parallel's collectives (mesh.py) on 4 gloo
ranks against ccv_tpu's shard_map bodies on 4 of the 8 virtual CPU
devices: each collective's output and the gradient of sum(output * w)
within 1e-6 (the reference's autograd rules); the COMM_* commands; the
Megatron pair under a loss every rank repeats; distributed.init's
rendezvous rules and make_mesh's refusal of a world it does not fill."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import test_torch_parallel_ranks as torch_ranks
from ccv_tpu.parallel import mesh as jmesh
from ccv_tpu_torch.parallel import distributed, mesh as tmesh

N = 4
TOL = 1e-6


def _inputs():
    rng = np.random.default_rng(0)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(x=f(N, 3, 4), x2=f(N, N, 3), w=f(N, 3, 4),
                w_gather=f(N, N, 3, 4), w_scatter=f(N, 3))


def _shard_map():
    try:
        from jax import shard_map
    except ImportError:
        from jax.experimental.shard_map import shard_map
    return shard_map


def _jax_case(body, x, w):
    """(output blocks, gradient blocks) of sum(shard_map(body)(x) * w),
    the body taking and returning per-device blocks with a leading 1."""
    mesh = Mesh(np.array(jax.devices()[:N]), ("i",))
    fn = _shard_map()(body, mesh=mesh, in_specs=P("i"), out_specs=P("i"))
    out = fn(jnp.asarray(x))
    grad = jax.grad(lambda a: jnp.sum(fn(a) * w))(jnp.asarray(x))
    return np.asarray(out), np.asarray(grad)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    a = _inputs()
    return a, torch_ranks.run(torch_ranks.collectives, N,
                              tmp_path_factory.mktemp("mesh"), a["x"],
                              a["x2"], a["w"], a["w_gather"], a["w_scatter"])


RING = [(i, (i + 1) % N) for i in range(N)]
CASES = {
    "allreduce": (lambda b: jmesh.comm_allreduce(b, "i"), "x", "w"),
    "broadcast": (lambda b: jmesh.comm_broadcast(b, "i", root=1), "x", "w"),
    "reduce": (lambda b: jmesh.comm_reduce(b, "i"), "x", "w"),
    "all_gather": (lambda b: jmesh.all_gather(b[0], "i")[None], "x",
                   "w_gather"),
    "reduce_scatter": (lambda b: jmesh.reduce_scatter(b[0], "i")[None],
                       "x2", "w_scatter"),
    "ppermute": (lambda b: jmesh.ppermute(b, "i", RING), "x", "w"),
    "ppermute_partial": (lambda b: jmesh.ppermute(b, "i", [(0, 2)]), "x",
                         "w"),
}


@pytest.mark.parametrize("name", list(CASES))
def test_collective_and_gradient_match_shard_map(ranks, name):
    a, res = ranks
    body, xk, wk = CASES[name]
    out, grad = _jax_case(body, a[xk], a[wk])
    for r in range(N):
        got_out, got_grad = res[r][name]
        np.testing.assert_allclose(got_out, out[r], rtol=0, atol=TOL)
        np.testing.assert_allclose(got_grad, grad[r], rtol=0, atol=TOL)


def test_comm_commands_compute_the_collectives(ranks):
    a, res = ranks
    x = a["x"]
    for r in range(N):
        got = res[r]["cmd"]
        np.testing.assert_allclose(got["ALLREDUCE"], x.sum(0), atol=TOL)
        np.testing.assert_allclose(got["BROADCAST"], x[0], atol=0)
        np.testing.assert_allclose(got["REDUCE"], x.sum(0), atol=TOL)


def test_megatron_pair_under_a_repeated_loss(ranks):
    """With x replicated, reduce_from(copy_to(x) * (r + 1)) sums the ranks'
    products forward (10 x) and each rank's x gets the gradient of the one
    loss all ranks compute (10 w); gather_from's backward keeps each
    rank's slice of it."""
    a, res = ranks
    x, w, wg = a["x"], a["w"], a["w_gather"]
    whole = wg[0].transpose(1, 0, 2).reshape(3, -1)
    for r in range(N):
        got_y, got_g = res[r]["pair"]
        np.testing.assert_allclose(got_y, 10.0 * x[0], atol=TOL)
        np.testing.assert_allclose(got_g, 10.0 * w[0], atol=TOL)
        got_y, got_g = res[r]["gather_from"]
        np.testing.assert_allclose(got_y, np.concatenate(list(x), -1),
                                   atol=0)
        np.testing.assert_allclose(got_g, whole[:, 4 * r:4 * r + 4], atol=0)


def test_init_without_a_rendezvous_is_one_process(monkeypatch):
    for name in ("CCV_TPU_COORDINATOR", "CCV_TPU_NUM_PROCESSES",
                 "CCV_TPU_PROCESS_ID", "WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    assert distributed.init("gloo") is False
    assert distributed.process_count() == 1
    assert distributed.process_index() == 0
    with pytest.raises(ValueError, match="process_id"):
        distributed.init("gloo", "localhost:1", 2)
    monkeypatch.setenv("CCV_TPU_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="coordinator_address"):
        distributed.init("gloo")


def test_make_mesh_needs_the_whole_world(tmp_path):
    with pytest.raises(RuntimeError, match="distributed.init"):
        tmesh.make_mesh({"data": 1}, "cpu")
    assert distributed.init("gloo", f"file://{tmp_path}/store", 1, 0)
    try:
        with pytest.raises(RuntimeError, match="runs on gloo, not nccl"):
            distributed.init("nccl")
        with pytest.raises(ValueError, match="needs 2 ranks; the process "
                                             "group has 1"):
            tmesh.make_mesh({"data": 2}, "cpu")
        mesh = distributed.global_mesh(("data", "model"), device="cpu")
        assert mesh.mesh_dim_names == ("data", "model")
        assert tmesh.shard_batch(mesh) == (tmesh.Shard(0),
                                           tmesh.Replicate())
        assert tmesh.replicate(mesh) == (tmesh.Replicate(),) * 2
        x = torch.arange(6.0).reshape(3, 2)
        assert torch.equal(tmesh.local_shard(x, mesh, tmesh.shard_batch(
            mesh)), x)
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.cuda
def test_ppermute_stages_cuda_tensors_over_gloo(tmp_path):
    """On the card, gloo takes send / recv only from host memory:
    ppermute stages CUDA tensors through pinned buffers, two copies a rank
    each way (forward and backward), and returns CUDA tensors with the
    ring's values and the inverse permutation's gradient."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5)).astype(np.float32)
    w = rng.standard_normal((2, 5)).astype(np.float32)
    res = torch_ranks.run(torch_ranks.permute_cuda, 2, tmp_path, x, w)
    for r, (kind, y, grad, staged) in enumerate(res):
        assert kind == "cuda"
        np.testing.assert_array_equal(y, x[1 - r])
        np.testing.assert_array_equal(grad, w[1 - r])
        assert staged == {"copies": 4, "bytes": 4 * 5 * 4}
