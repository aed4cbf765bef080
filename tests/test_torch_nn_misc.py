"""Port parity: ccv_tpu_torch/nn/{moe,compression,control_flow}.py against
ccv_tpu's, on the CPU, on the same numpy inputs and ``ccv_tpu``'s
parameters.

Tolerances: float32 within 1e-5 + 1e-5 * max|ccv_tpu| (the same float32
arithmetic in another order); gradients through the recomputed backward
the same; LSSC's float16 endpoints, packed index words and decompressed
values equal; MoE routing (expert choices, capacity drops, ties to the
lower expert) equal through the outputs; loop results equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccv_tpu.nn import compression as jcomp
from ccv_tpu.nn import control_flow as jcf
from ccv_tpu.nn import layers as JL
from ccv_tpu.nn import moe as jmoe
from ccv_tpu_torch.nn import compression as tcomp
from ccv_tpu_torch.nn import control_flow as tcf
from ccv_tpu_torch.nn import layers as TL
from ccv_tpu_torch.nn import moe as tmoe


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _close(got, want):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape, (got.shape, want.shape)
    tol = 1e-5 + 1e-5 * float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= tol


# ---------------------------------------------------------------------------
# mixture of experts
# ---------------------------------------------------------------------------

def _moe_pair(cfg_kw, seed, router=None):
    jcfg, tcfg = jmoe.MoEConfig(**cfg_kw), tmoe.MoEConfig(**cfg_kw)
    jp = jmoe.init(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    jp = {k: (jnp.asarray(rng.normal(0, 0.1, v.shape), jnp.float32)
              if k.startswith("b") else v) for k, v in jp.items()}
    if router is not None:
        jp["router"] = jnp.asarray(router)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("case", ["dense", "drops", "ties", "batched"])
def test_moe_forward(case):
    kw = dict(dim=16, ff=32, experts=4, top_k=2)
    shape, capacity, router = (20, 16), None, None
    if case == "drops":
        capacity = 3  # most tokens overflow their expert
    if case == "ties":
        router = np.zeros((16, 4), np.float32)  # every choice a tie
        router[:, 3] = 0.05
    if case == "batched":
        shape, kw = (2, 9, 16), dict(kw, top_k=1, capacity_factor=2.0)
    jcfg, tcfg, jp, tp = _moe_pair(kw, 3, router)
    x = _rand(shape, 4)
    jout, jaux = jmoe.forward(jp, jcfg, jnp.asarray(x), capacity)
    tout, taux = tmoe.forward(tp, tcfg, torch.from_numpy(x), capacity)
    _close(tout, jout)
    _close(taux, jaux)


def test_moe_bf16_input_and_init():
    jcfg, tcfg, jp, tp = _moe_pair(dict(dim=16, ff=32, experts=4), 5)
    x = _rand((12, 16), 6)
    jout, _ = jmoe.forward(jp, jcfg, jnp.asarray(x, jnp.bfloat16))
    tout, _ = tmoe.forward(tp, tcfg, torch.from_numpy(x).to(torch.bfloat16))
    assert tout.dtype == torch.bfloat16
    want = np.asarray(jnp.asarray(jout, jnp.float32))
    assert float(np.abs(tout.float().numpy() - want).max()) <= \
        1e-2 * float(np.abs(want).max())
    p = tmoe.init(torch.Generator().manual_seed(0),
                  tmoe.MoEConfig(dim=64, ff=256, experts=8), device="cpu")
    lim = (6.0 / (64 + 256)) ** 0.5
    assert p["w1"].shape == (8, 64, 256) and p["w2"].shape == (8, 256, 64)
    assert float(p["w1"].abs().max()) <= lim
    assert abs(float(p["router"].std()) - 0.02) < 2e-3
    assert not p["b1"].any() and not p["b2"].any()


# ---------------------------------------------------------------------------
# LSSC compression and the recomputed backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,dtype", [((2, 7, 10, 3), "float32"),
                                         ((8, 8, 2), "float16"),
                                         ((1, 2, 5, 9, 4), "float32")])
def test_lssc_matches_ccv_tpu(shape, dtype):
    x = _rand(shape, 7, 3.0)
    x.reshape(-1)[:20] = 1.5  # a flat block: hi == lo
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jlo, jhi, jidx = jcomp.lssc_compress(jx)
    tlo, thi, tidx = tcomp.lssc_compress(tx)
    np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(thi.numpy(), np.asarray(jhi))
    np.testing.assert_array_equal(tidx.numpy().view(np.uint32),
                                  np.asarray(jidx))
    want = jcomp.lssc_decompress(jlo, jhi, jidx, shape)
    got = tcomp.lssc_decompress(tlo, thi, tidx, shape)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the 4:1 code keeps each value within a third of its block's range
    assert float((got - tx.float()).abs().max()) <= \
        float(tx.float().abs().max()) * 2


def _conv_layers():
    return (JL.Convolution(4, (3, 3), name="c"),
            TL.Convolution(4, (3, 3), name="c"))


@pytest.mark.parametrize("kind", ["compressed", "reduced"])
def test_recomputed_backward_matches_ccv_tpu(kind):
    """The forward is the layer's; the gradients (input and parameters) are
    ``ccv_tpu``'s custom_vjp's, taken on the decompressed (or bf16) input."""
    jl, tl = _conv_layers()
    shape = (2, 6, 7, 3)
    jp, js, _ = jl.init(jax.random.PRNGKey(0), shape)
    jp["b"] = jnp.asarray(_rand((4,), 8))
    tp = {k: torch.from_numpy(np.array(v)).requires_grad_()
          for k, v in jp.items()}
    x, g = _rand(shape, 9), _rand((2, 6, 7, 4), 10)
    if kind == "compressed":
        jf = jcomp.compressed_apply(jl.apply, shape, jnp.float32, True)
        tf = tcomp.compressed_apply(tl.apply, shape, torch.float32, True)
    else:
        jf = jcomp.reduced_apply(jl.apply, jnp.float32, True)
        tf = tcomp.reduced_apply(tl.apply, torch.float32, True)

    def jloss(p, xx):
        y, _ = jf(p, js, xx, jax.random.PRNGKey(0))
        return jnp.sum(y * g), y

    (_, jy), (jdp, jdx) = jax.value_and_grad(jloss, argnums=(0, 1),
                                             has_aux=True)(jp, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    ty, ts = tf(tp, {}, tx)
    assert ts == {}
    (ty * torch.from_numpy(g)).sum().backward()
    _close(ty, jy)
    _close(tx.grad, jdx)
    for k in jdp:
        _close(tp[k].grad, jdp[k])


# ---------------------------------------------------------------------------
# control flow
# ---------------------------------------------------------------------------

def _collatz(carry, mod):
    n, steps = carry
    odd = n % 2 == 1
    return mod.where(odd, 3 * n + 1, n // 2), steps + 1


@pytest.mark.parametrize("max_iter", [None, 5, 200])
def test_while_loop(max_iter):
    for start in (6, 27, 1):
        want = jcf.while_loop(lambda c: c[0] != 1,
                              lambda c: _collatz(c, jnp),
                              (jnp.int32(start), jnp.int32(0)), max_iter)
        got = tcf.while_loop(lambda c: c[0] != 1,
                             lambda c: _collatz(c, torch),
                             (torch.tensor(start), torch.tensor(0)),
                             max_iter)
        assert [int(v) for v in got] == [int(v) for v in want]


def test_while_loop_dict_carry_and_gradient():
    """A dict carry; the bounded loop's gradient equals JAX's through its
    masked scan."""
    def body(c, mod):
        return {"x": c["x"] * 1.5 + mod.sin(c["x"]), "i": c["i"] + 1}

    x0 = 0.3

    def jrun(x):
        return jcf.while_loop(lambda c: c["i"] < 4, lambda c: body(c, jnp),
                              {"x": x, "i": jnp.int32(0)}, 10)["x"]

    want, wgrad = jax.value_and_grad(jrun)(jnp.float32(x0))
    tx = torch.tensor(x0, requires_grad=True)
    got = tcf.while_loop(lambda c: c["i"] < 4, lambda c: body(c, torch),
                         {"x": tx, "i": torch.tensor(0)}, 10)["x"]
    got.backward()
    _close(got, want)
    _close(tx.grad, wgrad)


@pytest.mark.parametrize("index", [-3, 0, 1, 2, 7])
def test_case_of_clamps(index):
    branches_j = [lambda a, b: a + b, lambda a, b: a * b,
                  lambda a, b: a - 2 * b]
    branches_t = [lambda a, b: a + b, lambda a, b: a * b,
                  lambda a, b: a - 2 * b]
    a, b = _rand((3,), 11), _rand((3,), 12)
    want = jcf.case_of(jnp.int32(index), branches_j, jnp.asarray(a),
                       jnp.asarray(b))
    got = tcf.case_of(torch.tensor(index), branches_t, torch.from_numpy(a),
                      torch.from_numpy(b))
    _close(got, want)
