"""Port parity: the transformer-LM training path of ccv_tpu_torch against
ccv_tpu (models/transformer.py, nn/optimizers.adam) on the same parameters
and tokens, on the CPU.

Tolerances:
- float32 logits and loss: 1e-4 absolute and relative (the same f32
  arithmetic, summed in another order);
- bfloat16 logits: 3e-2 of the largest logit magnitude. Both sides run bf16
  matmuls, but XLA and PyTorch round intermediate results at different
  places, and the differences grow through the layers;
- gradients: 1e-5 absolute, 1e-4 relative;
- parameters after two Adam steps: 1e-5 absolute (a hundredth of the
  rate, 1e-3) wherever both steps' gradients exceed 1e-4 (ten times the
  gradients' tolerance), twice the rate elsewhere; the Adam arithmetic
  alone is held to 1e-7 in test_adam_family_update_matches_jax. Adam's update is m / (sqrt(v) + eps), about the
  gradient's sign times the rate on its first steps, so a gradient near 0
  turns rounding noise into a move of up to the rate. The key bias ``bk``
  is such a parameter throughout: adding q.bk to every score of a row
  leaves the softmax unchanged, so its true gradient is 0;
- remat against no remat: equal to 1e-6 (the same ops, run again).
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccv_tpu.models import transformer as jtf
from ccv_tpu.nn import optimizers as jopt
from ccv_tpu_torch.bin import lm_bench
from ccv_tpu_torch.models import transformer as ttf
from ccv_tpu_torch.nn import optimizers as topt

SMALL = dict(vocab_size=97, layers=2, heads=2, head_dim=32, ff=128,
             max_len=33, dropout=0.0)
B, T = 2, 33
F32_TOL = dict(atol=1e-4, rtol=1e-4)


def _cfgs(dtype: str, **kw):
    args = {**SMALL, **kw}
    return (jtf.TransformerConfig(dtype=getattr(jnp, dtype), **args),
            ttf.TransformerConfig(dtype=getattr(torch, dtype), **args))


def _params(jcfg):
    jparams = jtf.init_lm(jax.random.PRNGKey(0), jcfg)
    return jparams, ttf.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")


def _ids(seed=1, t=T):
    return np.random.default_rng(seed).integers(0, SMALL["vocab_size"],
                                                (B, t + 1))


def test_params_from_jax_is_a_copy_of_the_tree():
    jcfg, tcfg = _cfgs("float32")
    jparams, tparams = _params(jcfg)
    jl = jax.tree_util.tree_leaves(jparams)
    tl = topt.leaves(tparams)
    assert len(jl) == len(tl) == 2 + 15 * SMALL["layers"]
    for a, b in zip(jl, tl):
        assert b.dtype == torch.float32 and b.requires_grad
        np.testing.assert_array_equal(b.detach().numpy(), np.asarray(a))
    # the port's own init gives the same structure and shapes
    mine = topt.leaves(ttf.init_lm(torch.Generator().manual_seed(0), tcfg))
    assert [tuple(p.shape) for p in mine] == [tuple(p.shape) for p in tl]


def test_params_from_jax_with_no_device_needs_a_card(monkeypatch):
    """No device and no card raises rather than copying to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tree = {"w": np.ones((2, 3), np.float32), "b": [np.zeros(3, np.float32)]}
    with pytest.raises(RuntimeError, match="CUDA device is required"):
        ttf.params_from_jax(tree)
    got = ttf.params_from_jax(tree, device="cpu")
    assert got["w"].device.type == "cpu" and got["b"][0].requires_grad


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_forward_matches_jax(dtype):
    jcfg, tcfg = _cfgs(dtype)
    jparams, tparams = _params(jcfg)
    ids = _ids()[:, :T]
    want = np.asarray(jtf.lm_forward(jparams, jcfg, jnp.asarray(ids)))
    got = ttf.lm_forward(tparams, tcfg, torch.from_numpy(ids)).detach()
    assert got.dtype == torch.float32 and got.shape == (B, T, 97)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    else:
        err = np.abs(got.numpy() - want).max()
        assert err <= 3e-2 * np.abs(want).max(), err


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_jax(smoothing, masked):
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((3, 7, 11), np.float32) * 3
    labels = rng.integers(0, 11, (3, 7))
    mask = rng.random((3, 7)) < 0.6 if masked else None
    want = jtf.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                             smoothing, None if mask is None
                             else jnp.asarray(mask))
    got = ttf.cross_entropy(torch.from_numpy(logits),
                            torch.from_numpy(labels), smoothing,
                            None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def _jax_steps(jcfg, jparams, ids, opt, n):
    state = opt.init(jparams)

    def loss_fn(p):
        logits = jtf.lm_forward(p, jcfg, ids[:, :-1], train=True)
        return jtf.cross_entropy(logits, ids[:, 1:])

    losses, grads = [], []
    for _ in range(n):
        loss, g = jax.value_and_grad(loss_fn)(jparams)
        jparams, state = opt.update(g, state, jparams)
        losses.append(float(loss))
        grads.append([np.asarray(x) for x in jax.tree_util.tree_leaves(g)])
    return losses, grads, jparams


def test_train_steps_match_jax():
    """Two steps of loss, backward and Adam (coupled L2 decay) from the same
    parameters and tokens."""
    jcfg, tcfg = _cfgs("float32")
    jparams, tparams = _params(jcfg)
    ids = _ids()
    kw = dict(rate=1e-3, decay=0.01)
    want_losses, want_grads, want = _jax_steps(
        jcfg, jparams, jnp.asarray(ids), jopt.adam(**kw), 2)
    opt = topt.adam(**kw)
    state = opt.init(tparams)
    t_ids = torch.from_numpy(ids)
    got_losses = [float(lm_bench.train_step(tparams, opt, state, tcfg, t_ids))
                  for _ in range(2)]
    assert state.step == 2
    np.testing.assert_allclose(got_losses, want_losses, **F32_TOL)
    paths = [jax.tree_util.keystr(p)
             for p, _ in jax.tree_util.tree_leaves_with_path(want)]
    for path, p, g1, g2, b in zip(paths, topt.leaves(tparams), *want_grads,
                                  jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(p.grad.numpy(), g2, atol=1e-5, rtol=1e-4,
                                   err_msg=path)
        err = np.abs(p.detach().numpy() - np.asarray(b))
        clear = (np.abs(g1) > 1e-4) & (np.abs(g2) > 1e-4)
        assert err.max() <= 2 * kw["rate"], path
        assert (err[clear] <= 1e-5).all(), (path, err[clear].max())
    assert sum(int(((np.abs(g1) > 1e-4) & (np.abs(g2) > 1e-4)).sum())
               for g1, g2 in zip(*want_grads)) > 0.75 * sum(
                   g.size for g in want_grads[0])


@pytest.mark.parametrize("kind,amsgrad", [("adam", True), ("adamw", False)])
def test_adam_family_update_matches_jax(kind, amsgrad):
    rng = np.random.default_rng(3)
    params = {"a": rng.standard_normal((5, 4), np.float32),
              "b": [rng.standard_normal((3,), np.float32)]}
    jo = getattr(jopt, kind)(rate=1e-2, scale=0.5, decay=0.05,
                             amsgrad=amsgrad)
    to = getattr(topt, kind)(rate=1e-2, scale=0.5, decay=0.05,
                             amsgrad=amsgrad)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = {"a": torch.from_numpy(params["a"].copy()),
          "b": [torch.from_numpy(params["b"][0].copy())]}
    js, ts = jo.init(jp), to.init(tp)
    for step in range(3):
        grads = {"a": rng.standard_normal((5, 4), np.float32),
                 "b": [rng.standard_normal((3,), np.float32) * 1e-3]}
        jp, js = jo.update(jax.tree_util.tree_map(jnp.asarray, grads), js, jp)
        out, ts = to.update({"a": torch.from_numpy(grads["a"]),
                             "b": [torch.from_numpy(grads["b"][0])]}, ts, tp)
        assert out is tp  # in place
        for a, b in zip(topt.leaves(tp), jax.tree_util.tree_leaves(jp)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-7,
                                       rtol=1e-6)


def _grads(tcfg, tparams, ids, key_seed=None):
    for p in topt.leaves(tparams):
        p.grad = None
    key = (None if key_seed is None
           else torch.Generator().manual_seed(key_seed))
    logits = ttf.lm_forward(tparams, tcfg, ids[:, :-1], train=True, key=key)
    loss = ttf.cross_entropy(logits, ids[:, 1:])
    loss.backward()
    return float(loss.detach()), [p.grad.clone() for p in topt.leaves(tparams)]


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("dropout,flash", [(0.0, False), (0.1, False),
                                           (0.0, True)],
                         ids=["plain", "dropout", "flash"])
def test_remat_gives_the_gradients_of_no_remat(policy, dropout, flash):
    """Checkpointed blocks recompute the same values; with dropout the
    recompute draws the same masks. "flash" sends attention through the
    FlashAttention autograd function (its plain versions on the CPU; the
    kernels take no attention dropout)."""
    jcfg, tcfg = _cfgs("float32", dropout=dropout)
    _, tparams = _params(jcfg)
    ids = torch.from_numpy(_ids())
    seed = 5 if dropout else None
    with lm_bench.plain_attention(False):
        saved = ttf._use_flash
        if flash:
            ttf._use_flash = lambda *a: True
        try:
            loss0, g0 = _grads(tcfg, tparams, ids, seed)
            rcfg = ttf.TransformerConfig(**{**tcfg.__dict__, "remat": True,
                                            "remat_policy": policy})
            loss1, g1 = _grads(rcfg, tparams, ids, seed)
        finally:
            ttf._use_flash = saved
    assert loss0 == pytest.approx(loss1, rel=1e-6)
    for a, b in zip(g0, g1):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def test_dots_policy_keeps_the_weight_matmuls():
    """Under "dots" the backward runs no weight matmul again (as many
    aten.mm as without remat) but recomputes attention's batched products;
    under "full" it runs every weight matmul again. A dispatch mode outside
    the checkpoint sees only the ops that really run, not those the
    selective checkpoint answers from its cache."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops[func] += 1
            return func(*args, **(kwargs or {}))

    jcfg, tcfg = _cfgs("float32")
    _, tparams = _params(jcfg)
    ids = torch.from_numpy(_ids())

    def backward_ops(cfg):
        logits = ttf.lm_forward(tparams, cfg, ids[:, :-1], train=True)
        loss = ttf.cross_entropy(logits, ids[:, 1:])
        with Count() as count:
            loss.backward()
        return (count.ops[torch.ops.aten.mm.default],
                count.ops[torch.ops.aten.bmm.default])

    counts = {policy: backward_ops(ttf.TransformerConfig(
        **{**tcfg.__dict__, "remat": policy is not None,
           "remat_policy": policy or "full"}))
        for policy in (None, "dots", "full")}
    n = SMALL["layers"]
    (mm0, bmm0), (mm_dots, bmm_dots), (mm_full, bmm_full) = counts.values()
    assert mm_dots == mm0 and mm_full == mm0 + 6 * n  # q, k, v, o, ff1, ff2
    assert bmm_dots == bmm_full == bmm0 + 2 * n       # scores, p @ v


def test_flash_path_matches_jax_grads():
    """The LM with attention through FlashAttention (plain versions on the
    CPU) against ccv_tpu's LM: logits and parameter gradients."""
    jcfg, tcfg = _cfgs("float32")
    jparams, tparams = _params(jcfg)
    ids = _ids()

    def loss_fn(p):
        logits = jtf.lm_forward(p, jcfg, jnp.asarray(ids[:, :-1]))
        return jtf.cross_entropy(logits, jnp.asarray(ids[:, 1:]))

    want_loss, want = jax.value_and_grad(loss_fn)(jparams)
    saved = ttf._use_flash
    ttf._use_flash = lambda *a: True
    try:
        loss, grads = _grads(tcfg, tparams, torch.from_numpy(ids))
    finally:
        ttf._use_flash = saved
    assert loss == pytest.approx(float(want_loss), rel=1e-5)
    for a, b in zip(grads, jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=1e-4)


def test_use_flash_follows_the_reference_rule():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert ttf._use_flash(None, 0.1, False, cuda)
    assert ttf._use_flash(None, 0.0, True, cuda)
    assert not ttf._use_flash(None, 0.1, True, cuda)       # attn dropout
    assert not ttf._use_flash(torch.ones(1, 4), 0.0, False, cuda)  # mask
    assert not ttf._use_flash(None, 0.0, False, cpu)
    with lm_bench.plain_attention():
        assert not ttf._use_flash(None, 0.0, False, cuda)
    assert ttf._use_flash(None, 0.0, False, cuda)


def test_model_flops_is_the_reference_formula():
    n = 354_000_000
    assert lm_bench.model_flops(n, 24, 8, 1024, 1024) == (
        6.0 * n * 8 * 1024 + 3 * 12.0 * 24 * 8 * 1024 * 1024 * 1024 / 2)


def test_peak_tflops_follows_the_step_type(monkeypatch):
    """MFU's peak is the card's dense rate in the step's type: bf16 on the
    tensor cores, float32 outside them; an unlisted card raises."""
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA H100 80GB HBM3")
    assert lm_bench.peak_tflops(None) == 989.0
    assert lm_bench.peak_tflops(None, torch.bfloat16) == 989.0
    assert lm_bench.peak_tflops(None, torch.float32) == 67.0
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "some other card")
    with pytest.raises(ValueError, match="float32 peak"):
        lm_bench.peak_tflops(None, torch.float32)


def test_measure_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        lm_bench.measure(layers=1, dim=64, heads=4, ff=64, batch=1, seq=8,
                         vocab=11, steps=1)
