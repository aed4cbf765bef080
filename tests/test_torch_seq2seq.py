"""Port parity: the encoder-decoder and the encoder classifier of
ccv_tpu_torch (models/transformer.py, bin/wmt.py's loss, bin/iwslt.py's
accumulated Noam step and greedy decoding) against ccv_tpu's on the same
parameters and tokens, on the CPU, where ccv_tpu takes XLA's SDPA; and the
routing of attention between the flash kernels and the plain SDPA, and
the flash kernels' zero-padding of small head dims.

Tolerances:
- float32 logits and loss: 1e-4 absolute and relative (the same f32
  arithmetic, summed in another order);
- bfloat16 logits: 3e-2 of the largest logit magnitude. Both sides run bf16
  matmuls, but XLA and PyTorch round intermediate results at different
  places, and the differences grow through the layers;
- gradients of the wmt loss (float32): 1e-5 absolute, 1e-4 relative;
- parameters after two iwslt optimizer steps: as the LM's in
  test_torch_transformer.py, 1e-5 absolute (a hundredth of the rate,
  about 1e-3 here) wherever both steps' gradients exceed 1e-4, twice the
  rate elsewhere (Adam moves a parameter whose gradient is rounding noise,
  such as the key biases ``bk`` and ``xbk``, by up to its rate);
- greedy decoding in float32: the same tokens;
- flash attention at a padded head dim against the plain SDPA (float32):
  1e-5 absolute and relative, output and gradients (the padding adds exact
  zeros; only the order of the sums differs).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccv_tpu.models import transformer as jtf
from ccv_tpu.nn import autotune as jautotune
from ccv_tpu.nn import optimizers as jopt
from ccv_tpu_torch.bin import iwslt as t_iwslt
from ccv_tpu_torch.bin import wmt as t_wmt
from ccv_tpu_torch.models import transformer as ttf
from ccv_tpu_torch.nn import optimizers as topt
from ccv_tpu_torch.ops.kernels import flash_attention as tfa

BIN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "bin")

SMALL = dict(vocab_size=50, tgt_vocab_size=40, layers=2, heads=2,
             head_dim=32, ff=128, max_len=24, dropout=0.0)
B = 3
F32_TOL = dict(atol=1e-4, rtol=1e-4)
SPAD, TPAD = 49, 39


def _cfgs(dtype: str, **kw):
    args = {**SMALL, **kw}
    return (jtf.TransformerConfig(dtype=getattr(jnp, dtype), **args),
            ttf.TransformerConfig(dtype=getattr(torch, dtype), **args))


def _seq2seq_params(jcfg):
    jparams = jtf.init_encoder_decoder(jax.random.PRNGKey(0), jcfg)
    return jparams, ttf.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")


def _classifier_params(jcfg, classes=3):
    jparams = jtf.init_encoder_classifier(jax.random.PRNGKey(0), jcfg,
                                          classes)
    return jparams, ttf.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")


def _tokens(seed, t, vocab, pad):
    """(B, t) ids with rows of valid lengths t, t - 5, 3; pads after."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab - 4, (B, t))
    lengths = np.array([t, max(t - 5, 1), 3])
    mask = np.arange(t)[None] < lengths[:, None]
    return np.where(mask, ids, pad), mask


def _check(got: torch.Tensor, want, dtype: str):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32_TOL)
    else:
        err = np.abs(got - want).max()
        assert err <= 3e-2 * np.abs(want).max(), err


@pytest.mark.parametrize("ts,tt", [(12, 9), (11, 11)], ids=["ts!=tt",
                                                             "ts=tt"])
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_decoder_forward_matches_jax(dtype, masked, ts, tt):
    jcfg, tcfg = _cfgs(dtype)
    jparams, tparams = _seq2seq_params(jcfg)
    src, smask = _tokens(1, ts, 50, SPAD)
    tgt, tmask = _tokens(2, tt, 40, TPAD)
    masks = (smask, tmask) if masked else (None, None)
    want = jtf.encoder_decoder_forward(
        jparams, jcfg, jnp.asarray(src), jnp.asarray(tgt),
        *(None if m is None else jnp.asarray(m) for m in masks))
    got = ttf.encoder_decoder_forward(
        tparams, tcfg, torch.from_numpy(src), torch.from_numpy(tgt),
        *(None if m is None else torch.from_numpy(m) for m in masks))
    assert got.dtype == torch.float32 and got.shape == (B, tt, 40)
    _check(got, want, dtype)


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_classifier_forward_matches_jax(dtype, masked):
    """Its logits come back in the config's type (bf16 under a bf16
    config), as ccv_tpu's do."""
    jcfg, tcfg = _cfgs(dtype)
    jparams, tparams = _classifier_params(jcfg)
    src, smask = _tokens(3, 14, 50, SPAD)
    mask = smask if masked else None
    want = jtf.encoder_classifier_forward(
        jparams, jcfg, jnp.asarray(src),
        None if mask is None else jnp.asarray(mask))
    got = ttf.encoder_classifier_forward(
        tparams, tcfg, torch.from_numpy(src),
        None if mask is None else torch.from_numpy(mask))
    assert got.dtype == getattr(torch, dtype) == tcfg.dtype
    assert want.dtype == getattr(jnp, dtype)
    _check(got, want, dtype)


def test_params_from_jax_copies_both_trees():
    jcfg, tcfg = _cfgs("float32")
    # leaves: embeddings and the head, 15 a self-attention block, 24 a
    # decoder block (its cross-attention's 4 weights, 3 biases and ln_x)
    L = SMALL["layers"]
    for (jparams, tparams), mine, n_leaves in (
            (_seq2seq_params(jcfg),
             ttf.init_encoder_decoder(torch.Generator().manual_seed(0), tcfg),
             3 + 15 * L + 24 * L),
            (_classifier_params(jcfg),
             ttf.init_encoder_classifier(torch.Generator().manual_seed(0),
                                         tcfg, 3), 2 + 15 * L)):
        jl = jax.tree_util.tree_leaves(jparams)
        tl = topt.leaves(tparams)
        assert len(jl) == len(tl) == n_leaves
        for a, b in zip(jl, tl):
            assert b.dtype == torch.float32 and b.requires_grad
            np.testing.assert_array_equal(b.detach().numpy(), np.asarray(a))
        # the port's own init: the same structure and shapes
        assert [tuple(p.shape) for p in topt.leaves(mine)] == [
            tuple(p.shape) for p in tl]
        assert all(p.requires_grad for p in topt.leaves(mine))


def _wmt_batch(seed=4, ts=13, tt=10):
    src, _ = _tokens(seed, ts, 50, SPAD)
    tgt, _ = _tokens(seed + 1, tt, 40, TPAD)
    out = np.concatenate([tgt[:, 1:], np.full((B, 1), TPAD)], 1)
    return src, tgt, out


def _jax_loss(jcfg, smoothing):
    def loss_fn(p, src, tgt, out):
        logits = jtf.encoder_decoder_forward(p, jcfg, src, tgt,
                                             src_mask=src != SPAD)
        return jtf.cross_entropy(logits, out, label_smoothing=smoothing,
                                 mask=out != TPAD)
    return loss_fn


def test_wmt_loss_gradients_match_jax():
    """bin/wmt.py's loss (source mask, label smoothing 0.1, target pads
    masked) and its gradients, float32."""
    jcfg, tcfg = _cfgs("float32")
    jparams, tparams = _seq2seq_params(jcfg)
    batch = _wmt_batch()
    want_loss, want = jax.value_and_grad(_jax_loss(jcfg, 0.1))(
        jparams, *map(jnp.asarray, batch))
    loss = t_wmt.seq2seq_loss(tparams, tcfg, *map(torch.from_numpy, batch),
                              SPAD, TPAD, 0.1, None)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-5)
    paths = [jax.tree_util.keystr(p)
             for p, _ in jax.tree_util.tree_leaves_with_path(want)]
    for path, p, g in zip(paths, topt.leaves(tparams),
                          jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(g), atol=1e-5,
                                   rtol=1e-4, err_msg=path)


def test_iwslt_accumulated_steps_match_jax():
    """Two optimizer steps of --big-step 2 (four micro-batches), the mean
    gradient applied by Adam(beta2 0.98, eps 1e-9) at noam_lr's rate, as
    bin/iwslt.py's loop does."""
    jcfg, tcfg = _cfgs("float32")
    jparams, tparams = _seq2seq_params(jcfg)
    d_model, warmup, big = SMALL["heads"] * SMALL["head_dim"], 25, 2
    batches = [_wmt_batch(seed) for seed in (10, 20, 30, 40)]
    grad_fn = jax.value_and_grad(_jax_loss(jcfg, 0.1))
    opt = jopt.adam(rate=1.0, beta1=0.9, beta2=0.98, epsilon=1e-9)
    state, acc, means = opt.init(jparams), None, []
    for i, batch in enumerate(batches, 1):
        _, g = grad_fn(jparams, *map(jnp.asarray, batch))
        acc = g if acc is None else jax.tree_util.tree_map(jnp.add, acc, g)
        if i % big == 0:
            lr = t_iwslt.noam_lr(i // big, d_model, warmup)
            mean = jax.tree_util.tree_map(lambda x: x / big, acc)
            means.append([np.asarray(x)
                          for x in jax.tree_util.tree_leaves(mean)])
            jparams, state = opt.update(mean, state, jparams,
                                        rate=jnp.float32(lr))
            acc = None

    accum = t_iwslt.Accumulator(tparams, big, d_model, warmup)
    for batch in batches:
        accum.backward(t_wmt.seq2seq_loss(
            tparams, tcfg, *map(torch.from_numpy, batch), SPAD, TPAD, 0.1,
            None))
    assert accum.steps == 2 and accum.state.step == 2
    rate = t_iwslt.noam_lr(2, d_model, warmup)
    assert 5e-4 < t_iwslt.noam_lr(1, d_model, warmup) < rate < 5e-3
    paths = [jax.tree_util.keystr(p)
             for p, _ in jax.tree_util.tree_leaves_with_path(jparams)]
    clear_count = 0
    for path, p, g1, g2, b in zip(paths, topt.leaves(tparams), *means,
                                  jax.tree_util.tree_leaves(jparams)):
        assert p.grad is None  # zeroed after the step
        err = np.abs(p.detach().numpy() - np.asarray(b))
        clear = (np.abs(g1) > 1e-4) & (np.abs(g2) > 1e-4)
        clear_count += int(clear.sum())
        assert err.max() <= 2 * rate, path
        assert (err[clear] <= 1e-5).all(), (path, err[clear].max())
    assert clear_count > 0.75 * sum(g.size for g in means[0])


def test_noam_lr_is_the_reference_schedule():
    sys.path.insert(0, BIN)
    import iwslt as ref_iwslt
    for step in (0, 1, 2, 7, 199, 200, 201, 4000, 10 ** 5):
        for d, warmup in ((128, 200), (512, 4000), (64, 25)):
            assert t_iwslt.noam_lr(step, d, warmup) == ref_iwslt.noam_lr(
                step, d, warmup)


@pytest.mark.parametrize("finish", [False, True], ids=["full", "ends"])
def test_greedy_decode_matches_jax(finish):
    """Untrained float32 model; "ends" raises the end token's output
    column so rows finish at different steps (pads follow, and the loop
    stops when every row has ended)."""
    sys.path.insert(0, BIN)
    import iwslt as ref_iwslt
    jcfg, tcfg = _cfgs("float32")
    jparams, tparams = _seq2seq_params(jcfg)
    if finish:
        end = SMALL["tgt_vocab_size"] - 2
        jparams["out"] = jparams["out"].at[:, end].multiply(3.0)
        with torch.no_grad():
            tparams["out"][:, end] *= 3.0
    src, _ = _tokens(6, 12, 50, SPAD)
    want = ref_iwslt.greedy_decode(jparams, jcfg, jnp.asarray(src), SPAD,
                                   TPAD, 12)
    got = t_iwslt.greedy_decode(tparams, tcfg, torch.from_numpy(src), SPAD,
                                TPAD, 12)
    np.testing.assert_array_equal(got, want)
    ended = (got == SMALL["tgt_vocab_size"] - 2).any(1)
    assert ended.any() == finish and (got[:, 0] == 37).all()


# -- routing: which attentions take the flash kernels ----------------------

def _route_port(monkeypatch, fn):
    """(Tq, Tk, causal) of every attention the port sends to
    flash_attention, with the card's rule applied on the CPU."""
    calls = []
    rule = ttf._use_flash
    monkeypatch.setattr(ttf, "_use_flash", lambda mask, dropout, train, dev:
                        rule(mask, dropout, train, torch.device("cuda")))
    real = ttf.flash_attention

    def spy(q, k, v, scale=None, is_causal=False):
        calls.append((q.shape[1], k.shape[1], bool(is_causal)))
        return real(q, k, v, scale=scale, is_causal=is_causal)
    monkeypatch.setattr(ttf, "flash_attention", spy)
    out = fn()
    return calls, out


def _route_jax(monkeypatch, fn):
    """The same for ccv_tpu: its rule with the backend test dropped, and a
    spy on autotune's Pallas-or-XLA choice (answered with XLA, which runs
    on the CPU)."""
    calls = []
    monkeypatch.setattr(jtf, "_use_flash", lambda mask, dropout, train: (
        mask is None and (not train or dropout <= 0.0)))

    def choose(name, candidates, args, default=None, extra=""):
        q, k, _ = args
        calls.append((q.shape[1], k.shape[1], extra == "causal=True"))
        return candidates["xla"]
    monkeypatch.setattr(jautotune, "choose", choose)
    out = fn()
    return calls, out


ROUTES = {  # name: (model, Ts, Tt, src mask, tgt mask, train dropout)
    "wmt-step": ("seq2seq", 12, 9, True, False, 0.0),
    "masked-ts=tt": ("seq2seq", 9, 9, True, False, 0.0),
    "unmasked": ("seq2seq", 12, 9, False, False, 0.0),
    "unmasked-ts=tt": ("seq2seq", 9, 9, False, False, 0.0),
    "tgt-masked": ("seq2seq", 9, 9, False, True, 0.0),
    "dropout": ("seq2seq", 9, 9, False, False, 0.1),
    "classifier-masked": ("classifier", 9, 0, True, False, 0.0),
    "classifier": ("classifier", 9, 0, False, False, 0.0),
}


@pytest.mark.parametrize("case", list(ROUTES.values()), ids=list(ROUTES))
def test_flash_routing_follows_ccv_tpu(case, monkeypatch):
    """The attentions that take the kernels are ccv_tpu's: the decoder's
    causal self-attention, and unmasked Tq == Tk attention elsewhere (the
    encoder's, and the cross-attention at Ts == Tt); never a masked one,
    nor any under attention dropout in training. The port's outputs on
    that route (the kernels' plain versions here) equal ccv_tpu's."""
    model, ts, tt, use_src_mask, use_tgt_mask, dropout = case
    train = dropout > 0.0
    jcfg, tcfg = _cfgs("float32", dropout=dropout)
    src, smask = _tokens(7, ts, 50, SPAD)
    if model == "seq2seq":
        jparams, tparams = _seq2seq_params(jcfg)
        tgt, tmask = _tokens(8, tt, 40, TPAD)
        masks = (smask if use_src_mask else None,
                 tmask if use_tgt_mask else None)
        jfn = lambda: jtf.encoder_decoder_forward(  # noqa: E731
            jparams, jcfg, jnp.asarray(src), jnp.asarray(tgt),
            *(None if m is None else jnp.asarray(m) for m in masks),
            train=train, key=jax.random.PRNGKey(3) if train else None)
        tfn = lambda: ttf.encoder_decoder_forward(  # noqa: E731
            tparams, tcfg, torch.from_numpy(src), torch.from_numpy(tgt),
            *(None if m is None else torch.from_numpy(m) for m in masks),
            train=train, key=torch.Generator().manual_seed(3) if train
            else None)
    else:
        jparams, tparams = _classifier_params(jcfg)
        mask = smask if use_src_mask else None
        jfn = lambda: jtf.encoder_classifier_forward(  # noqa: E731
            jparams, jcfg, jnp.asarray(src),
            None if mask is None else jnp.asarray(mask))
        tfn = lambda: ttf.encoder_classifier_forward(  # noqa: E731
            tparams, tcfg, torch.from_numpy(src),
            None if mask is None else torch.from_numpy(mask))
    port_calls, got = _route_port(monkeypatch, tfn)
    jax_calls, want = _route_jax(monkeypatch, jfn)
    assert port_calls == jax_calls
    L = SMALL["layers"]
    expected = {
        "wmt-step": [(9, 9, True)] * L,
        "masked-ts=tt": [(9, 9, True)] * L,
        "unmasked": [(12, 12, False)] * L + [(9, 9, True)] * L,
        "unmasked-ts=tt": [(9, 9, False)] * L
        + [(9, 9, True), (9, 9, False)] * L,
        "tgt-masked": [(9, 9, False)] * L + [(9, 9, False)] * L,
        "dropout": [],
        "classifier-masked": [],
        "classifier": [(9, 9, False)] * L,
    }[next(k for k, v in ROUTES.items() if v == case)]
    assert port_calls == expected
    if not train:
        _check(got, want, "float32")


# -- flash attention at head dims the kernels are not built for ------------

@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("d", [8, 16, 48])
def test_padded_flash_attention_equals_plain_sdpa(d, causal, monkeypatch):
    """flash_attention zero-pads D to the next built head dim (32 or 64),
    runs the same wrappers (here their plain versions) at that D, and
    drops the padded columns of o, dq, dk and dv."""
    rng = np.random.default_rng(d)
    b, t, h = 2, 37, 3
    q, k, v, g = (torch.from_numpy(rng.standard_normal((b, t, h, d),
                                                       np.float32))
                  for _ in range(4))
    seen = []
    for name in ("flash_fwd", "flash_dq", "flash_dkv"):
        real = getattr(tfa, name)

        def spy(q_, *args, _real=real, _name=name):
            seen.append((_name, q_.shape[-1]))
            return _real(q_, *args)
        monkeypatch.setattr(tfa, name, spy)
    scale = 1.0 / np.sqrt(d)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    got = tfa.flash_attention(*leaves, scale=scale, is_causal=causal)
    got.backward(g)
    ref = [x.clone().requires_grad_(True) for x in (q, k, v)]
    want = ttf._sdpa_plain(*ref, scale, causal, None, 0.0, None, False)
    want.backward(g)
    pad = tfa.padded_dim(d)
    assert pad == (32 if d <= 32 else 64)
    assert seen == [("flash_fwd", pad), ("flash_dq", pad), ("flash_dkv", pad)]
    assert got.shape == (b, t, h, d)
    tol = dict(atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(got, want, **tol)
    for a, r in zip(leaves, ref):
        assert a.grad.shape == (b, t, h, d)
        torch.testing.assert_close(a.grad, r.grad, **tol)


def test_head_dims_past_the_kernels_raise():
    """flash_attention takes every head dim >= 1 and raises below (as
    ccv_tpu pads any D to a multiple of 128 lanes): 65-128 pad to 128,
    129-256 to 256, above to a multiple of 64; the (BH, T, D) wrappers
    take only the dims it pads to."""
    with pytest.raises(ValueError, match="head dim 0"):
        tfa.flash_attention(*(torch.zeros(1, 16, 2, 0),) * 3)
    with pytest.raises(ValueError, match="head dim 0"):
        tfa.padded_dim(0)
    for d in (16, 48, 96, 129):
        with pytest.raises(ValueError, match="head dim"):
            tfa.flash_fwd(*(torch.zeros(2, 16, d),) * 3, 0.1, False)
    assert tfa.flash_attention(*(torch.zeros(1, 16, 2, 129),) * 3).shape == (
        1, 16, 2, 129)
    assert [tfa.padded_dim(d) for d in (1, 32, 33, 64, 65, 96, 128, 129,
                                        256, 257, 320, 321)] == [
        32, 32, 64, 64, 128, 128, 128, 256, 256, 320, 320, 384]
