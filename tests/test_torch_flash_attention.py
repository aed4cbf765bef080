"""Port parity: kernels K2a/K2b/K2c (flash attention) of ccv_tpu_torch.

On the CPU the port's wrappers run their plain PyTorch versions; these are
held against ccv_tpu's Pallas kernels run in interpret mode, as
tests/test_flash_attention.py runs them. Tolerances:

- float32: 1e-4 (absolute and relative). Both sides compute in float32 on
  the CPU; only the order of the sums differs.
- bfloat16: 2e-2 of the largest magnitude of the reference. p (and ds) are
  cast to bf16 before their products on both sides, but the online softmax
  of the kernel casts p relative to a running max, the plain version
  relative to the row's final max, so single values move by bf16's
  resolution (2^-8 relative).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccv_tpu.nn import ops as jops
from ccv_tpu_torch.nn import ops as tops
from ccv_tpu_torch.ops.kernels import flash_attention as tfa
from ccv_tpu_torch.ops.kernels import roofline

# the package re-exports the function under the module's name
jfa = importlib.import_module("ccv_tpu.ops.pallas.flash_attention")

F32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_REL = 2e-2


def _rand(rng, *shape):
    return rng.standard_normal(shape, np.float32)


def _bf16(x: np.ndarray) -> np.ndarray:
    """x rounded to bf16 and back, the same values on both sides."""
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


FWD_CASES = {  # (BH, Tq, Tk, D, causal): ccv_tpu's test shapes
    "128": (6, 128, 128, 64, False), "128c": (6, 128, 128, 64, True),
    "100c": (6, 100, 100, 64, True), "257": (6, 257, 257, 64, False),
    "72x136": (4, 72, 136, 32, False), "72x136c": (4, 72, 136, 32, True),
    "72x136d64": (4, 72, 136, 64, False), "72x136d64c": (4, 72, 136, 64, True),
    # head dim 128, which ccv_tpu's 128 lanes hold unpadded
    "100d128c": (2, 100, 100, 128, True), "72x136d128": (2, 72, 136, 128, False),
}


@pytest.mark.parametrize("case", list(FWD_CASES.values()), ids=list(FWD_CASES))
def test_plain_fwd_matches_pallas(case):
    bh, tq, tk, d, causal = case
    rng = np.random.default_rng(0)
    q, k, v = _rand(rng, bh, tq, d), _rand(rng, bh, tk, d), _rand(rng, bh, tk, d)
    scale = 1.0 / np.sqrt(d)
    o_j, lse_j = jfa._flash_fwd_bthd(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), scale, causal,
                                     with_lse=True)
    o, lse = tfa.flash_fwd_ref(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), scale, causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), **F32_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j)[:, :tq, 0],
                               **F32_TOL)


def test_plain_fwd_bf16_matches_pallas():
    bh, tq, tk, d, causal = FWD_CASES["100c"]
    rng = np.random.default_rng(1)
    q, k, v = (_rand(rng, bh, t, d) for t in (tq, tk, tk))
    scale = 1.0 / np.sqrt(d)
    o_j, lse_j = jfa._flash_fwd_bthd(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), scale, causal,
        with_lse=True)
    o, lse = tfa.flash_fwd_ref(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)), scale,
        causal)
    assert o.dtype == torch.bfloat16
    ref = np.asarray(o_j.astype(jnp.float32))
    assert np.abs(o.float().numpy() - ref).max() <= BF16_REL * np.abs(ref).max()
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j)[:, :tq, 0],
                               **F32_TOL)


def _port_grads(q, k, v, g, causal, dtype=torch.float32):
    ts = [torch.from_numpy(x).to(dtype).requires_grad_(True)
          for x in (q, k, v)]
    o = tfa.flash_attention(*ts, None, causal)
    (o.float() * torch.from_numpy(g)).sum().backward()
    return o, [t.grad.float().numpy() for t in ts]


BWD_CASES = {  # (Tq, Tk, causal), B 2, H 2, D 32: ccv_tpu's backward shapes
    "64c": (64, 64, True), "100c": (100, 100, True), "128": (128, 128, False),
    "72x136": (72, 136, False),
}


@pytest.mark.parametrize("case", list(BWD_CASES.values()), ids=list(BWD_CASES))
def test_grads_match_pallas_backward(case, monkeypatch):
    tq, tk, causal = case
    monkeypatch.setattr(jfa, "FLASH_BWD", "pallas")
    rng = np.random.default_rng(3)
    B, H, D = 2, 2, 32
    q, k, v = _rand(rng, B, tq, H, D), _rand(rng, B, tk, H, D), _rand(
        rng, B, tk, H, D)
    g = _rand(rng, B, tq, H, D)

    def loss(q, k, v):
        return jnp.sum(jfa.flash_attention(q, k, v, None, causal) * g)

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    _, got = _port_grads(q, k, v, g, causal)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), **F32_TOL)


@pytest.mark.parametrize("d", [96, 128])
def test_grads_head_dim_128_match_pallas_backward(d, monkeypatch):
    """Head dims 65-128 run at D 128 (96 zero-padded, as ccv_tpu pads to
    128 lanes); forward and gradients against the Pallas kernels."""
    monkeypatch.setattr(jfa, "FLASH_BWD", "pallas")
    rng = np.random.default_rng(d)
    B, H, T = 1, 2, 72
    q, k, v, g = (_rand(rng, B, T, H, d) for _ in range(4))
    assert tfa.padded_dim(d) == 128

    def loss(q, k, v):
        return jnp.sum(jfa.flash_attention(q, k, v, None, True) * g)

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    o, got = _port_grads(q, k, v, g, True)
    o_ref = jfa.flash_attention(*map(jnp.asarray, (q, k, v)), None, True)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(o_ref),
                               **F32_TOL)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), **F32_TOL)


def test_grads_cross_length_causal_match_sdpa():
    """(72, 136) causal: bottom-right mask, against the plain op's grads."""
    rng = np.random.default_rng(4)
    B, H, D = 2, 2, 32
    q, k, v = _rand(rng, B, 72, H, D), _rand(rng, B, 136, H, D), _rand(
        rng, B, 136, H, D)
    g = _rand(rng, B, 72, H, D)

    def loss(q, k, v):
        return jnp.sum(jops.scaled_dot_product_attention(
            q, k, v, is_causal=True) * g)

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    o, got = _port_grads(q, k, v, g, True)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), **F32_TOL)
    o_ref = jops.scaled_dot_product_attention(q, k, v, is_causal=True)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(o_ref),
                               **F32_TOL)


def test_grads_bf16_match_pallas_backward(monkeypatch):
    monkeypatch.setattr(jfa, "FLASH_BWD", "pallas")
    rng = np.random.default_rng(5)
    B, H, D, T = 2, 2, 64, 100
    q, k, v, g = (_bf16(_rand(rng, B, T, H, D)) for _ in range(4))

    def loss(q, k, v):
        o = jfa.flash_attention(q, k, v, None, True)
        return jnp.sum(o.astype(jnp.float32) * g)

    want = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    _, got = _port_grads(q, k, v, g, True, torch.bfloat16)
    for a, b in zip(got, want):
        b = np.asarray(b.astype(jnp.float32))
        assert np.abs(a - b).max() <= BF16_REL * np.abs(b).max()


def test_port_sdpa_matches_jax():
    rng = np.random.default_rng(6)
    q, k, v = _rand(rng, 2, 72, 3, 32), _rand(rng, 2, 136, 3, 32), _rand(
        rng, 2, 136, 3, 32)
    mask = rng.random((2, 1, 72, 136)) < 0.8
    mask[..., 0] = True
    bias = _rand(rng, 1, 3, 72, 136)
    for causal in (False, True):
        want = jops.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                 mask=mask, bias=bias)
        got = tops.scaled_dot_product_attention(
            *map(torch.from_numpy, (q, k, v)), is_causal=causal,
            mask=torch.from_numpy(mask), bias=torch.from_numpy(bias))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_wrapper_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(7)
    q, k, v, do = (torch.from_numpy(_rand(rng, 4, 72, 32)) for _ in range(4))
    before = dict(tfa.LAUNCHES)
    by_design = {n: dict(c) for n, c in tfa.DESIGN_LAUNCHES.items()}
    o, lse = tfa.flash_fwd(q, k, v, 0.3, True)
    o0, lse0 = tfa.flash_fwd_ref(q, k, v, 0.3, True)
    delta = (do * o).sum(-1)
    dq = tfa.flash_dq(q, k, v, do, lse, delta, 0.3, True)
    dk, dv = tfa.flash_dkv(q, k, v, do, lse, delta, 0.3, True)
    # the (B, T, H, D) entry point: B 2 x H 2 of the same rows
    qh, kh, vh = (x.view(2, 2, 72, 32).transpose(1, 2) for x in (q, k, v))
    oh = tfa.flash_attention(qh, kh, vh, 0.3, True)
    assert tfa.LAUNCHES == before  # no kernel launched for a CPU tensor
    assert tfa.DESIGN_LAUNCHES == by_design
    assert torch.equal(o, o0) and torch.equal(lse, lse0)
    assert torch.equal(oh.transpose(1, 2).reshape(4, 72, 32), o0)
    for a, b in zip((dq, dk, dv),
                    tfa.flash_bwd_ref(q, k, v, do, lse, delta, 0.3, True)):
        assert torch.equal(a, b)


def test_wrapper_rejects_bad_input():
    q = torch.zeros(2, 16, 64)
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_fwd(*(torch.zeros(2, 16, 48),) * 3, 0.1, False)
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_attention(*(torch.zeros(1, 16, 2, 0),) * 3)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_fwd(torch.zeros(2, 64, 16).transpose(1, 2), q, q, 0.1,
                      False)
    with pytest.raises(TypeError):
        tfa.flash_fwd(q.double(), q.double(), q.double(), 0.1, False)
    with pytest.raises(TypeError):
        tfa.flash_fwd(q, q.bfloat16(), q, 0.1, False)
    with pytest.raises(ValueError, match="no key"):
        tfa.flash_fwd(torch.zeros(2, 32, 64), q, q, 0.1, True)
    with pytest.raises(ValueError):
        tfa.flash_dq(q, q, q, q, torch.zeros(2, 15), torch.zeros(2, 16),
                     0.1, False)


def test_design_choice():
    """bf16 at head dim 64 (the LM's) or 128 takes the wgmma-tma K2a, K2b
    and K2c; float32 at 64 and 128 the tc-f32 ones, and at D 32 too (the
    D 64 kernels on zero-padded operands); bf16 D 32 the wgmma-tma kernels
    too, at D 32."""
    for kernel in ("fwd", "dq", "dkv"):
        for d in (64, 128):
            assert tfa._design(kernel, torch.bfloat16, d) == "wgmma-tma"
            assert tfa._design(kernel, torch.float32, d) == "tc-f32"
        assert "wgmma-tma" in tfa.DESIGN_LAUNCHES[kernel]
    for kernel in ("fwd", "dq", "dkv"):
        for dtype, d in ((torch.float32, 64), (torch.float32, 32),
                         (torch.float32, 128), (torch.bfloat16, 32)):
            assert tfa._design(kernel, dtype, d) in tfa.DESIGN_LAUNCHES[kernel]
        assert tfa._design(kernel, torch.bfloat16, 32) == "wgmma-tma"
        assert tfa._design(kernel, torch.float32, 32) == "tc-f32"


def test_reset_launches():
    tfa.LAUNCHES["fwd"] += 1
    tfa.DESIGN_LAUNCHES["dkv"]["wgmma-tma"] += 2
    tfa.reset_launches()
    assert set(tfa.LAUNCHES.values()) == {0}
    assert all(set(c.values()) == {0} for c in tfa.DESIGN_LAUNCHES.values())


PAIR_CASES = {"64c": (64, 64, True), "100c": (100, 100, True),
              "72x136c": (72, 136, True), "72x136": (72, 136, False),
              "1x5c": (1, 5, True), "257c": (257, 257, True)}


@pytest.mark.parametrize("case", list(PAIR_CASES.values()),
                         ids=list(PAIR_CASES))
def test_causal_pairs_match_the_mask(case):
    tq, tk, causal = case
    mask = tfa._valid(tq, tk, causal, torch.device("cpu"))
    want = tq * tk if mask is None else int(mask.sum())
    assert tfa.causal_pairs(tq, tk, causal) == want


def test_flash_work_and_bound_at_the_lm_shape():
    """The LM's shape, BH 128, T 1024, D 64, bf16, causal: 4, 6 and 8
    operations per pair and head-dim element; each tensor read or written
    once. The forward is bound by its bytes, the backward by operations."""
    bh, t, d = 128, 1024, 64
    pairs, tensor, rows = t * (t + 1) // 2, bh * t * d * 2, bh * t * 4
    want = {"fwd": (4, 4 * tensor + rows, "bytes"),
            "dq": (6, 5 * tensor + 2 * rows, "operations"),
            "dkv": (8, 6 * tensor + 2 * rows, "operations")}
    for kernel, (per_pair, nbytes, by) in want.items():
        got = tfa.flash_work(kernel, bh, t, t, d, True, torch.bfloat16)
        assert got == (per_pair * bh * pairs * d, nbytes)
        ms, bound_by = roofline.bound_ms(*got, "bf16")
        assert bound_by == by
        assert ms == pytest.approx(max(got[0] / 989e12, nbytes / 3.35e12)
                                   * 1e3)
    flop, nbytes = tfa.flash_work("fwd", 4, 72, 136, 32, False,
                                  torch.float32)
    assert (flop, nbytes) == (4 * 4 * 72 * 136 * 32,
                              4 * (2 * 72 + 2 * 136) * 32 * 4 + 4 * 72 * 4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_kernels_match_plain(dtype):
    """The hand-written kernels against their plain versions on the card
    (chip_smoke.py runs the same comparison at the LM's shape)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(8)
    for bh, tq, tk, d, causal in FWD_CASES.values():
        q, k, v, do = (torch.from_numpy(_rand(rng, bh, t, d)).to(dev, dtype)
                       for t in (tq, tk, tk, tq))
        o0, lse0 = tfa.flash_fwd_ref(q, k, v, 0.125, causal)
        delta = (do.float() * o0.float()).sum(-1)
        ref = (o0, lse0,
               *tfa.flash_bwd_ref(q, k, v, do, lse0, delta, 0.125, causal))
        before = dict(tfa.LAUNCHES)
        by_design = {n: dict(c) for n, c in tfa.DESIGN_LAUNCHES.items()}
        got = (*tfa.flash_fwd(q, k, v, 0.125, causal),
               tfa.flash_dq(q, k, v, do, lse0, delta, 0.125, causal),
               *tfa.flash_dkv(q, k, v, do, lse0, delta, 0.125, causal))
        torch.cuda.synchronize()
        assert {n: tfa.LAUNCHES[n] - before[n] for n in before} == {
            "fwd": 1, "dq": 1, "dkv": 1}
        ran = {n: [x for x, c in counts.items() if c > by_design[n][x]]
               for n, counts in tfa.DESIGN_LAUNCHES.items()}
        assert ran == {n: [tfa._design(n, dtype, d)] for n in ran}
        for a, b in zip(got, ref):
            err = float((a.float() - b.float()).abs().max())
            if dtype == torch.float32 or b.dtype == torch.float32:
                assert err <= 1e-4 + 1e-4 * float(b.abs().max()), err
            else:
                assert err <= BF16_REL * float(b.float().abs().max()), err


@pytest.mark.cuda
def test_cuda_wgmma_dq_matches_plain():
    """K2b's wgmma-tma kernel against flash_dq_ref at the parity tests' bf16
    D 64 shapes (ragged T, causal with Tq != Tk) and the LM's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(10)
    cases = [c for c in FWD_CASES.values() if c[3] == 64]
    for bh, tq, tk, d, causal in cases + [(128, 1024, 1024, 64, True)]:
        q, k, v, do = (torch.from_numpy(_rand(rng, bh, t, d))
                       .to(dev, torch.bfloat16) for t in (tq, tk, tk, tq))
        o0, lse0 = tfa.flash_fwd_ref(q, k, v, 0.125, causal)
        delta = (do.float() * o0.float()).sum(-1)
        ref = tfa.flash_dq_ref(q, k, v, do, lse0, delta, 0.125, causal)
        before = tfa.DESIGN_LAUNCHES["dq"]["wgmma-tma"]
        got = tfa.flash_dq(q, k, v, do, lse0, delta, 0.125, causal)
        torch.cuda.synchronize()
        assert tfa.DESIGN_LAUNCHES["dq"]["wgmma-tma"] == before + 1
        err = float((got.float() - ref.float()).abs().max())
        assert err <= BF16_REL * float(ref.float().abs().max()), (
            (bh, tq, tk, causal), err)


@pytest.mark.cuda
def test_cuda_wgmma_kernels_at_the_lm_shape():
    """K2a and K2c alone at the LM's shape (BH 128, T 1024, D 64, bf16,
    causal), one launch each of the wgmma-tma design, against their plain
    versions (chip_smoke.py times them there)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(9)
    q, k, v, do = (torch.from_numpy(_rand(rng, 128, 1024, 64))
                   .to(dev, torch.bfloat16) for _ in range(4))
    o0, lse0 = tfa.flash_fwd_ref(q, k, v, 0.125, True)
    delta = (do.float() * o0.float()).sum(-1)
    ref = (o0, lse0, *tfa.flash_dkv_ref(q, k, v, do, lse0, delta, 0.125,
                                       True))
    before = {n: dict(c) for n, c in tfa.DESIGN_LAUNCHES.items()}
    got = (*tfa.flash_fwd(q, k, v, 0.125, True),
           *tfa.flash_dkv(q, k, v, do, lse0, delta, 0.125, True))
    torch.cuda.synchronize()
    for n in ("fwd", "dkv"):
        assert tfa.DESIGN_LAUNCHES[n]["wgmma-tma"] == (
            before[n]["wgmma-tma"] + 1)
    for a, b in zip(got, ref):
        err = float((a.float() - b.float()).abs().max())
        assert err <= BF16_REL * float(b.float().abs().max()), err
