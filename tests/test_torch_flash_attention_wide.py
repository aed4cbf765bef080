"""Port parity: K2 (flash attention) at head dims above 128 and in float16.

``ccv_tpu``'s flash attention takes any head dim (it pads D to a multiple
of 128 lanes) and the input's own float type. On the CPU the port's
wrappers run their plain PyTorch versions on D zero-padded to
``padded_dim(D)``; these are held against ``ccv_tpu``'s Pallas kernels run
in interpret mode (``FLASH_BWD`` patched to "pallas", as
tests/test_torch_flash_attention.py does). Tolerances:

- float32: 1e-4 (absolute and relative). Both sides compute in float32 on
  the CPU; only the order of the sums differs, and zero columns add
  nothing.
- float16: 2e-2 of the largest magnitude of the reference. p (and ds) are
  rounded to float16 before their products on both sides, relative to a
  running max in the Pallas kernel and the row's final max in the plain
  version, so single values move by float16's resolution (2^-11 relative)
  and the outputs' own rounding.

The tests marked ``cuda`` hold the hand-written kernels against their plain
versions on the card and skip here.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccv_tpu.models import transformer as jtf
from ccv_tpu_torch.bin import k2_trial
from ccv_tpu_torch.models import transformer as ttf
from ccv_tpu_torch.ops.kernels import flash_attention as tfa
from ccv_tpu_torch.ops.kernels import roofline

# the package re-exports the function under the module's name
jfa = importlib.import_module("ccv_tpu.ops.pallas.flash_attention")

F32_TOL = dict(atol=1e-4, rtol=1e-4)
HALF_REL = 2e-2
WIDE_DIMS = (160, 192, 256, 320, 512, 576)


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One torch intra-op thread in each test: the suite runs in several
    worker processes, whose thread pools oversubscribe the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _rand(rng, *shape):
    return rng.standard_normal(shape, np.float32)


@pytest.fixture(scope="module")
def pallas():
    """ccv_tpu's flash attention, forward and gradients through its Pallas
    kernels in interpret mode, on (B, T, H, D) numpy inputs: returns
    ``run(q, k, v, g, causal, dtype)`` -> (o, (dq, dk, dv)) as float32
    numpy, where ``g`` weighs o in the loss."""
    saved = jfa.FLASH_BWD
    jfa.FLASH_BWD = "pallas"

    def run(q, k, v, g, causal, dtype=jnp.float32):
        args = [jnp.asarray(x, dtype) for x in (q, k, v)]

        def loss(q, k, v):
            o = jfa.flash_attention(q, k, v, None, causal)
            return jnp.sum(o.astype(jnp.float32) * g)

        grads = jax.grad(loss, argnums=(0, 1, 2))(*args)
        o = jfa.flash_attention(*args, None, causal)
        assert o.dtype == dtype
        return (np.asarray(o.astype(jnp.float32)),
                [np.asarray(x.astype(jnp.float32)) for x in grads])

    yield run
    jfa.FLASH_BWD = saved


def _port(q, k, v, g, causal, dtype=torch.float32):
    ts = [torch.from_numpy(x).to(dtype).requires_grad_(True)
          for x in (q, k, v)]
    o = tfa.flash_attention(*ts, None, causal)
    (o.float() * torch.from_numpy(g)).sum().backward()
    return o, [t.grad.float().numpy() for t in ts]


def test_head_dim_256_returns_ccv_tpus_forward(pallas):
    """The fault: at D 256 the port raised ("the kernels take up to 128")
    where ccv_tpu returns. B 1, T 128, H 2, causal."""
    rng = np.random.default_rng(256)
    q, k, v, g = (_rand(rng, 1, 128, 2, 256) for _ in range(4))
    want, _ = pallas(q, k, v, g, True)
    got = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              is_causal=True)
    assert got.shape == (1, 128, 2, 256) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("d", WIDE_DIMS)
def test_wide_forward_and_grads_match_pallas(d, causal, pallas):
    """D 160-576 (zero-padded to 256, 320, 512, 576 inside): o, dq, dk and
    dv against ccv_tpu's Pallas kernels, T 72 (a ragged tile)."""
    rng = np.random.default_rng(d + causal)
    q, k, v, g = (_rand(rng, 1, 72, 2, d) for _ in range(4))
    want_o, want = pallas(q, k, v, g, causal)
    o, got = _port(q, k, v, g, causal)
    assert o.shape == (1, 72, 2, d)
    np.testing.assert_allclose(o.detach().numpy(), want_o, **F32_TOL)
    for a, b in zip(got, want):
        assert a.shape == (1, 72, 2, d)
        np.testing.assert_allclose(a, b, **F32_TOL)


@pytest.mark.parametrize("d", [32, 100, 256, 320])
def test_float16_forward_matches_ccv_tpu(d, pallas):
    """Float16 in, float16 out, as ccv_tpu: the forward within 2e-2 of the
    largest magnitude; at D 256 the gradients too."""
    rng = np.random.default_rng(d)
    q, k, v, g = (_rand(rng, 1, 100, 2, d) for _ in range(4))
    q, k, v = (x.astype(np.float16).astype(np.float32) for x in (q, k, v))
    want_o, want = pallas(q, k, v, g, True, jnp.float16)
    o, got = _port(q, k, v, g, True, torch.float16)
    assert o.dtype == torch.float16
    err = np.abs(o.detach().float().numpy() - want_o).max()
    assert err <= HALF_REL * np.abs(want_o).max(), err
    if d == 256:
        for a, b in zip(got, want):
            assert np.abs(a - b).max() <= HALF_REL * np.abs(b).max()


def test_design_choice():
    """bf16 and float16 at head dim 64, 128 or 256 take the wgmma-tma
    kernels and at D 32 the wmma-smem ones; above D 256 all three take the
    tc-wide ones in 16-bit; in float32 K2a takes tc-f32 from D 32 (as D 64)
    to 256 and tc-wide above, K2b and K2c tc-f32 at every head dim. No
    kernel runs wmma-smem above D 32."""
    for kernel in ("fwd", "dq", "dkv"):
        for dtype in (torch.bfloat16, torch.float16):
            for d in (64, 128, 256):
                assert tfa._design(kernel, dtype, d) == "wgmma-tma"
            assert tfa._design(kernel, dtype, 32) == "wmma-smem"
            for d in (320, 512, 576, 1024):
                assert tfa._design(kernel, dtype, d) == "tc-wide"
        for d in (32, 64, 128, 192, 256):
            assert tfa._design(kernel, torch.float32, d) == "tc-f32"
        for d in (320, 384, 448, 512, 576, 640, 1024):
            assert tfa._design(kernel, torch.float32, d) == (
                "tc-wide" if kernel == "fwd" else "tc-f32")
    designs = {(kernel, dtype, d): tfa._design(kernel, dtype, d)
               for kernel in ("fwd", "dq", "dkv")
               for dtype in (torch.float32, torch.bfloat16, torch.float16)
               for d in (32, 64, 128, 256, 320, 512, 576, 896)}
    assert set(designs.values()) == set(tfa.DESIGNS)
    assert {key for key, design in designs.items()
            if design == "wmma-smem"} == {
        (kernel, dtype, 32) for kernel in ("fwd", "dq", "dkv")
        for dtype in (torch.bfloat16, torch.float16)}


def test_roofline_kind_and_tf32x3_bound_at_d256():
    """K2a, K2b and K2c in float32 at BH 32 x T 1024 x D 256, causal
    (chip_smoke's K2_D256), are bound by their operations at a third of
    TF32's 495 TFLOP/s: 17.2 GFLOP in 0.104 ms, 25.8 in 0.156 and 34.4 in
    0.208 (0.257, 0.385 and 0.513 ms at float32's 67 TFLOP/s outside the
    tensor cores); K2b at D 512 does twice D 256's work, 0.313 ms."""
    shape = (32, 1024, 1024, 256, True)
    pairs = 1024 * 1025 // 2
    for kernel, per_pair, kind, want_ms in (
            ("fwd", 4, "tf32x3", 0.104), ("dkv", 8, "tf32x3", 0.208),
            ("dq", 6, "tf32x3", 0.156)):
        assert tfa.roofline_kind(kernel, torch.float32, 256) == kind
        flop, nbytes = tfa.flash_work(kernel, *shape, torch.float32)
        assert flop == per_pair * pairs * 256 * 32
        ms, by = roofline.bound_ms(flop, nbytes, kind)
        assert by == "operations"
        assert ms == pytest.approx(want_ms, abs=5e-4)
        if kind == "tf32x3":
            assert ms == pytest.approx(3 * flop / 495e12 * 1e3)
            assert roofline.bound_ms(flop, nbytes, "f32")[0] == pytest.approx(
                flop / 67e12 * 1e3)
    assert tfa.flash_work("fwd", *shape, torch.float32)[0] == pytest.approx(
        17.2e9, rel=2e-3)
    for dtype, kind in ((torch.bfloat16, "bf16"), (torch.float16, "f16"),
                        (torch.float32, "tf32x3")):
        assert tfa.roofline_kind("fwd", dtype, 64) == kind
    for d in (64, 128, 512):
        for kernel in ("dq", "dkv"):
            assert tfa.roofline_kind(kernel, torch.float32, d) == "tf32x3"
    for kernel in ("fwd", "dq", "dkv"):  # D 32 runs on tc-f32 at D 64
        assert tfa.roofline_kind(kernel, torch.float32, 32) == "tf32x3"
        # K2a on tc-wide, K2b and K2c on tc-f32
        assert tfa.roofline_kind(kernel, torch.float32, 576) == "tf32x3"
    flop, nbytes = tfa.flash_work("dq", 32, 1024, 1024, 512, True,
                                  torch.float32)
    ms, by = roofline.bound_ms(flop, nbytes, "tf32x3")
    assert by == "operations" and ms == pytest.approx(0.313, abs=5e-4)


def test_tf32x3_bound_of_the_backward_at_d576():
    """K2b and K2c in float32 at D 576 run tc-f32 (K2b in two slices of dq,
    K2c in three of dk and dv) and read "tf32x3": at BH 32 x T 1024, causal,
    58.0 and 77.4 GFLOP, bound at 0.352 and 0.469 ms by their operations
    (0.866 and 1.155 at float32's 67 TFLOP/s outside the tensor cores)."""
    shape = (32, 1024, 1024, 576, True)
    for kernel, gflop, want_ms, f32_ms in (("dq", 58.0, 0.352, 0.866),
                                           ("dkv", 77.4, 0.469, 1.155)):
        assert tfa._design(kernel, torch.float32, 576) == "tc-f32"
        assert tfa.roofline_kind(kernel, torch.float32, 576) == "tf32x3"
        flop, nbytes = tfa.flash_work(kernel, *shape, torch.float32)
        assert flop / 1e9 == pytest.approx(gflop, abs=0.05)
        ms, by = roofline.bound_ms(flop, nbytes, "tf32x3")
        assert by == "operations" and ms == pytest.approx(want_ms, abs=5e-4)
        assert roofline.bound_ms(flop, nbytes, "f32")[0] == pytest.approx(
            f32_ms, abs=5e-4)


@pytest.mark.parametrize("bh,d", [(128, 64), (64, 128)])
def test_tf32x3_bound_at_d64_and_d128(bh, d):
    """K2a, K2b and K2c in float32 at T 1024, causal, at BH 128 x D 64 and
    BH 64 x D 128 (k2_trial's float32 shapes) do D 256's work at BH 32:
    17.2, 25.8 and 34.4 GFLOP, bound at 0.104, 0.156 and 0.208 ms on
    tf32x3."""
    shape = (bh, 1024, 1024, d, True)
    for kernel, want_ms in (("fwd", 0.104), ("dq", 0.156), ("dkv", 0.208)):
        flop, nbytes = tfa.flash_work(kernel, *shape, torch.float32)
        assert flop == tfa.flash_work(kernel, 32, 1024, 1024, 256, True,
                                      torch.float32)[0]
        ms, by = roofline.bound_ms(flop, nbytes,
                                   tfa.roofline_kind(kernel, torch.float32, d))
        assert by == "operations"
        assert ms == pytest.approx(want_ms, abs=5e-4)


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits), to nearest with ties away from
    zero, as cvt.rna.tf32.f32."""
    bits = x.view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_cut(x):
    """x as the tensor cores read a float32 register as TF32: the low 13
    bits dropped."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm3(a, b):
    """a @ b as the tc-f32 kernels form it: each operand split into hi (TF32)
    and lo = x - hi (read as TF32), then lo_a hi_b + hi_a lo_b + hi_a hi_b
    in float32. Each TF32 x TF32 product is exact in float32."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32_cut(a - ah), _tf32_cut(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _mm1(a, b):
    """a @ b in plain TF32 (one product, each operand rounded)."""
    return _tf32(a) @ _tf32(b)


def _emulated(q, k, v, do, scale, causal, mm):
    """K2a's (o, lse), K2b's dq and K2c's (dk, dv) with every product
    formed by ``mm``, on (BH, T, D) float32 tensors."""
    s = mm(q, k.transpose(1, 2)) * scale
    valid = tfa._valid(q.shape[1], k.shape[1], causal, q.device)
    if valid is not None:
        s = torch.where(valid, s, tfa.NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = mm(p, v) / l
    lse = (m + torch.log(l)).squeeze(-1)
    delta = (do * o).sum(-1)
    pb = torch.exp(s - lse[..., None])
    if valid is not None:
        pb = torch.where(valid, pb, 0.0)
    ds = pb * (mm(do, v.transpose(1, 2)) - delta[..., None]) * scale
    dq = mm(ds, k)
    dk = mm(ds.transpose(1, 2), q)
    dv = mm(pb.transpose(1, 2), do)
    return o, lse, dq, dk, dv


@pytest.mark.parametrize("d", [64, 128, 256, 512])
def test_3xtf32_split_holds_the_float32_gate(d):
    """The tc-f32 kernels' arithmetic, emulated on the CPU: K2a, K2b and
    K2c at D 64, 128, 256 and 512, T 256, causal, with every product in
    three TF32 parts, land within chip_smoke.py's K2_F32 gate (1e-4 + 1e-4
    x the largest magnitude) of the plain float32 versions; one TF32
    product instead lands at least 10 times further off."""
    rng = np.random.default_rng(d)
    q, k, v, do = (torch.from_numpy(_rand(rng, 2, 256, d)) for _ in range(4))
    scale = 1.0 / np.sqrt(d)
    o0, lse0 = tfa.flash_fwd_ref(q, k, v, scale, True)
    delta = (do * o0).sum(-1)
    dq0 = tfa.flash_dq_ref(q, k, v, do, lse0, delta, scale, True)
    dk0, dv0 = tfa.flash_dkv_ref(q, k, v, do, lse0, delta, scale, True)
    errs = {}
    for name, mm in (("3xtf32", _mm3), ("tf32", _mm1)):
        got = _emulated(q, k, v, do, scale, True, mm)
        errs[name] = [float((a - b).abs().max() / (1e-4 + 1e-4 * b.abs().max()))
                      for a, b in zip(got, (o0, lse0, dq0, dk0, dv0))]
    assert max(errs["3xtf32"]) <= 1.0, errs
    assert max(errs["tf32"]) >= 10 * max(errs["3xtf32"]), errs
    assert errs["tf32"][2] >= 10 * errs["3xtf32"][2], errs  # dq


def test_padded_dim_at_every_d():
    """Every D from 1 to 1100 pads to the smallest of HEAD_DIMS that holds
    it, and above 256 to the next multiple of 64: never wider than
    ccv_tpu's multiple of 128, and a dim the (BH, T, D) wrappers take."""
    for d in range(1, 1101):
        pad = tfa.padded_dim(d)
        built = [h for h in tfa.HEAD_DIMS if h >= d]
        assert pad == (built[0] if built else -(-d // 64) * 64), d
        assert d <= pad <= -(-d // 128) * 128 or pad in tfa.HEAD_DIMS
        assert tfa.padded_dim(pad) == pad
    for d in (0, -1):
        with pytest.raises(ValueError, match="head dim"):
            tfa.padded_dim(d)
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_attention(*(torch.zeros(1, 16, 2, 0),) * 3)


# (dtype, D, padded_dim(D, dtype), K2a's design, K2b's and K2c's) at the
# dim the (BH, T, D) wrappers are given, padded_dim(D)
TYPED_DIMS = ((torch.bfloat16, 320, 320, "tc-wide", "tc-wide"),
              (torch.bfloat16, 512, 512, "tc-wide", "tc-wide"),
              (torch.float16, 320, 320, "tc-wide", "tc-wide"),
              (torch.float16, 512, 512, "tc-wide", "tc-wide"),
              (torch.float32, 576, 576, "tc-wide", "tc-f32"),
              (torch.float32, 512, 512, "tc-wide", "tc-f32"),
              (torch.float32, 16, 64, "tc-f32", "tc-f32"),
              (torch.float32, 32, 64, "tc-f32", "tc-f32"),
              (torch.bfloat16, 32, 32, "wmma-smem", "wmma-smem"))


@pytest.mark.parametrize("dtype,d,pad,fwd,bwd", TYPED_DIMS,
                         ids=lambda x: str(x).replace("torch.", ""))
def test_padded_dim_and_design_by_type(dtype, d, pad, fwd, bwd):
    """``padded_dim(D, dtype)`` is the dim the card's kernels run: float32
    D 1-32 at 64 (tc-f32's smallest), every other dim as ``padded_dim(D)``;
    above D 256 K2a is tc-wide in every type, K2b and K2c tc-wide in 16-bit
    and tc-f32 in float32, as below."""
    assert tfa.padded_dim(d, dtype) == pad
    assert tfa.padded_dim(d) == (32 if d <= 32 else d)
    assert tfa._design("fwd", dtype, tfa.padded_dim(d)) == fwd
    for kernel in ("dq", "dkv"):
        assert tfa._design(kernel, dtype, tfa.padded_dim(d)) == bwd


@pytest.mark.parametrize("route", ["cpu", "card"])
@pytest.mark.parametrize("d", [16, 32])
def test_float32_small_head_dims_match_pallas(d, route, pallas):
    """Float32 D 16 and 32, forward and gradients, against ccv_tpu's Pallas
    kernels, T 72, causal: "cpu" through ``flash_attention`` as the CPU
    runs it (the plain versions at D 32); "card" by the card's route on
    the CPU: the D 64 plain versions on q, k, v and do zero-padded to
    ``padded_dim(D, torch.float32)``, D's scale, the padded columns cut."""
    rng = np.random.default_rng(d)
    q, k, v, g = (_rand(rng, 1, 72, 2, d) for _ in range(4))
    want_o, want = pallas(q, k, v, g, True)
    if route == "cpu":
        o, got = _port(q, k, v, g, True)
        o = o.detach().numpy()
    else:
        pad = tfa.padded_dim(d, torch.float32)
        assert pad == 64
        qp, kp, vp, gp = (tfa._to_bthd(torch.from_numpy(x), pad)
                          for x in (q, k, v, g))
        scale = 1.0 / np.sqrt(d)
        o0, lse = tfa.flash_fwd_ref(qp, kp, vp, scale, True)
        delta = (gp * o0).sum(-1)
        bwd = (qp, kp, vp, gp, lse, delta, scale, True)
        grads = (tfa.flash_dq_ref(*bwd), *tfa.flash_dkv_ref(*bwd))
        o = tfa._from_bthd(o0, 1, d).numpy()
        got = [tfa._from_bthd(x, 1, d).numpy() for x in grads]
    assert o.shape == (1, 72, 2, d)
    np.testing.assert_allclose(o, want_o, **F32_TOL)
    for a, b in zip(got, want):
        assert a.shape == (1, 72, 2, d)
        np.testing.assert_allclose(a, b, **F32_TOL)


def test_wrappers_take_the_padded_dims_only():
    """The (BH, T, D) wrappers refuse a head dim padded_dim does not
    return, and take the wide ones in every type."""
    for d in (192, 257, 300):
        with pytest.raises(ValueError, match="head dim"):
            tfa.flash_fwd(*(torch.zeros(2, 16, d),) * 3, 0.1, False)
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for d in (256, 320, 512):
            x = torch.zeros(2, 16, d, dtype=dtype)
            o, lse = tfa.flash_fwd(x, x, x, 0.1, True)
            assert o.dtype == dtype and o.shape == x.shape
            assert lse.shape == (2, 16)
    with pytest.raises(TypeError, match="float16"):
        tfa.flash_fwd(*(torch.zeros(2, 16, 64, dtype=torch.float64),) * 3,
                      0.1, False)


@pytest.mark.parametrize("d", [320, 512])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_half_gradients_above_256_match_pallas(dtype, d, pallas):
    """bf16 and float16 at D 320 and 512, the range of the tc-wide K2b and
    K2c on the card: o, dq, dk and dv against ccv_tpu's Pallas kernels, T
    100 (a ragged tile), causal, each within 2e-2 of its largest magnitude
    (p and ds rounded to the input type on both sides)."""
    rng = np.random.default_rng(d + len(dtype))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    q, k, v, g = (_rand(rng, 1, 100, 2, d) for _ in range(4))
    q, k, v = (np.array(jnp.asarray(x, jdt).astype(jnp.float32))
               for x in (q, k, v))
    want_o, want = pallas(q, k, v, g, True, jdt)
    o, got = _port(q, k, v, g, True, tdt)
    assert o.dtype == tdt
    for name, a, b in zip(("o", "dq", "dk", "dv"),
                          (o.detach().float().numpy(), *got),
                          (want_o, *want)):
        assert a.shape == (1, 100, 2, d)
        err = np.abs(a - b).max()
        assert err <= HALF_REL * np.abs(b).max(), (name, err)


@pytest.mark.parametrize("route", ["plain", "flash"])
def test_lm_forward_at_head_dim_256_matches_jax(route, monkeypatch):
    """ccv_tpu's LM at d 512 = 2 heads of 256, 1 layer, T 16, float32,
    through ``params_from_jax``; "flash" sends the port's attention through
    ``flash_attention`` on the CPU (its route on the card)."""
    args = dict(vocab_size=61, layers=1, heads=2, head_dim=256, ff=128,
                max_len=16, dropout=0.0)
    jcfg = jtf.TransformerConfig(dtype=jnp.float32, **args)
    tcfg = ttf.TransformerConfig(dtype=torch.float32, **args)
    jparams = jtf.init_lm(jax.random.PRNGKey(0), jcfg)
    tparams = ttf.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    ids = np.random.default_rng(1).integers(0, 61, (2, 16))
    want = np.asarray(jtf.lm_forward(jparams, jcfg, jnp.asarray(ids)))
    seen = []
    if route == "flash":
        monkeypatch.setattr(ttf, "_use_flash", lambda *a: True)
        real = tfa.flash_fwd

        def spy(q, *rest):
            seen.append(q.shape[-1])
            return real(q, *rest)
        monkeypatch.setattr(tfa, "flash_fwd", spy)
    got = ttf.lm_forward(tparams, tcfg, torch.from_numpy(ids)).detach()
    assert seen == ([256] if route == "flash" else [])
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


PTXAS = """\
ptxas info    : Compiling entry function '_ZN56_GLOBAL__N__4f224161_23_flash_attention_sm90_cu_2e7b489815dkv_sm90_kernelI6__halfLi256EEEv14CUtensorMap_stS2_S2_S2_PKfS4_PT_S6_iifi' for 'sm_90a'
ptxas info    : Function properties for _ZN56_GLOBAL__N__4f224161_23_flash_attention_sm90_cu_2e7b489815dkv_sm90_kernelI6__halfLi256EEEv14CUtensorMap_stS2_S2_S2_PKfS4_PT_S6_iifi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 245 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__604052e1_18_flash_attention_cu_2c1389799dq_kernelIfLi64EEEvPKT_S3_S3_S3_PKfS5_PS1_iifi' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__604052e1_18_flash_attention_cu_2c1389799dq_kernelIfLi64EEEvPKT_S3_S3_S3_PKfS5_PS1_iifi
    8 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 48 registers, used 1 barriers, 8 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__604052e1_18_flash_attention_cu_2c13897915fwd_wide_kernelI13__nv_bfloat16EEvPKT_S4_S4_PS2_PfS6_iiifi' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__604052e1_18_flash_attention_cu_2c13897915fwd_wide_kernelI13__nv_bfloat16EEvPKT_S4_S4_PS2_PfS6_iiifi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN56_GLOBAL__N__1c2d3e4f_23_flash_attention_sm90_cu_5a6b7c8d15fwd_sm90_kernelILi64EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16Pfiifi' for 'sm_90a'
    64 bytes stack frame, 68 bytes spill stores, 100 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers, 64 bytes cumulative stack size
"""


def test_k2_trial_reads_ptxas():
    """bin/k2_trial's reading of ``nvcc -Xptxas -v`` (the registers and
    spills of each K2 kernel; the card's own output, cut to four kernels,
    the last one of an older checkout, templated on the head dim alone):
    the kernel's name by its length prefix, the type and head dim from its
    template arguments."""
    assert k2_trial.parse_ptxas(PTXAS) == [
        dict(kernel="dkv_sm90_kernel", type="float16", head_dim=256,
             registers=245, spill_stores=0, spill_loads=0),
        dict(kernel="dq_kernel", type="float32", head_dim=64, registers=48,
             spill_stores=8, spill_loads=12),
        dict(kernel="fwd_wide_kernel", type="bfloat16", head_dim=None,
             registers=64, spill_stores=0, spill_loads=0),
        dict(kernel="fwd_sm90_kernel", type=None, head_dim=64, registers=96,
             spill_stores=68, spill_loads=100)]


def test_k2_trial_reads_untemplated_kernels():
    """An untemplated kernel (an older checkout's tc-f32 K2c): its mangled
    name ends the name with E and carries no template arguments."""
    text = PTXAS.replace(
        "_ZN51_GLOBAL__N__604052e1_18_flash_attention_cu_2c1389799dq_kernelIf"
        "Li64EEEvPKT_S3_S3_S3_PKfS5_PS1_iifi",
        "_ZN56_GLOBAL__N__0a1b2c3d_23_flash_attention_tf32_cu_4e5f607113"
        "dkv_tc_kernelEPKfS1_S1_S1_S1_S1_PfS2_iiifi")
    got = k2_trial.parse_ptxas(text)
    assert got[1] == dict(kernel="dkv_tc_kernel", type=None, head_dim=None,
                          registers=48, spill_stores=8, spill_loads=12)
    assert [g["kernel"] for g in got] == [
        "dkv_sm90_kernel", "dkv_tc_kernel", "fwd_wide_kernel",
        "fwd_sm90_kernel"]


@pytest.mark.parametrize("arg,dtype", [("f", "float32"),
                                       ("13__nv_bfloat16", "bfloat16"),
                                       ("6__half", "float16")])
def test_k2_trial_reads_the_tc_wide_kernel(arg, dtype):
    """K2a's tc-wide kernel is a template on the element type and the
    columns of o a block keeps: ``--ptxas`` reads both."""
    text = PTXAS.replace(
        "_ZN51_GLOBAL__N__604052e1_18_flash_attention_cu_2c1389799dq_kernelIf"
        "Li64EEEvPKT_S3_S3_S3_PKfS5_PS1_iifi",
        "_ZN56_GLOBAL__N__0a1b2c3d_23_flash_attention_tf32_cu_4e5f607118"
        f"fwd_wide_tc_kernelI{arg}Li512EEEvPKT_S3_S3_PS1_Pfiiiifiii")
    assert k2_trial.parse_ptxas(text)[1] == dict(
        kernel="fwd_wide_tc_kernel", type=dtype, head_dim=512, registers=48,
        spill_stores=8, spill_loads=12)


@pytest.mark.parametrize("arg,dtype", [("f", "float32"),
                                       ("13__nv_bfloat16", "bfloat16"),
                                       ("6__half", "float16")])
def test_k2_trial_reads_the_templated_backward(arg, dtype):
    """K2b's ``dq_tc_kernel`` is a template on the element type and the
    columns of dq a block keeps, K2c's ``dkv_tc_kernel`` on the element type
    alone: ``--ptxas`` reads the type of both and K2b's columns."""
    text = PTXAS.replace(
        "_ZN51_GLOBAL__N__604052e1_18_flash_attention_cu_2c1389799dq_kernelIf"
        "Li64EEEvPKT_S3_S3_S3_PKfS5_PS1_iifi",
        "_ZN56_GLOBAL__N__0a1b2c3d_23_flash_attention_tf32_cu_4e5f607112"
        f"dq_tc_kernelI{arg}Li512EEEvPKT_S3_S3_S3_PKfS5_PS1_iiiifiii").replace(
        "_ZN51_GLOBAL__N__604052e1_18_flash_attention_cu_2c13897915fwd_wide_"
        "kernelI13__nv_bfloat16EEvPKT_S4_S4_PS2_PfS6_iiifi",
        "_ZN56_GLOBAL__N__0a1b2c3d_23_flash_attention_tf32_cu_4e5f607113"
        f"dkv_tc_kernelI{arg}EEvPKT_S3_S3_S3_PKfS5_PS1_S6_iiiifiii")
    got = k2_trial.parse_ptxas(text)
    assert got[1] == dict(kernel="dq_tc_kernel", type=dtype, head_dim=512,
                          registers=48, spill_stores=8, spill_loads=12)
    assert got[2] == dict(kernel="dkv_tc_kernel", type=dtype, head_dim=None,
                          registers=64, spill_stores=0, spill_loads=0)


# -- on the card -------------------------------------------------------------

GATES = {torch.float32: None, torch.bfloat16: 2e-2, torch.float16: 2e-2}
CARD_SHAPES = ((3, 100, 100, True), (2, 72, 136, False), (2, 257, 257, True))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [256, 320, 512, 640, 896])
@pytest.mark.parametrize("dtype", list(GATES), ids=["f32", "bf16", "f16"])
def test_cuda_wide_kernels_match_plain(dtype, d):
    """K2a/b/c on the card against their plain versions at D 256-896, each
    of the design ``_design`` names (above 256: K2b in two slices of dq at
    D 640 and 896, K2c in three and four of dk and dv; in 16-bit K2b's q
    and do and K2c's k and v resident to D 512 and streamed at 640 and
    896), at ragged and cross-length T: float32 within 1e-4 + 1e-4 of the
    largest magnitude, 16-bit within 2e-2 of it (chip_smoke.py phase 43
    runs the same at the LM's shape)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(d)
    for bh, tq, tk, causal in CARD_SHAPES:
        q, k, v, do = (torch.from_numpy(_rand(rng, bh, t, d)).to(dev, dtype)
                       for t in (tq, tk, tk, tq))
        scale = 1.0 / np.sqrt(d)
        o0, lse0 = tfa.flash_fwd_ref(q, k, v, scale, causal)
        delta = (do.float() * o0.float()).sum(-1)
        ref = (o0, lse0,
               *tfa.flash_bwd_ref(q, k, v, do, lse0, delta, scale, causal))
        before = {n: dict(c) for n, c in tfa.DESIGN_LAUNCHES.items()}
        got = (*tfa.flash_fwd(q, k, v, scale, causal),
               tfa.flash_dq(q, k, v, do, lse0, delta, scale, causal),
               *tfa.flash_dkv(q, k, v, do, lse0, delta, scale, causal))
        torch.cuda.synchronize()
        for n, counts in tfa.DESIGN_LAUNCHES.items():
            design = tfa._design(n, dtype, d)
            assert counts[design] == before[n][design] + 1
        for a, b in zip(got, ref):
            err = float((a.float() - b.float()).abs().max())
            top = float(b.float().abs().max())
            if GATES[dtype] is None or b.dtype == torch.float32:
                assert err <= 1e-4 + 1e-4 * top, (bh, tq, tk, causal, err)
            else:
                assert err <= GATES[dtype] * top, (bh, tq, tk, causal, err)


# chip_smoke.py's K2_WIDE_SHAPES in float32, D 320 and 384 (K2b's dq in
# five and six chunks, two k stages; K2c's two output slices; K2a on
# tc-wide, q resident), a float32 D above 512 (K2b in two slices of dq, K2c
# in three of dk and dv, K2a tc-wide in two slices of o), and D 64 and 128
# (two blocks a SM; K2b's q and do and K2c's k and v resident) at ragged
# T, causal and not
TC_F32_SHAPES = ((3, 100, 100, 256, True), (2, 72, 136, 256, False),
                 (2, 130, 130, 320, True), (2, 72, 136, 512, True),
                 (2, 100, 100, 384, True), (1, 130, 130, 512, False),
                 (1, 100, 100, 576, True), (3, 100, 100, 64, True),
                 (2, 72, 136, 64, False), (2, 257, 257, 64, True),
                 (3, 100, 100, 128, True), (2, 72, 136, 128, False),
                 (2, 257, 257, 128, True), (2, 72, 136, 128, True))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", TC_F32_SHAPES, ids=lambda s: f"D{s[3]}-"
                         f"{s[1]}x{s[2]}-{'causal' if s[4] else 'full'}")
def test_cuda_tc_f32_kernels_match_plain(shape):
    """K2a, K2b and K2c in float32 on the card against their plain
    versions: within 1e-4 + 1e-4 of the largest magnitude, each 64-row tile
    within 1e-2 of its norm (chip_smoke.py's K2_F32 and K2_TILE_REL), each
    launch of the design ``_design`` names (tc-f32 from D 64, K2a tc-wide
    above 256)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    bh, tq, tk, d, causal = shape
    rng = np.random.default_rng(d + tq)
    q, k, v, do = (torch.from_numpy(_rand(rng, bh, t, d)).cuda()
                   for t in (tq, tk, tk, tq))
    scale = 1.0 / np.sqrt(d)
    o0, lse0 = tfa.flash_fwd_ref(q, k, v, scale, causal)
    delta = (do * o0).sum(-1)
    dq0 = tfa.flash_dq_ref(q, k, v, do, lse0, delta, scale, causal)
    dk0, dv0 = tfa.flash_dkv_ref(q, k, v, do, lse0, delta, scale, causal)
    before = {n: dict(c) for n, c in tfa.DESIGN_LAUNCHES.items()}
    got = (*tfa.flash_fwd(q, k, v, scale, causal),
           tfa.flash_dq(q, k, v, do, lse0, delta, scale, causal),
           *tfa.flash_dkv(q, k, v, do, lse0, delta, scale, causal))
    torch.cuda.synchronize()
    for n in ("fwd", "dq", "dkv"):
        design = tfa._design(n, torch.float32, d)
        assert design == ("tc-wide" if n == "fwd" and d > 256 else "tc-f32")
        assert tfa.DESIGN_LAUNCHES[n][design] == before[n][design] + 1
    for name, a, b in zip(("o", "lse", "dq", "dk", "dv"), got,
                          (o0, lse0, dq0, dk0, dv0)):
        err = float((a - b).abs().max())
        top = float(b.abs().max())
        assert bool(torch.isfinite(a).all()) and err <= 1e-4 + 1e-4 * top, (
            name, err, top)
        if name != "lse":
            diff = torch.nn.functional.pad(a - b, (0, 0, 0, (-a.shape[1]) % 64))
            ref = torch.nn.functional.pad(b, (0, 0, 0, (-b.shape[1]) % 64))
            rel = (diff.reshape(bh, -1, 64 * d).norm(dim=-1)
                   / ref.reshape(bh, -1, 64 * d).norm(dim=-1).clamp_min(1e-30))
            assert float(rel.max()) <= 1e-2, (name, float(rel.max()))


# chip_smoke.py's K2_WIDE_SHAPES that K2a's tc-wide design serves: 16-bit
# above D 256 (a ragged and a cross-length tile, D 320 and 512, q resident,
# and phase 43's bf16 fit shape), float32 above 256 (D 320, q resident; D
# 512, q streamed; D 576 in two slices of o, 320 and 256 columns) and a
# 16-bit D past q's room (1024, streamed, two slices)
TC_WIDE_SHAPES = ((torch.bfloat16, (3, 100, 100, 320, True)),
                  (torch.bfloat16, (2, 72, 136, 320, False)),
                  (torch.bfloat16, (3, 100, 100, 512, True)),
                  (torch.float16, (2, 257, 257, 512, False)),
                  (torch.float32, (2, 130, 130, 320, True)),
                  (torch.float32, (2, 72, 136, 512, True)),
                  (torch.float32, (1, 100, 100, 576, True)),
                  (torch.float16, (1, 130, 130, 1024, True)),
                  (torch.bfloat16, (32, 1024, 1024, 320, True)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape", TC_WIDE_SHAPES,
                         ids=lambda x: str(x).replace("torch.", ""))
def test_cuda_tc_wide_fwd_matches_plain(dtype, shape):
    """K2a's tc-wide kernel on the card against ``flash_fwd_ref``, one
    launch of that design each, within chip_smoke.py phase 6's gates: o
    within 1e-4 + 1e-4 of the largest magnitude in float32 and 2e-2 of it
    in 16-bit, each 64-row tile within 1e-2 of its norm; lse (float32)
    within 1e-4 + 1e-4 of its largest."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    bh, tq, tk, d, causal = shape
    rng = np.random.default_rng(d + tq)
    q, k, v = (torch.from_numpy(_rand(rng, bh, t, d)).to("cuda", dtype)
               for t in (tq, tk, tk))
    scale = 1.0 / np.sqrt(d)
    o0, lse0 = tfa.flash_fwd_ref(q, k, v, scale, causal)
    assert tfa._design("fwd", dtype, d) == "tc-wide"
    before = tfa.DESIGN_LAUNCHES["fwd"]["tc-wide"]
    o, lse = tfa.flash_fwd(q, k, v, scale, causal)
    torch.cuda.synchronize()
    assert tfa.DESIGN_LAUNCHES["fwd"]["tc-wide"] == before + 1
    assert o.dtype == dtype and lse.dtype == torch.float32
    for name, a, b in (("o", o, o0), ("lse", lse, lse0)):
        err = float((a.float() - b.float()).abs().max())
        top = float(b.float().abs().max())
        bound = (1e-4 + 1e-4 * top if b.dtype == torch.float32
                 else HALF_REL * top)
        assert bool(torch.isfinite(a).all()) and err <= bound, (name, err)
    diff = torch.nn.functional.pad((o - o0).float(), (0, 0, 0, (-tq) % 64))
    ref = torch.nn.functional.pad(o0.float(), (0, 0, 0, (-tq) % 64))
    rel = (diff.reshape(bh, -1, 64 * d).norm(dim=-1)
           / ref.reshape(bh, -1, 64 * d).norm(dim=-1).clamp_min(1e-30))
    assert float(rel.max()) <= 1e-2, float(rel.max())
