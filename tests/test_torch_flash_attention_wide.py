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

# the package re-exports the function under the module's name
jfa = importlib.import_module("ccv_tpu.ops.pallas.flash_attention")

F32_TOL = dict(atol=1e-4, rtol=1e-4)
HALF_REL = 2e-2
WIDE_DIMS = (160, 192, 256, 320, 512)


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
    """D 160-512 (zero-padded to 256, 320, 512 inside): o, dq, dk and dv
    against ccv_tpu's Pallas kernels, T 72 (a ragged tile)."""
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
    kernels; float32, 16-bit D 32 and 16-bit D above 256 the wmma-smem
    ones, which walk D in 64-column chunks (``_wide``) in float32 above
    128 and in every type above 256."""
    for kernel in ("fwd", "dq", "dkv"):
        for dtype in (torch.bfloat16, torch.float16):
            for d in (64, 128, 256):
                assert tfa._design(kernel, dtype, d) == "wgmma-tma"
            for d in (32, 320, 512, 1024):
                assert tfa._design(kernel, dtype, d) == "wmma-smem"
        for d in (32, 64, 128, 256, 320, 512):
            assert tfa._design(kernel, torch.float32, d) == "wmma-smem"
    wide = {(dtype, d) for dtype in (torch.float32, torch.bfloat16,
                                     torch.float16)
            for d in (32, 64, 128, 256, 320, 512) if tfa._wide(dtype, d)}
    assert wide == {(torch.float32, 256), (torch.float32, 320),
                    (torch.float32, 512), (torch.bfloat16, 320),
                    (torch.bfloat16, 512), (torch.float16, 320),
                    (torch.float16, 512)}


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


def test_scratch_of_the_chunked_form():
    """The chunked wmma-smem form's float32 accumulators: (n, BH, T rounded
    up to 64, D); none for the forms that keep them on chip."""
    x = torch.zeros(3, 100, 320, dtype=torch.bfloat16)
    s = tfa._scratch(x, 2)
    assert s.shape == (2, 3, 128, 320) and s.dtype == torch.float32
    assert tfa._scratch(torch.zeros(3, 100, 256), 1).shape == (1, 3, 128, 256)
    for dtype, d in ((torch.bfloat16, 256), (torch.float16, 256),
                     (torch.float32, 128), (torch.bfloat16, 32)):
        assert tfa._scratch(torch.zeros(3, 100, d, dtype=dtype), 1) is None


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


# -- on the card -------------------------------------------------------------

GATES = {torch.float32: None, torch.bfloat16: 2e-2, torch.float16: 2e-2}
CARD_SHAPES = ((3, 100, 100, True), (2, 72, 136, False), (2, 257, 257, True))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [256, 512])
@pytest.mark.parametrize("dtype", list(GATES), ids=["f32", "bf16", "f16"])
def test_cuda_wide_kernels_match_plain(dtype, d):
    """K2a/b/c on the card against their plain versions at D 256 and 512,
    each of the design ``_design`` names: float32 within 1e-4 + 1e-4 of the
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
        design = tfa._design("fwd", dtype, d)
        for n, counts in tfa.DESIGN_LAUNCHES.items():
            assert counts[design] == before[n][design] + 1
        for a, b in zip(got, ref):
            err = float((a.float() - b.float()).abs().max())
            top = float(b.float().abs().max())
            if GATES[dtype] is None or b.dtype == torch.float32:
                assert err <= 1e-4 + 1e-4 * top, (bh, tq, tk, causal, err)
            else:
                assert err <= GATES[dtype] * top, (bh, tq, tk, causal, err)
