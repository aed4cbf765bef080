"""Kernels K2a/K2b/K2c: flash attention, forward and FlashAttention-2 backward.

Counterpart of ccv_tpu/ops/pallas/flash_attention.py. Pieces, in the
kernels' op order:

- ``flash_fwd_ref``, ``flash_dq_ref``, ``flash_dkv_ref``: the plain PyTorch
  versions of the three kernels on ``(BH, T, D)`` tensors;
- ``flash_fwd``, ``flash_dq``, ``flash_dkv``: the wrappers. On a CPU tensor
  each runs its plain version; on a CUDA tensor it launches its hand-written
  kernel or raises. ``LAUNCHES`` counts kernel launches per kernel,
  ``DESIGN_LAUNCHES`` per kernel and design. ``_design`` picks one of three
  designs:

  - "wgmma-tma" (csrc/flash_attention_sm90.cu: wgmma, TMA, register-resident
    softmax and accumulators): all three at bf16 and float16 and head dim
    32, 64, 128 or 256 (at D 32 64-byte swizzle, m64n32 products over D,
    exp2 in one SFU instruction and more blocks a SM than at D 64: there
    the exponentials, about 0.03 ms of the card's time at 256 heads x T
    1024 causal, outweigh the products);
  - "tc-f32" (csrc/flash_attention_tf32.cu: mma.sync TF32 in three parts,
    cp.async rings, accumulators in registers): all three in float32 from
    head dim 64 (``TC_F32_MIN``; D 32 runs as D 64 on zero-padded operands,
    which the wrappers pad and cut themselves), K2a up to 256, K2b and K2c
    at every multiple of 64 (slices of dq and of dk / dv above 512 and 256);
  - "tc-wide" (the same file, the same mma.sync structure with native
    16-bit products or TF32 in three parts): K2a above D 256 in every type,
    K2b and K2c above D 256 in bf16 and float16 (``WIDE_ABOVE``), their q
    and do or k and v resident in shared memory where they fit;
- ``flash_work``: the operations and bytes of one call, for its bound;
- ``FlashAttention`` / ``flash_attention``: the autograd function on
  ``(B, T, H, D)``, counterpart of ccv_tpu's ``flash_attention`` custom_vjp.
  It takes any head dim D >= 1, as ccv_tpu does: q, k and v are
  zero-padded along D to ``padded_dim(D)`` (the smallest of ``HEAD_DIMS``
  that holds D, or above the largest the next multiple of ``WIDE_STEP``),
  and the padded columns of o, dq, dk and dv are dropped before they are
  returned. Zero columns add nothing to q.k and the caller's scale is
  passed on unchanged, so this is exact, and it is the same kernel on
  padded operands (ccv_tpu pads D to a multiple of 128 lanes the same
  way). The ``(BH, T, D)`` entry points take only the dims ``padded_dim``
  returns; on the card, float32 runs D 1-32 at 64 (``padded_dim(D,
  torch.float32)``), so there ``FlashAttention`` pads once, to 64.

Types: float32, bfloat16 and float16, as ccv_tpu's kernels take the input's
own type; p and ds are rounded to it before their products.

The TPU layout is gone: D is padded only as far as the next built head
dim, and lse and delta are ``(BH, Tq)`` float32 rather than broadcast over
128 lanes. The causal mask is aligned bottom-right: key ``k`` counts for
query ``q`` when ``k <= q + (Tk - Tq)``. Causal attention with ``Tq > Tk`` (query rows with
no key) is refused.
"""

from __future__ import annotations

import ctypes
import math
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

import torch

from ccv_tpu_torch.ops.kernels import _build

NEG_INF = -1e30          # masked score, as in the Pallas kernel
HEAD_DIMS = (32, 64, 128, 256)  # head dims with kernels of their own
WIDE_STEP = 64  # above HEAD_DIMS[-1], D is a multiple of this (its chunks)
TC_F32_MIN = 64  # the smallest float32 head dim of "tc-f32"
# "tc-wide" runs K2a above this head dim in every type (float32 D 320-512
# too: one block over all of D there beat tc-f32's two a query tile), and
# K2b and K2c above it in 16-bit
WIDE_ABOVE = 256
DESIGNS = ("wgmma-tma", "tc-f32", "tc-wide")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# kernel launches made by the wrappers (CUDA tensors only), per kernel and
# per kernel and design
LAUNCHES = {"fwd": 0, "dq": 0, "dkv": 0}
DESIGN_LAUNCHES = {name: dict.fromkeys(DESIGNS, 0) for name in LAUNCHES}


def reset_launches() -> None:
    """Sets every launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0
        for design in DESIGN_LAUNCHES[name]:
            DESIGN_LAUNCHES[name][design] = 0


def _design(kernel: str, dtype: torch.dtype, d: int) -> str:
    """The kernel design that serves ``kernel`` ("fwd", "dq" or "dkv") for
    inputs of type ``dtype`` and head dim ``d`` (float32 D 32 runs as D
    64)."""
    if d > WIDE_ABOVE and (kernel == "fwd" or dtype != torch.float32):
        return "tc-wide"
    if dtype == torch.float32:
        return "tc-f32"
    return "wgmma-tma"  # 16-bit, every head dim up to WIDE_ABOVE


def roofline_kind(kernel: str, dtype: torch.dtype, d: int) -> str:
    """The ``roofline.bound_ms`` kind of ``kernel``'s operations: "tf32x3"
    in float32, which every design runs on the tensor cores in three TF32
    products ("tc-f32", "tc-wide"), else the type's."""
    return {torch.float32: "tf32x3", torch.bfloat16: "bf16",
            torch.float16: "f16"}[dtype]


def causal_pairs(t_q: int, t_k: int, causal: bool) -> int:
    """Number of (query, key) pairs that count: every pair, or with the
    bottom-right causal mask those with k <= q + (Tk - Tq)."""
    if not causal:
        return t_q * t_k
    diag = t_k - t_q
    return sum(min(t_k, max(0, q + diag + 1)) for q in range(t_q))


# operations per counted pair and head-dim element: 2 products of 2 each in
# the forward (q.k, p.v), 3 in dq (q.k, do.v, ds.k), 4 in dk/dv
_FLOP_PER_PAIR = {"fwd": 4, "dq": 6, "dkv": 8}


def flash_work(kernel: str, bh: int, t_q: int, t_k: int, d: int,
               causal: bool, dtype: torch.dtype) -> Tuple[int, int]:
    """(operations, bytes) of one call of ``kernel``: the products over the
    pairs that count, and each input read once and each output written
    once (q, k, v, o and lse for the forward; q, k, v, do, lse and delta
    in, dq or dk and dv out for the backward)."""
    esize = dtype.itemsize
    q_bytes, k_bytes, row_bytes = bh * t_q * d * esize, bh * t_k * d * esize, \
        bh * t_q * 4
    ops = _FLOP_PER_PAIR[kernel] * causal_pairs(t_q, t_k, causal) * d * bh
    if kernel == "fwd":
        nbytes = 2 * q_bytes + 2 * k_bytes + row_bytes
    elif kernel == "dq":
        nbytes = 3 * q_bytes + 2 * k_bytes + 2 * row_bytes
    else:
        nbytes = 2 * q_bytes + 4 * k_bytes + 2 * row_bytes
    return ops, nbytes


def _valid(t_q: int, t_k: int, causal: bool,
           device: torch.device) -> Optional[torch.Tensor]:
    """(Tq, Tk) bool mask of the keys each query sees, or None for all."""
    if not causal:
        return None
    return torch.ones(t_q, t_k, dtype=torch.bool, device=device).tril(
        t_k - t_q)


def _scores(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """f32 scores (BH, Tq, Tk): input-type products summed in f32."""
    return torch.matmul(q.float(), k.float().transpose(1, 2)) * scale


def _probs(q, k, lse, scale, causal) -> torch.Tensor:
    """The backward's recomputed p = exp(s - lse), 0 where masked."""
    p = torch.exp(_scores(q, k, scale) - lse[..., None])
    valid = _valid(q.shape[1], k.shape[1], causal, q.device)
    return p if valid is None else torch.where(valid, p, 0.0)


def flash_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float, causal: bool
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2a: (o (BH, Tq, D) in q's type, lse (BH, Tq) f32)."""
    _check_qkv(q, k, v, causal)
    s = _scores(q, k, scale)
    valid = _valid(q.shape[1], k.shape[1], causal, q.device)
    if valid is not None:
        s = torch.where(valid, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    return (acc / l).to(q.dtype), (m + torch.log(l)).squeeze(-1)


def flash_dq_ref(q, k, v, do, lse, delta, scale: float,
                 causal: bool) -> torch.Tensor:
    """Plain version of K2b: dq (BH, Tq, D) in q's type."""
    _check_bwd(q, k, v, do, lse, delta, causal)
    p = _probs(q, k, lse, scale, causal)
    dp = torch.matmul(do.float(), v.float().transpose(1, 2))
    ds = p * (dp - delta[..., None]) * scale
    return torch.matmul(ds.to(k.dtype).float(), k.float()).to(q.dtype)


def flash_dkv_ref(q, k, v, do, lse, delta, scale: float,
                  causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2c: (dk, dv), each (BH, Tk, D) in k's type."""
    _check_bwd(q, k, v, do, lse, delta, causal)
    p = _probs(q, k, lse, scale, causal)
    dv = torch.matmul(p.to(do.dtype).float().transpose(1, 2), do.float())
    dp = torch.matmul(do.float(), v.float().transpose(1, 2))
    ds = (p * (dp - delta[..., None]) * scale).to(q.dtype).float()
    dk = torch.matmul(ds.transpose(1, 2), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_ref(q, k, v, do, lse, delta, scale: float, causal: bool):
    """Plain FlashAttention-2 backward: (dq, dk, dv)."""
    return (flash_dq_ref(q, k, v, do, lse, delta, scale, causal),
            *flash_dkv_ref(q, k, v, do, lse, delta, scale, causal))


def _check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               causal: bool) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in _DTYPE_CODE:
            raise TypeError(f"{name} must be float32, bfloat16 or float16, "
                            f"got {t.dtype}")
        if t.dim() != 3:
            raise ValueError(f"{name} must be (BH, T, D), got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v types differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    bh, t_q, d = q.shape
    if k.shape != v.shape or k.shape[0] != bh or k.shape[2] != d:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not fit (BH, T, D)")
    if d < 1 or d != padded_dim(d):
        raise ValueError(f"head dim {d}: the kernels take {HEAD_DIMS} and "
                         f"multiples of {WIDE_STEP} above")
    if t_q < 1 or k.shape[1] < 1:
        raise ValueError("empty sequence")
    if causal and t_q > k.shape[1]:
        raise ValueError(f"causal attention with Tq {t_q} > Tk {k.shape[1]} "
                         f"leaves query rows with no key")


def _check_bwd(q, k, v, do, lse, delta, causal: bool) -> None:
    _check_qkv(q, k, v, causal)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"do must be {tuple(q.shape)} {q.dtype}, got "
                         f"{tuple(do.shape)} {do.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != q.shape[:2] or t.dtype != torch.float32:
            raise ValueError(f"{name} must be {tuple(q.shape[:2])} float32, "
                             f"got {tuple(t.shape)} {t.dtype}")
    for name, t in (("do", do), ("lse", lse), ("delta", delta)):
        if not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"{name} must be contiguous on {q.device}")


def _sm90_library(code: int) -> ctypes.CDLL:
    """The wgmma-tma library of dtype code 1 (bfloat16) or 2 (float16): one
    library a type, so the two build at once."""
    lib = _build.load_library(f"flash_attention_sm90_{code}",
                              ["flash_attention_sm90.cu"],
                              [f"-DFLASH_SM90_DTYPE={code}"])
    if lib.flash_attention_fwd_sm90.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attention_fwd_sm90.argtypes = [i, i, i, p, p, p, p, p, i,
                                                 i, i, f, i, p]
        lib.flash_attention_dq_sm90.argtypes = [i, i, i, p, p, p, p, p, p,
                                                p, i, i, i, f, i, p]
        lib.flash_attention_dkv_sm90.argtypes = [i, i, i, p, p, p, p, p, p,
                                                 p, p, i, i, i, f, i, p]
        for fn in (lib.flash_attention_fwd_sm90, lib.flash_attention_dq_sm90,
                   lib.flash_attention_dkv_sm90):
            fn.restype = ctypes.c_int
    return lib


def _tf32_library() -> ctypes.CDLL:
    """The library of the tc-f32 and tc-wide designs."""
    lib = _build.load_library("flash_attention_tf32",
                              ["flash_attention_tf32.cu"])
    if lib.flash_attention_fwd_tf32.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attention_fwd_tf32.argtypes = [i, i, p, p, p, p, p, i, i,
                                                 i, f, i, p]
        lib.flash_attention_dq_tc.argtypes = [i, i, i, p, p, p, p, p, p, p,
                                              i, i, i, f, i, p]
        lib.flash_attention_dkv_tc.argtypes = [i, i, i, p, p, p, p, p, p, p,
                                               p, i, i, i, f, i, p]
        lib.flash_attention_fwd_wide.argtypes = [i, i, i, p, p, p, p, p, i,
                                                 i, i, f, i, p]
        for fn in (lib.flash_attention_fwd_tf32, lib.flash_attention_dq_tc,
                   lib.flash_attention_dkv_tc, lib.flash_attention_fwd_wide):
            fn.restype = ctypes.c_int
    return lib


def build() -> None:
    """Compile (or find on disk) and load the kernels' three libraries, one
    nvcc for each, started together."""
    with ThreadPoolExecutor(3) as ex:
        for fut in [ex.submit(_sm90_library, 1), ex.submit(_sm90_library, 2),
                    ex.submit(_tf32_library)]:
            fut.result()


def _on_card(*ts: torch.Tensor) -> bool:
    """False for CPU tensors (plain version); True for CUDA tensors that the
    kernels can read; raises for anything else."""
    dev = ts[0].device
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"no flash-attention kernel for device {dev}")
    for t in ts:
        if t.data_ptr() % 16:
            raise ValueError("the kernels need 16-byte aligned tensors")
    return True


def _launched(name: str, design: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"flash_attention {name} kernel ({design}) launch "
                           f"failed: CUDA error {err}")
    LAUNCHES[name] += 1
    DESIGN_LAUNCHES[name][design] += 1


def _head(q: torch.Tensor):
    """(device index, dtype code, head dim, BH, Tq, stream) for a launch."""
    return (q.get_device(), _DTYPE_CODE[q.dtype], q.shape[2], q.shape[0],
            q.shape[1], torch.cuda.current_stream(q.device).cuda_stream)


def _widen(d: int, *ts: torch.Tensor):
    """ts (BH, T, D) zero-padded along D to d."""
    return [torch.nn.functional.pad(t, (0, d - t.shape[2])) for t in ts]


def _cut(x: torch.Tensor, d: int) -> torch.Tensor:
    """The first d columns of x (BH, T, D'), contiguous."""
    return x[..., :d].contiguous()


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float, causal: bool
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2a: (o (BH, Tq, D), lse (BH, Tq) f32) for q (BH, Tq, D), k and v
    (BH, Tk, D). A CPU tensor runs the plain version; a CUDA tensor
    launches the kernel on the current stream, without synchronising."""
    _check_qkv(q, k, v, causal)
    if not _on_card(q, k, v):
        return flash_fwd_ref(q, k, v, scale, causal)
    d_run = padded_dim(q.shape[2], q.dtype)
    if d_run != q.shape[2]:  # float32 D 32: the D 64 kernel, padded
        o, lse = flash_fwd(*_widen(d_run, q, k, v), scale, causal)
        return _cut(o, q.shape[2]), lse
    dev, code, d, bh, t_q, stream = _head(q)
    o = torch.empty_like(q)
    lse = torch.empty((bh, t_q), dtype=torch.float32, device=q.device)
    design = _design("fwd", q.dtype, d)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), bh, t_q, k.shape[1], scale, int(causal), stream)
    if design == "wgmma-tma":
        err = _sm90_library(code).flash_attention_fwd_sm90(dev, code, d,
                                                           *ptrs)
    elif design == "tc-f32":
        err = _tf32_library().flash_attention_fwd_tf32(dev, d, *ptrs)
    else:
        err = _tf32_library().flash_attention_fwd_wide(dev, code, d, *ptrs)
    _launched("fwd", design, err)
    return o, lse


def flash_dq(q, k, v, do, lse, delta, scale: float,
             causal: bool) -> torch.Tensor:
    """K2b: dq (BH, Tq, D) from do (BH, Tq, D), lse and delta (BH, Tq)."""
    _check_bwd(q, k, v, do, lse, delta, causal)
    if not _on_card(q, k, v, do, lse, delta):
        return flash_dq_ref(q, k, v, do, lse, delta, scale, causal)
    d_run = padded_dim(q.shape[2], q.dtype)
    if d_run != q.shape[2]:  # float32 D 32: the D 64 kernel, padded
        return _cut(flash_dq(*_widen(d_run, q, k, v, do), lse, delta, scale,
                             causal), q.shape[2])
    dev, code, d, bh, t_q, stream = _head(q)
    dq = torch.empty_like(q)
    design = _design("dq", q.dtype, d)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), bh, t_q,
            k.shape[1], scale, int(causal), stream)
    if design == "wgmma-tma":
        err = _sm90_library(code).flash_attention_dq_sm90(dev, code, d, *ptrs)
    else:
        err = _tf32_library().flash_attention_dq_tc(dev, code, d, *ptrs)
    _launched("dq", design, err)
    return dq


def flash_dkv(q, k, v, do, lse, delta, scale: float,
              causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2c: (dk, dv), each (BH, Tk, D), from the same inputs as K2b."""
    _check_bwd(q, k, v, do, lse, delta, causal)
    if not _on_card(q, k, v, do, lse, delta):
        return flash_dkv_ref(q, k, v, do, lse, delta, scale, causal)
    d_run = padded_dim(q.shape[2], q.dtype)
    if d_run != q.shape[2]:  # float32 D 32: the D 64 kernel, padded
        dk, dv = flash_dkv(*_widen(d_run, q, k, v, do), lse, delta, scale,
                           causal)
        return _cut(dk, q.shape[2]), _cut(dv, q.shape[2])
    dev, code, d, bh, t_q, stream = _head(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    design = _design("dkv", q.dtype, d)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            bh, t_q, k.shape[1], scale, int(causal), stream)
    if design == "wgmma-tma":
        err = _sm90_library(code).flash_attention_dkv_sm90(dev, code, d,
                                                           *ptrs)
    else:
        err = _tf32_library().flash_attention_dkv_tc(dev, code, d, *ptrs)
    _launched("dkv", design, err)
    return dk, dv


def padded_dim(d: int, dtype: Optional[torch.dtype] = None) -> int:
    """The head dim the kernels run a head dim ``d`` at: the smallest of
    ``HEAD_DIMS`` that holds it, above the largest the next multiple of
    ``WIDE_STEP``. With ``dtype``, the one the card's kernels run for that
    type: float32 at most 32 at 64, the smallest tc-f32 dim (16-bit D 32
    runs the wgmma-tma kernels at 32). Raises for d < 1."""
    if d < 1:
        raise ValueError(f"head dim {d}: must be at least 1")
    if dtype == torch.float32 and d < TC_F32_MIN:
        return TC_F32_MIN
    for built in HEAD_DIMS:
        if d <= built:
            return built
    return -(-d // WIDE_STEP) * WIDE_STEP


def _to_bthd(x: torch.Tensor, d_pad: int) -> torch.Tensor:
    """(B, T, H, D) -> contiguous (B*H, T, d_pad), zero-padded along D."""
    b, t, h, d = x.shape
    if d_pad != d:
        x = torch.nn.functional.pad(x, (0, d_pad - d))
    return x.transpose(1, 2).reshape(b * h, t, d_pad).contiguous()


def _from_bthd(x: torch.Tensor, b: int, d: int) -> torch.Tensor:
    """(B*H, T, d_pad) -> (B, T, H, d) view, the padded columns dropped."""
    bh, t, d_pad = x.shape
    return x.view(b, bh // b, t, d_pad).transpose(1, 2)[..., :d]


class FlashAttention(torch.autograd.Function):
    """Fused attention on (B, T, H, D): K2a forward, K2b and K2c backward,
    at any D >= 1 (zero-padded to ``padded_dim(D)``, on the card
    ``padded_dim(D, dtype)``).

    Forward saves (q, k, v, o, lse), as ccv_tpu's custom_vjp does; the
    backward forms delta = rowsum(dO * O) in plain torch (ccv_tpu forms it
    outside Pallas too) and runs K2b, then K2c."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, is_causal: bool):
        d = q.shape[-1]
        # on the card, the dim the kernels run at (float32 D 1-32: 64), so
        # the wrappers need not pad again; the plain versions on the CPU
        # run at the smallest built dim
        d_pad = padded_dim(d, q.dtype if q.is_cuda else None)
        o, lse = flash_fwd(_to_bthd(q, d_pad), _to_bthd(k, d_pad),
                           _to_bthd(v, d_pad), scale, is_causal)
        o = _from_bthd(o, q.shape[0], d)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.causal, ctx.d_pad = scale, is_causal, d_pad
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        b, d, d_pad = q.shape[0], q.shape[-1], ctx.d_pad
        delta = (g.float() * o.float()).sum(-1)          # (B, T, H)
        args = (_to_bthd(q, d_pad), _to_bthd(k, d_pad), _to_bthd(v, d_pad),
                _to_bthd(g.to(q.dtype), d_pad), lse,
                delta.transpose(1, 2).reshape(lse.shape).contiguous(),
                ctx.scale, ctx.causal)
        dq = flash_dq(*args)
        dk, dv = flash_dkv(*args)
        return (_from_bthd(dq, b, d), _from_bthd(dk, b, d),
                _from_bthd(dv, b, d), None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None,
                    is_causal: bool = False) -> torch.Tensor:
    """Fused scaled-dot-product attention, (B, T, H, D) layout, any D >= 1
    and float32, bfloat16 or float16; the scale defaults to 1/sqrt(D) of
    the unpadded D. Differentiable in q, k and v."""
    d = q.shape[-1]
    padded_dim(d)  # raises for a head dim below 1
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    return FlashAttention.apply(q, k, v, float(scale), bool(is_causal))
