"""Transformer family of the port (counterpart of
ccv_tpu/models/transformer.py, with the same names): the decoder-only LM,
wmt.c's encoder-decoder and imdb.c's encoder classifier.

Parameters are a nested dict of float32 tensors laid out as ``ccv_tpu``'s:
dense weights are ``(d_in, d_out)`` and a layer computes ``x @ w + b``, so
``params_from_jax`` is a copy. Compute runs in ``cfg.dtype`` (bf16 in the
LM) with casts at the edges, as in ``ccv_tpu``:

* attention goes through the flash kernels
  (``ccv_tpu_torch.ops.kernels.flash_attention``) on a CUDA tensor when
  there is no key mask, no attention dropout and Tq == Tk, and through the
  plain SDPA otherwise, as ``ccv_tpu``'s ``_use_flash`` and ``_attend``
  route it. In the encoder-decoder with a source mask (the wmt / iwslt
  step, greedy decoding) only the decoder's causal self-attention takes
  the kernels; the encoder and the cross-attention are masked;
* blocks are post-layer-norm inside the residual branch
  (``x + LN(attn(x))``), ReLU feed-forward, as wmt.c;
* ``cfg.remat`` checkpoints each block; ``remat_policy="dots"`` saves the
  weight-matmul outputs and recomputes the rest, flash forward included.

Dropout draws its masks from integer seeds split off the caller's
``torch.Generator`` before the layers run (JAX's keys split per block), so
a recomputed block draws the same masks. The numbers differ from JAX's.

Not ported: ``RingSpec`` (sequence-parallel attention), ``shardings()``
and the measured Pallas-or-XLA choice in ``_attend`` (``nn/autotune``): the
port takes the kernels wherever ``ccv_tpu``'s default does.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from ccv_tpu_torch import device as _device
from ccv_tpu_torch.ops.kernels.flash_attention import flash_attention


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Hyper-parameters (defaults = wmt.c main(): k=64 h=8 layers=6
    ff=2048, dropout 0.1, max_length 128)."""
    vocab_size: int
    tgt_vocab_size: Optional[int] = None   # encoder-decoder only
    layers: int = 6
    heads: int = 8
    head_dim: int = 64
    ff: int = 2048
    max_len: int = 128
    dropout: float = 0.1
    dtype: torch.dtype = torch.bfloat16
    # rematerialize each block's activations in the backward pass
    remat: bool = False
    # "full" recomputes the whole block; "dots" saves the block's
    # weight-matmul outputs and recomputes the rest (JAX's
    # dots_with_no_batch_dims_saveable)
    remat_policy: str = "full"

    @property
    def dim(self) -> int:
        return self.heads * self.head_dim


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------

def _dense_init(generator: torch.Generator, d_in: int,
                d_out: int) -> torch.Tensor:
    bound = math.sqrt(6.0 / (d_in + d_out))   # glorot, like ccv_cnnp_dense
    w = torch.empty((d_in, d_out), dtype=torch.float32,
                    device=generator.device)
    return w.uniform_(-bound, bound, generator=generator)


def _block_init(generator: torch.Generator, cfg: TransformerConfig,
                cross: bool = False) -> Dict[str, Any]:
    """One block: self-attention and feed-forward, and with ``cross`` the
    decoder's cross-attention (``x``-prefixed weights and ``ln_x``)."""
    d, ff, dev = cfg.dim, cfg.ff, generator.device

    def zeros(n):
        return torch.zeros((n,), device=dev)

    def norm():
        return {"g": torch.ones((d,), device=dev), "b": zeros(d)}

    p = {
        "wq": _dense_init(generator, d, d), "wk": _dense_init(generator, d, d),
        "wv": _dense_init(generator, d, d), "wo": _dense_init(generator, d, d),
        "bq": zeros(d), "bk": zeros(d), "bv": zeros(d), "ln1": norm(),
        "w1": _dense_init(generator, d, ff), "b1": zeros(ff),
        "w2": _dense_init(generator, ff, d), "b2": zeros(d), "ln2": norm(),
    }
    if cross:
        p.update({f"x{n}": _dense_init(generator, d, d)
                  for n in ("wq", "wk", "wv", "wo")})
        p.update({f"x{n}": zeros(d) for n in ("bq", "bk", "bv")})
        p["ln_x"] = norm()
    return p


def _requires_grad(tree):
    if isinstance(tree, dict):
        return {key: _requires_grad(val) for key, val in tree.items()}
    if isinstance(tree, list):
        return [_requires_grad(val) for val in tree]
    return tree.requires_grad_(True)


def _embedding(generator: torch.Generator, n: int,
               cfg: TransformerConfig) -> torch.Tensor:
    return torch.randn((n, cfg.dim), generator=generator,
                       device=generator.device) * 0.02


def init_encoder_decoder(generator: torch.Generator,
                         cfg: TransformerConfig) -> Dict[str, Any]:
    """Parameters of wmt.c's ``_encoder_decoder_new`` twin on the
    generator's device, float32 leaf tensors that require grad."""
    tgt_vocab = cfg.tgt_vocab_size or cfg.vocab_size
    return _requires_grad({
        "src_embed": _embedding(generator, cfg.vocab_size, cfg),
        "tgt_embed": _embedding(generator, tgt_vocab, cfg),
        "encoder": [_block_init(generator, cfg) for _ in range(cfg.layers)],
        "decoder": [_block_init(generator, cfg, cross=True)
                    for _ in range(cfg.layers)],
        "out": _dense_init(generator, cfg.dim, tgt_vocab),
    })


def init_encoder_classifier(generator: torch.Generator,
                            cfg: TransformerConfig,
                            num_classes: int) -> Dict[str, Any]:
    """Parameters of imdb.c's encoder-only classifier twin."""
    return _requires_grad({
        "src_embed": _embedding(generator, cfg.vocab_size, cfg),
        "encoder": [_block_init(generator, cfg) for _ in range(cfg.layers)],
        "out": _dense_init(generator, cfg.dim, num_classes),
    })


def init_lm(generator: torch.Generator,
            cfg: TransformerConfig) -> Dict[str, Any]:
    """Decoder-only LM parameters on the generator's device, float32 leaf
    tensors that require grad."""
    return _requires_grad({
        "src_embed": _embedding(generator, cfg.vocab_size, cfg),
        "encoder": [_block_init(generator, cfg) for _ in range(cfg.layers)],
        "out": _dense_init(generator, cfg.dim, cfg.vocab_size),
    })


def params_from_jax(tree, device=None) -> Dict[str, Any]:
    """The port's parameters from ``ccv_tpu``'s: ``tree`` is the nested dict
    (and lists) of numpy arrays that ``jax.tree_util.tree_map(np.asarray,
    init_lm(...))`` gives, or the same of ``init_encoder_decoder`` or
    ``init_encoder_classifier``. Same layout, so this is a copy, on
    ``device`` (default: the card; raises without one)."""
    device = _device.resolve(device)
    def conv(x):
        if isinstance(x, dict):
            return {key: conv(val) for key, val in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(val) for val in x]
        return torch.tensor(np.asarray(x, np.float32), device=device)
    return _requires_grad(conv(tree))


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def sinusoid_positions(t: int, d: int, device=None) -> torch.Tensor:
    pos = np.arange(t)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * i / d)
    out = np.zeros((t, d), np.float32)
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang)
    return torch.from_numpy(out).to(device)


def _layer_norm(x: torch.Tensor, p, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, correction=0)
    return ((x32 - mu) * torch.rsqrt(var + eps) * p["g"]
            + p["b"]).to(x.dtype)


def _split(seed: Optional[int], n: int) -> List[Optional[int]]:
    """n seeds derived from one (None stays None): JAX's key split."""
    if seed is None:
        return [None] * n
    g = torch.Generator().manual_seed(seed)
    return [int(s) for s in torch.randint(0, 2**62, (n,), generator=g)]


def _dropout(x: torch.Tensor, rate: float, seed: Optional[int],
             train: bool) -> torch.Tensor:
    if not train or rate <= 0.0 or seed is None:
        return x
    g = torch.Generator(device=x.device).manual_seed(seed)
    keep = torch.rand(x.shape, generator=g, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)


def _use_flash(mask, dropout: float, train: bool,
               device: torch.device) -> bool:
    # the kernels take no key mask and no attention-weight dropout, so those
    # go through the plain SDPA; on the CPU the plain SDPA is the path (as
    # ccv_tpu takes XLA's SDPA off the TPU)
    return (mask is None and device.type == "cuda"
            and (not train or dropout <= 0.0))


def _attend(q, k, v, heads: int, causal: bool, mask, dropout: float,
            seed: Optional[int], train: bool) -> torch.Tensor:
    """(B, T, D) x3 -> (B, T, D) multi-head attention.

    mask: (B, Tk) True=valid (per-sequence length masks) or None."""
    B, Tq, D = q.shape
    Tk = k.shape[1]
    hd = D // heads
    scale = 1.0 / math.sqrt(hd)
    qh = q.reshape(B, Tq, heads, hd)
    kh = k.reshape(B, Tk, heads, hd)
    vh = v.reshape(B, Tk, heads, hd)
    if _use_flash(mask, dropout, train, q.device) and Tq == Tk:
        # ccv_tpu measures Pallas against XLA per shape here (autotune); the
        # port has no autotune yet and always takes the kernels
        out = flash_attention(qh, kh, vh, scale=scale, is_causal=causal)
    else:
        out = _sdpa_plain(qh, kh, vh, scale, causal, mask, dropout, seed,
                          train)
    return out.reshape(B, Tq, D)


def _sdpa_plain(qh, kh, vh, scale: float, causal: bool, mask,
                dropout: float, seed: Optional[int],
                train: bool) -> torch.Tensor:
    """Plain SDPA on (B, T, h, d) heads-split tensors: ccv_tpu's
    ``_sdpa_xla`` (top-left causal mask, masked scores -1e9)."""
    Tq, Tk = qh.shape[1], kh.shape[1]
    logits = torch.einsum("bqhd,bkhd->bhqk", qh.float(), kh.float()) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask[:, None, None, :], -1e9)
    if causal:
        cm = torch.ones(Tq, Tk, dtype=torch.bool, device=qh.device).tril()
        logits = logits.masked_fill(~cm, -1e9)
    w = torch.softmax(logits, dim=-1)
    w = _dropout(w, dropout, seed, train)
    return torch.einsum("bhqk,bkhd->bqhd", w.to(vh.dtype), vh)


def _mha(p, x, mem, cfg: TransformerConfig, causal: bool, mask,
         seed: Optional[int], train: bool, prefix: str = "") -> torch.Tensor:
    """Attention of x over itself, or with ``mem`` over mem (k and v from
    mem: the decoder's cross-attention, weights ``prefix``-named)."""
    dt = cfg.dtype
    wq, wk, wv, wo = (p[prefix + n].to(dt) for n in ("wq", "wk", "wv", "wo"))
    bq, bk, bv = (p[prefix + n].to(dt) for n in ("bq", "bk", "bv"))
    src = x if mem is None else mem
    q = x @ wq + bq
    k = src @ wk + bk
    v = src @ wv + bv
    o = _attend(q, k, v, cfg.heads, causal, mask, cfg.dropout, seed, train)
    return o @ wo


def _ffn(p, x, cfg: TransformerConfig) -> torch.Tensor:
    dt = cfg.dtype
    h = torch.relu(x @ p["w1"].to(dt) + p["b1"].to(dt))
    return h @ p["w2"].to(dt) + p["b2"].to(dt)


def _encoder_block(p, x, cfg: TransformerConfig, mask, seed: Optional[int],
                   train: bool, causal: bool = False) -> torch.Tensor:
    """wmt.c:181-199 `_encoder_block_new`: x + LN(attn(x)), then
    first + LN(ffn(.)) — layer norm inside the residual branch."""
    s1, s2, s3 = _split(seed, 3)
    a = _mha(p, x, None, cfg, causal, mask, s1, train)
    first = x + _layer_norm(a, p["ln1"])
    out = _dropout(first, cfg.dropout, s2, train)
    out = _ffn(p, out, cfg)
    out = first + _layer_norm(out, p["ln2"])
    return _dropout(out, cfg.dropout, s3, train)


def _decoder_block(p, x, mem, cfg: TransformerConfig, src_mask, tgt_mask,
                   seed: Optional[int], train: bool) -> torch.Tensor:
    """wmt.c:203-233 `_decoder_block_new`: causal self-attention,
    cross-attention over mem, ffn, each as first + LN(branch); no dropout
    after the last residual (unlike the encoder block), as ccv_tpu."""
    s1, s2, s3, s4 = _split(seed, 4)
    a = _mha(p, x, None, cfg, True, tgt_mask, s1, train)
    first = x + _layer_norm(a, p["ln1"])
    out = _dropout(first, cfg.dropout, s2, train)
    xa = _mha(p, out, mem, cfg, False, src_mask, s3, train, prefix="x")
    first = first + _layer_norm(xa, p["ln_x"])
    out = _dropout(first, cfg.dropout, s4, train)
    out = _ffn(p, out, cfg)
    return first + _layer_norm(out, p["ln2"])


def _embed(table, ids, cfg: TransformerConfig, dt) -> torch.Tensor:
    x = table.to(dt)[ids] * math.sqrt(cfg.dim)
    T = ids.shape[1]
    return x + sinusoid_positions(T, cfg.dim, ids.device).to(dt)


# ops whose outputs "dots" keeps: the weight matmuls (x @ w is aten.mm on
# the flattened rows; attention's batched products are aten.bmm and are
# recomputed), as dots_with_no_batch_dims_saveable keeps dot_generals
# without batch dimensions
_DOTS = [torch.ops.aten.mm.default, torch.ops.aten.addmm.default]


def _remat(block, policy: str):
    """``block`` checkpointed: "full" recomputes all of it, "dots" all but
    the weight matmuls."""
    contexts = {"full": noop_context_fn,
                "dots": functools.partial(
                    create_selective_checkpoint_contexts, _DOTS)}
    if policy not in contexts:
        raise ValueError(f"remat_policy must be 'full' or 'dots', got "
                         f"{policy!r}")
    return functools.partial(checkpoint, block, use_reentrant=False,
                             context_fn=contexts[policy])


def _seeds(key: Optional[torch.Generator], n: int) -> List[Optional[int]]:
    """n dropout seeds drawn from ``key`` (None: no dropout)."""
    if key is None:
        return [None] * n
    return torch.randint(0, 2**62, (n,), generator=key,
                         device=key.device).tolist()


def encoder_decoder_forward(params, cfg: TransformerConfig,
                            src: torch.Tensor, tgt: torch.Tensor,
                            src_mask=None, tgt_mask=None,
                            train: bool = False,
                            key: Optional[torch.Generator] = None
                            ) -> torch.Tensor:
    """wmt.c `_encoder_decoder_new` twin: (B, Ts) src and (B, Tt) tgt token
    ids -> (B, Tt, tgt_vocab) float32 logits. Masks are (B, T) booleans
    (True = valid token); key: a torch.Generator for dropout."""
    dt = cfg.dtype
    seeds = _seeds(key, 2 * cfg.layers + 1)
    x = _embed(params["src_embed"], src, cfg, dt)
    x = _dropout(x, cfg.dropout, seeds[-1], train)
    for i, blk in enumerate(params["encoder"]):
        x = _encoder_block(blk, x, cfg, src_mask, seeds[i], train)
    y = _embed(params["tgt_embed"], tgt, cfg, dt)
    for i, blk in enumerate(params["decoder"]):
        y = _decoder_block(blk, y, x, cfg, src_mask, tgt_mask,
                           seeds[cfg.layers + i], train)
    return (y @ params["out"].to(dt)).float()


def encoder_classifier_forward(params, cfg: TransformerConfig,
                               src: torch.Tensor, src_mask=None,
                               train: bool = False,
                               key: Optional[torch.Generator] = None
                               ) -> torch.Tensor:
    """imdb.c twin: encoder stack, mean-pool over the valid tokens (in
    float32), linear head -> (B, num_classes) logits in ``cfg.dtype``
    (not float32, as ccv_tpu)."""
    dt = cfg.dtype
    seeds = _seeds(key, cfg.layers + 1)
    x = _embed(params["src_embed"], src, cfg, dt)
    x = _dropout(x, cfg.dropout, seeds[-1], train)
    for i, blk in enumerate(params["encoder"]):
        x = _encoder_block(blk, x, cfg, src_mask, seeds[i], train)
    if src_mask is not None:
        m = src_mask[..., None].float()
        pooled = (x.float() * m).sum(1) / m.sum(1).clamp_min(1.0)
    else:
        pooled = x.float().mean(1)
    return pooled.to(dt) @ params["out"].to(dt)


def lm_forward(params, cfg: TransformerConfig, ids: torch.Tensor,
               train: bool = False,
               key: Optional[torch.Generator] = None) -> torch.Tensor:
    """Decoder-only LM: (B, T) int64 -> (B, T, vocab) float32 logits.

    key: a torch.Generator for dropout (None = no dropout)."""
    dt = cfg.dtype
    seeds = _seeds(key, cfg.layers + 1)
    x = _embed(params["src_embed"], ids, cfg, dt)
    x = _dropout(x, cfg.dropout, seeds[-1], train)
    block = _remat(_encoder_block, cfg.remat_policy) if cfg.remat \
        else _encoder_block
    for i, blk in enumerate(params["encoder"]):
        x = block(blk, x, cfg, None, seeds[i], train, True)
    return (x @ params["out"].to(dt)).float()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  label_smoothing: float = 0.0, mask=None) -> torch.Tensor:
    """Token cross entropy with optional smoothing; mask (B,T) True=count."""
    logp = torch.log_softmax(logits.float(), -1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    if label_smoothing > 0.0:
        nll = (1.0 - label_smoothing) * nll - label_smoothing * logp.mean(-1)
    if mask is not None:
        m = mask.float()
        return (nll * m).sum() / m.sum().clamp_min(1.0)
    return nll.mean()
