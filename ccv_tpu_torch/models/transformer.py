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

Parallelism (one process per rank, ``ccv_tpu_torch.parallel``):

* data: inside ``parallel.data.sharded`` a rank's dropout masks are its
  rows of the global batch's and ``cross_entropy`` divides by the global
  count of (unmasked) tokens, so allreduced gradients are the one-rank
  step's;
* tensor (Megatron, explicit where GSPMD places the collectives for
  ``ccv_tpu``): ``shardings()`` gives ``ccv_tpu``'s placements and
  ``shard_params`` this rank's blocks. With ``tensor=TensorSpec(mesh)``
  q, k, v and ff1 are column-parallel, the output projection and ff2
  row-parallel with an allreduce on the axis, Megatron's conjugate
  identity / allreduce at each block's input; attention runs on the rank's
  own H / tp heads (through K2 on the card, as on one rank); the embedding
  tables and the vocabulary projection are column blocks whose outputs are
  gathered. A parameter whose dimension does not divide stays whole and
  computes replicated;
* sequence: ``RingSpec`` sends self-attention round the mesh's sequence
  axis (``parallel.sequence.ring_attention``) on local slices, positions
  offset by the rank's slice; with ``head_axis`` the blocks are
  tensor-parallel on it as well.

``_attend`` does not ask ``nn.autotune`` as ``ccv_tpu``'s does: its other
form is library or plain attention, which never competes with a kernel on
the card, so the port takes the kernels wherever ``ccv_tpu``'s default
does (``layers.attention_route``).
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
from ccv_tpu_torch.parallel import data as _data
from ccv_tpu_torch.parallel import mesh as _mesh


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


def _wide(x: torch.Tensor) -> torch.Tensor:
    """x in float32, or float64 if it is float64 (the sums and softmaxes
    run "in float32" widen half types and never narrow float64)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _layer_norm(x: torch.Tensor, p, eps: float = 1e-5) -> torch.Tensor:
    x32 = _wide(x)
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
             train: bool, extra=()) -> torch.Tensor:
    """Inverted dropout from ``seed``; under data parallelism (and with
    ``extra``'s (dimension, group) pairs, heads over a tensor-parallel
    group) this rank's block of the global tensor's mask."""
    if not train or rate <= 0.0 or seed is None:
        return x
    g = torch.Generator(device=x.device).manual_seed(seed)
    keep = _data.rand(x.shape, g, x.device, extra) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)


def _use_flash(mask, dropout: float, train: bool,
               device: torch.device) -> bool:
    # the kernels take no key mask and no attention-weight dropout, so those
    # go through the plain SDPA; on the CPU the plain SDPA is the path (as
    # ccv_tpu takes XLA's SDPA off the TPU)
    return (mask is None and device.type == "cuda"
            and (not train or dropout <= 0.0))


@dataclasses.dataclass(frozen=True)
class RingSpec:
    """Sequence-parallel self-attention (``ccv_tpu``'s RingSpec): the
    forward's tokens are this rank's slice of the sequence over
    ``seq_axis`` of ``mesh``, and unmasked self-attention runs as ring
    attention. ``batch_axis`` names the data axis (the caller's
    ``parallel.data.sharded``); ``head_axis`` makes the blocks
    tensor-parallel on that axis (``TensorSpec``)."""
    mesh: Any
    seq_axis: str = "seq"
    batch_axis: Optional[str] = None
    head_axis: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Megatron tensor parallelism over ``axis`` of ``mesh``: the
    parameters are this rank's blocks (``shard_params``)."""
    mesh: Any
    axis: str = "model"

    @property
    def group(self):
        return self.mesh.get_group(self.axis)


def _attend(q, k, v, heads: int, causal: bool, mask, dropout: float,
            seed: Optional[int], train: bool,
            ring: Optional[RingSpec] = None, head_group=None
            ) -> torch.Tensor:
    """(B, T, D) x3 -> (B, T, D) multi-head attention over ``heads`` (this
    rank's, under tensor parallelism: ``head_group``).

    mask: (B, Tk) True=valid (per-sequence length masks) or None."""
    B, Tq, D = q.shape
    Tk = k.shape[1]
    hd = D // heads
    scale = 1.0 / math.sqrt(hd)
    qh = q.reshape(B, Tq, heads, hd)
    kh = k.reshape(B, Tk, heads, hd)
    vh = v.reshape(B, Tk, heads, hd)
    if ring is not None and mask is None and Tq == Tk:
        from ccv_tpu_torch.parallel import sequence
        out = sequence.ring_attention(qh, kh, vh, ring.mesh, ring.seq_axis,
                                      scale=scale, is_causal=causal)
    elif _use_flash(mask, dropout, train, q.device) and Tq == Tk:
        # ccv_tpu measures Pallas against XLA per shape here (autotune). The
        # port does not: the only other form is library or plain attention,
        # and on the card no plain form competes with a kernel (K2), so the
        # route is layers.attention_route's
        out = flash_attention(qh, kh, vh, scale=scale, is_causal=causal)
    else:
        out = _sdpa_plain(qh, kh, vh, scale, causal, mask, dropout, seed,
                          train, () if head_group is None
                          else ((1, head_group),))
    return out.reshape(B, Tq, D)


def _sdpa_plain(qh, kh, vh, scale: float, causal: bool, mask,
                dropout: float, seed: Optional[int],
                train: bool, extra=()) -> torch.Tensor:
    """Plain SDPA on (B, T, h, d) heads-split tensors: ccv_tpu's
    ``_sdpa_xla`` (top-left causal mask, masked scores -1e9)."""
    Tq, Tk = qh.shape[1], kh.shape[1]
    logits = torch.einsum("bqhd,bkhd->bhqk", _wide(qh), _wide(kh)) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask[:, None, None, :], -1e9)
    if causal:
        cm = torch.ones(Tq, Tk, dtype=torch.bool, device=qh.device).tril()
        logits = logits.masked_fill(~cm, -1e9)
    w = torch.softmax(logits, dim=-1)
    w = _dropout(w, dropout, seed, train, extra)
    return torch.einsum("bhqk,bkhd->bqhd", w.to(vh.dtype), vh)


def _sharded(group, local: int, whole: int):
    """``group`` when a parameter's local width is a block of ``whole``,
    None when the parameter is whole (replicated, or no tensor
    parallelism)."""
    return group if group is not None and local != whole else None


def _mha(p, x, mem, cfg: TransformerConfig, causal: bool, mask,
         seed: Optional[int], train: bool, prefix: str = "",
         ring: Optional[RingSpec] = None,
         tp: Optional[TensorSpec] = None) -> torch.Tensor:
    """Attention of x over itself, or with ``mem`` over mem (k and v from
    mem: the decoder's cross-attention, weights ``prefix``-named). Under
    tensor parallelism q, k, v are column blocks (this rank's heads) and
    the output projection a row block, allreduced."""
    dt = cfg.dtype
    wq, wk, wv, wo = (p[prefix + n].to(dt) for n in ("wq", "wk", "wv", "wo"))
    bq, bk, bv = (p[prefix + n].to(dt) for n in ("bq", "bk", "bv"))
    group = _sharded(tp and tp.group, wq.shape[1], cfg.dim)
    if wq.shape[1] % cfg.head_dim:
        raise ValueError(f"{wq.shape[1]} columns of q are not whole heads "
                         f"of {cfg.head_dim}")
    if group is not None:
        x = _mesh.copy_to(x, group)
        mem = None if mem is None else _mesh.copy_to(mem, group)
    src = x if mem is None else mem
    q = x @ wq + bq
    k = src @ wk + bk
    v = src @ wv + bv
    o = _attend(q, k, v, wq.shape[1] // cfg.head_dim, causal, mask,
                cfg.dropout, seed, train, ring=ring, head_group=group)
    o = o @ wo
    return o if group is None else _mesh.reduce_from(o, group)


def _ffn(p, x, cfg: TransformerConfig,
         tp: Optional[TensorSpec] = None) -> torch.Tensor:
    """ReLU feed-forward; under tensor parallelism ff1 a column block, ff2
    a row block allreduced before its (whole) bias."""
    dt = cfg.dtype
    group = _sharded(tp and tp.group, p["w1"].shape[1], cfg.ff)
    if group is not None:
        x = _mesh.copy_to(x, group)
    h = torch.relu(x @ p["w1"].to(dt) + p["b1"].to(dt))
    y = h @ p["w2"].to(dt)
    if group is not None:
        y = _mesh.reduce_from(y, group)
    return y + p["b2"].to(dt)


def _encoder_block(p, x, cfg: TransformerConfig, mask, seed: Optional[int],
                   train: bool, causal: bool = False,
                   ring: Optional[RingSpec] = None,
                   tp: Optional[TensorSpec] = None) -> torch.Tensor:
    """wmt.c:181-199 `_encoder_block_new`: x + LN(attn(x)), then
    first + LN(ffn(.)) — layer norm inside the residual branch."""
    s1, s2, s3 = _split(seed, 3)
    a = _mha(p, x, None, cfg, causal, mask, s1, train, ring=ring, tp=tp)
    first = x + _layer_norm(a, p["ln1"])
    out = _dropout(first, cfg.dropout, s2, train)
    out = _ffn(p, out, cfg, tp)
    out = first + _layer_norm(out, p["ln2"])
    return _dropout(out, cfg.dropout, s3, train)


def _decoder_block(p, x, mem, cfg: TransformerConfig, src_mask, tgt_mask,
                   seed: Optional[int], train: bool,
                   tp: Optional[TensorSpec] = None) -> torch.Tensor:
    """wmt.c:203-233 `_decoder_block_new`: causal self-attention,
    cross-attention over mem, ffn, each as first + LN(branch); no dropout
    after the last residual (unlike the encoder block), as ccv_tpu."""
    s1, s2, s3, s4 = _split(seed, 4)
    a = _mha(p, x, None, cfg, True, tgt_mask, s1, train, tp=tp)
    first = x + _layer_norm(a, p["ln1"])
    out = _dropout(first, cfg.dropout, s2, train)
    xa = _mha(p, out, mem, cfg, False, src_mask, s3, train, prefix="x",
              tp=tp)
    first = first + _layer_norm(xa, p["ln_x"])
    out = _dropout(first, cfg.dropout, s4, train)
    out = _ffn(p, out, cfg, tp)
    return first + _layer_norm(out, p["ln2"])


def _embed(table, ids, cfg: TransformerConfig, dt, offset: int = 0,
           tp: Optional[TensorSpec] = None) -> torch.Tensor:
    """Token embeddings times sqrt(dim) plus the sinusoid positions of
    ``offset`` on; a column block of the table is gathered on its axis."""
    x = table.to(dt)[ids]
    group = _sharded(tp and tp.group, table.shape[1], cfg.dim)
    if group is not None:
        x = _mesh.gather_from(x, group, -1)
    x = x * math.sqrt(cfg.dim)
    T = ids.shape[1]
    pos = sinusoid_positions(offset + T, cfg.dim, ids.device)[offset:]
    return x + pos.to(dt)


def _project(x, w, whole: int, dt, tp: Optional[TensorSpec] = None
             ) -> torch.Tensor:
    """x @ w; a column block of w (of ``whole`` columns) under tensor
    parallelism has its output gathered on its axis."""
    group = _sharded(tp and tp.group, w.shape[1], whole)
    if group is None:
        return x @ w.to(dt)
    return _mesh.gather_from(_mesh.copy_to(x, group) @ w.to(dt), group, -1)


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
    ids -> (B, Tt, tgt_vocab) float32 logits (float64 in a float64
    config). Masks are (B, T) booleans
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
    return _wide(y @ params["out"].to(dt))


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
        m = src_mask[..., None].to(_wide(x).dtype)
        pooled = (_wide(x) * m).sum(1) / m.sum(1).clamp_min(1.0)
    else:
        pooled = _wide(x).mean(1)
    return pooled.to(dt) @ params["out"].to(dt)


def lm_forward(params, cfg: TransformerConfig, ids: torch.Tensor,
               train: bool = False,
               key: Optional[torch.Generator] = None,
               ring: Optional[RingSpec] = None,
               tensor: Optional[TensorSpec] = None) -> torch.Tensor:
    """Decoder-only LM: (B, T) int64 -> (B, T, vocab) float32 logits
    (float64 in a float64 config).

    key: a torch.Generator for dropout (None = no dropout). ring: the ids
    are this rank's slice of the sequence and self-attention runs round
    the ring (``RingSpec``). tensor (or ``ring.head_axis``): ``params``
    are this rank's Megatron blocks (``shard_params``); the logits come
    back whole."""
    dt = cfg.dtype
    tp = tensor
    if tp is None and ring is not None and ring.head_axis is not None:
        tp = TensorSpec(ring.mesh, ring.head_axis)
    offset = 0 if ring is None else (
        ring.mesh.get_local_rank(ring.seq_axis) * ids.shape[1])
    seeds = _seeds(key, cfg.layers + 1)
    x = _embed(params["src_embed"], ids, cfg, dt, offset, tp)
    x = _dropout(x, cfg.dropout, seeds[-1], train)
    block = _remat(_encoder_block, cfg.remat_policy) if cfg.remat \
        else _encoder_block
    for i, blk in enumerate(params["encoder"]):
        x = block(blk, x, cfg, None, seeds[i], train, True, ring, tp)
    return _wide(_project(x, params["out"], cfg.vocab_size, dt, tp))


# ---------------------------------------------------------------------------
# Placements (ccv_tpu's dp x tp shardings over a ('data', 'model') mesh)
# ---------------------------------------------------------------------------

def _block_spec(cross: bool) -> Dict[str, Any]:
    """``ccv_tpu``'s PartitionSpecs of a block, as tuples of axis names
    (None: whole) per tensor dimension."""
    col, row, vec, rep = (None, "model"), ("model", None), ("model",), ()
    p = {
        "wq": col, "wk": col, "wv": col, "wo": row,
        "bq": vec, "bk": vec, "bv": vec,
        "ln1": {"g": rep, "b": rep},
        "w1": col, "b1": vec, "w2": row, "b2": rep,
        "ln2": {"g": rep, "b": rep},
    }
    if cross:
        p.update({"xwq": col, "xwk": col, "xwv": col, "xwo": row,
                  "xbq": vec, "xbk": vec, "xbv": vec,
                  "ln_x": {"g": rep, "b": rep}})
    return p


_ATTENTION = ("wq", "wk", "wv", "wo", "bq", "bk", "bv")


def shardings(params, mesh, cfg: Optional[TransformerConfig] = None):
    """``ccv_tpu``'s placements of ``params`` on ``mesh``, as DTensor
    placements (one per mesh axis) for each leaf: the embeddings and the
    vocabulary projection column blocks on 'model', attention and ffn
    Megatron-style, layer norms and ff2's bias whole. A dimension the
    axis does not divide is replicated (``_fit``); with ``cfg``, so are
    attention weights whose heads do not divide."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.mesh_dim_names
    sizes = {n: mesh.size(i) for i, n in enumerate(names)}
    heads = cfg.heads if cfg is not None else None
    spec: Dict[str, Any] = {}
    for name in ("src_embed", "tgt_embed", "out"):
        if name in params:
            spec[name] = (None, "model")
    for name in ("encoder", "decoder"):
        if name in params:
            spec[name] = [_block_spec(name == "decoder")
                          for _ in params[name]]

    def place(param, s, key):
        # ccv_tpu's _fit: an axis the dimension does not divide is dropped
        # (replicated); attention weights also keep whole heads
        s = tuple(s) + (None,) * (param.ndim - len(s))
        whole_heads = (heads is None or key.lstrip("x") not in _ATTENTION
                       or heads % sizes.get("model", 1) == 0)
        s = tuple(a if a is None or (whole_heads and param.shape[i]
                                     % sizes.get(a, 1) == 0) else None
                  for i, a in enumerate(s))
        return tuple(Shard(s.index(n)) if n in s else Replicate()
                     for n in names)

    def walk(tree, sp, key=""):
        if isinstance(tree, dict):
            return {k: walk(v, sp[k], k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, t) for v, t in zip(tree, sp)]
        return place(tree, sp, key)
    return walk(params, spec)


def shard_params(params, mesh, cfg: Optional[TransformerConfig] = None):
    """This rank's blocks of ``params`` under ``shardings``, leaf tensors
    that require grad (for ``lm_forward(..., tensor=TensorSpec(mesh))``)."""
    from ccv_tpu_torch.nn.optimizers import tree_zip
    from ccv_tpu_torch.parallel.mesh import local_shard

    return _requires_grad(tree_zip(
        lambda p, place: local_shard(p.detach(), mesh, place).clone(),
        params, shardings(params, mesh, cfg)))


@_data.global_batch_loss
def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  label_smoothing: float = 0.0, mask=None) -> torch.Tensor:
    """Token cross entropy with optional smoothing; mask (B,T) True=count.

    Inside ``parallel.data.sharded`` this rank's share of the global mean:
    its sum over the global count of (unmasked) tokens, so the shares add
    up to the one-rank loss."""
    logp = torch.log_softmax(_wide(logits), -1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    if label_smoothing > 0.0:
        nll = (1.0 - label_smoothing) * nll - label_smoothing * logp.mean(-1)
    if mask is not None:
        m = mask.to(logp.dtype)
        return (nll * m).sum() / _data.global_sum(m.sum()).clamp_min(1.0)
    return _data.mean(nll)
