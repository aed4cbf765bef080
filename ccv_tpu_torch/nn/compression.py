"""LSSC activation compression and memory reduction (counterpart of
ccv_tpu/nn/compression.py; reference: lib/nnc/cmd/compression/
ccv_nnc_lssc_cpu_ref.c, ccv_nnc_symbolic_graph_memory_compression.c and
ccv_nnc_symbolic_graph_memory_reduction.c).

LSSC packs each 4x4 spatial block of an activation into two float16
endpoints and 16 2-bit level indices (4:1 against float16). The
quantisation is the reference kernel's: levels [lo, 2/3 lo + 1/3 hi,
1/3 lo + 2/3 hi, hi], index trunc((x - (7/6 lo - 1/6 hi)) * 3 / max(hi -
lo, 1e-6)) clamped to [0, 3].

``compressed_apply`` wraps a layer's apply in a ``torch.autograd.Function``
that saves the compressed input and, in the backward pass, recomputes the
layer on the decompressed (lossy) input for its gradients, as the
reference inserts compress / decompress nodes around the backward;
``reduced_apply`` does the same with a bfloat16 copy of a float32 input;
``checkpointed_apply`` (gradient checkpointing) keeps nothing and
recomputes through ``torch.utils.checkpoint``. The forward outputs are
exact. Every recompute replays the forward's random draws: it runs on a
fresh generator set to the state the forward's generator had before the
layer (``generator_replay``), as ``ccv_tpu`` hands both passes the same
key, so a ``Dropout`` inside draws the same mask. The divisions go through
``ops.ewdiv``, so the card's codes equal the CPU's.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.utils.checkpoint

from ccv_tpu_torch.nn.ops import ewdiv

_SHIFTS = torch.arange(16, dtype=torch.int64) * 2


def _edge_pad(x: torch.Tensor, axis: int, hi: int) -> torch.Tensor:
    n = x.shape[axis]
    idx = torch.arange(n + hi, device=x.device).clamp(max=n - 1)
    return torch.index_select(x, axis, idx)


def _block4(x: torch.Tensor) -> torch.Tensor:
    """(..., H, W, C) -> (..., Hb, Wb, C, 16), row-major in the block; H
    and W are edge-padded to multiples of 4 (those lanes are never read
    back, and edge values leave the block's range unchanged)."""
    H, W = x.shape[-3], x.shape[-2]
    if H % 4:
        x = _edge_pad(x, x.ndim - 3, -H % 4)
    if W % 4:
        x = _edge_pad(x, x.ndim - 2, -W % 4)
    Hp, Wp, C = x.shape[-3:]
    lead = x.shape[:-3]
    n = len(lead)
    x = x.reshape(*lead, Hp // 4, 4, Wp // 4, 4, C)
    x = x.permute(*range(n), n, n + 2, n + 4, n + 1, n + 3)
    return x.reshape(*x.shape[:-2], 16)


def lssc_compress(x: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(lo, hi, idx) of (..., H, W, C) ``x``: float16 endpoints of each 4x4
    block and its 16 2-bit indices packed into one 32-bit word (int32 with
    the bits of ``ccv_tpu``'s uint32)."""
    blocks = _block4(x.float())
    lo16 = blocks.amin(dim=-1).to(torch.float16)
    hi16 = blocks.amax(dim=-1).to(torch.float16)
    lo32, hi32 = lo16.float(), hi16.float()
    abottom = lo32 * (7.0 / 6.0) - ewdiv(hi32, 6.0)
    ascale = ewdiv(3.0, torch.clamp(hi32 - lo32, min=1e-6))
    q = ((blocks - abottom[..., None]) * ascale[..., None]).to(
        torch.int32).clamp(0, 3).to(torch.int64)
    word = (q << _SHIFTS.to(x.device)).sum(dim=-1)
    idx = torch.where(word >= 1 << 31, word - (1 << 32), word).to(torch.int32)
    return lo16, hi16, idx


def lssc_decompress(lo: torch.Tensor, hi: torch.Tensor, idx: torch.Tensor,
                    shape) -> torch.Tensor:
    """Inverse of ``lssc_compress`` back to ``shape`` (..., H, W, C), in
    float32 (values on the float16 grid)."""
    lo32, hi32 = lo.float(), hi.float()
    levels = torch.stack([lo32, lo32 * (2.0 / 3.0) + ewdiv(hi32, 3.0),
                          ewdiv(lo32, 3.0) + hi32 * (2.0 / 3.0), hi32], dim=-1)
    levels = levels.to(torch.float16).float()
    word = idx.to(torch.int64) & 0xFFFFFFFF
    q = (word[..., None] >> _SHIFTS.to(idx.device)) & 3
    vals = torch.gather(levels, -1, q)                       # (..., 16)
    lead = vals.shape[:-4]
    n = len(lead)
    Hb, Wb, C = vals.shape[-4], vals.shape[-3], vals.shape[-2]
    v = vals.reshape(*lead, Hb, Wb, C, 4, 4)
    v = v.permute(*range(n), n, n + 3, n + 1, n + 4, n + 2)
    v = v.reshape(*lead, Hb * 4, Wb * 4, C)
    H, W = shape[-3], shape[-2]
    return v[..., :H, :W, :].contiguous()


def generator_replay(generator: Optional[torch.Generator]
                     ) -> Callable[[], Optional[torch.Generator]]:
    """A function that returns a new generator on ``generator``'s device at
    the state ``generator`` has now, each call (None for None)."""
    if generator is None:
        return lambda: None
    state = generator.get_state()

    def fresh() -> torch.Generator:
        g = torch.Generator(device=generator.device)
        g.set_state(state)
        return g

    return fresh


class _Recomputed(torch.autograd.Function):
    """y = run(params, x, generator); the backward recomputes the apply on
    ``restore(saved)`` with a replay of the forward's generator, for the
    gradients of x and of the parameters."""

    @staticmethod
    def forward(ctx, run, replay, save, restore, keys, x, *pvals):
        with torch.no_grad():
            y = run(dict(zip(keys, pvals)), x, None)
        ctx.run, ctx.replay, ctx.restore, ctx.keys = run, replay, restore, keys
        ctx.x_meta = (x.shape, x.dtype)
        saved = save(x)
        ctx.n_saved = len(saved)
        ctx.save_for_backward(*saved, *pvals)
        return y

    @staticmethod
    def backward(ctx, g):
        tensors = ctx.saved_tensors
        saved, pvals = tensors[:ctx.n_saved], tensors[ctx.n_saved:]
        shape, dtype = ctx.x_meta
        with torch.enable_grad():
            x = ctx.restore(saved, shape).to(dtype).detach().requires_grad_()
            ps = [p.detach().requires_grad_(p.is_floating_point())
                  for p in pvals]
            y = ctx.run(dict(zip(ctx.keys, ps)), x, ctx.replay())
            wrt = [x] + [p for p in ps if p.requires_grad]
            grads = iter(torch.autograd.grad(y, wrt, g, allow_unused=True))
        dx = next(grads)
        dps = [next(grads) if p.requires_grad else None for p in ps]
        return (None, None, None, None, None, dx, *dps)


def _recomputed(apply_fn, training: bool, save, restore):
    def wrapped(params, state, x, generator=None):
        holder = {}
        replay = generator_replay(generator)

        def run(p, v, gen):
            # the forward draws from the model's generator, a recompute
            # from a replay of it
            y, holder["state"] = apply_fn(p, state, v, training,
                                          generator if gen is None else gen)
            return y

        keys = tuple(params)
        y = _Recomputed.apply(run, replay, save, restore, keys, x,
                              *(params[k] for k in keys))
        return y, holder["state"]

    return wrapped


def compressed_apply(apply_fn, shape, dtype, training: bool):
    """A layer apply ``(params, state, x, generator) -> (y, state)`` whose
    saved activation is LSSC-compressed; the backward runs on the
    decompressed input cast to ``dtype`` (``shape`` is x's)."""
    return _recomputed(
        apply_fn, training, lambda x: lssc_compress(x),
        lambda saved, s: lssc_decompress(*saved, shape).to(dtype))


def reduced_apply(apply_fn, dtype, training: bool):
    """A layer apply whose saved activation is a bfloat16 copy, converted
    back to ``dtype`` for the backward."""
    return _recomputed(apply_fn, training,
                       lambda x: (x.to(torch.bfloat16),),
                       lambda saved, s: saved[0].to(dtype))


def checkpointed_apply(apply_fn):
    """A layer apply ``(params, state, x, training, generator)`` under
    gradient checkpointing (ccv_cnnp_model_set_gradient_checkpointing,
    ``ccv_tpu``'s ``jax.checkpoint``): ``torch.utils.checkpoint`` with
    ``use_reentrant=False`` saves no activation of the layer and runs it
    again in the backward, the recompute drawing from a replay of the
    forward's generator."""
    def wrapped(params, state, x, training=False, generator=None):
        replay = generator_replay(generator)
        calls = [0]

        def run(p, s, v):
            gen = generator if calls[0] == 0 else replay()
            calls[0] += 1
            return apply_fn(p, s, v, training, gen)

        return torch.utils.checkpoint.checkpoint(run, params, state, x,
                                                 use_reentrant=False)

    return wrapped
