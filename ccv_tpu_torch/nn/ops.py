"""Neural-network ops of the port (counterpart of ccv_tpu/nn/ops.py).

Only scaled-dot-product attention so far: it is the reference the flash
kernels (ccv_tpu_torch/ops/kernels/flash_attention.py) are held to.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def scaled_dot_product_attention(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor,
                                 scale: Optional[float] = None,
                                 is_causal: bool = False, mask=None,
                                 bias=None) -> torch.Tensor:
    """CCV_NNC_SCALED_DOT_PRODUCT_ATTENTION_FORWARD on (B, T, H, D).

    Scores are input-type products summed in float32 (JAX's
    ``preferred_element_type=float32``); the causal mask is aligned
    bottom-right, ``tril(ones(Tq, Tk), Tk - Tq)``, masked scores are -inf;
    the probabilities are cast to v's type before the second product and
    the output to q's type. ``mask`` broadcasts against the (B, H, Tq, Tk)
    scores, True = keep."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias
    if is_causal:
        tq, tk = logits.shape[-2], logits.shape[-1]
        causal = torch.ones(tq, tk, dtype=torch.bool,
                            device=q.device).tril(tk - tq)
        logits = logits.masked_fill(~causal, -math.inf)
    if mask is not None:
        logits = logits.masked_fill(~mask, -math.inf)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(q.dtype)
