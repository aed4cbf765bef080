"""Sequence parallelism: ring attention (counterpart of
ccv_tpu/parallel/sequence.py; the reference has no long-context story).

Each rank of the mesh's sequence axis holds its T/n slice of q, k and v.
The k and v blocks go round the ring (``mesh.ppermute`` to the next rank,
n - 1 times), and each rank merges every block's attention into its own
queries with the online-softmax rule, so no rank holds more than its slice
of k and v or a (T/n, T/n) score tile. Causal masks compare absolute
positions (a rank's slice starts at rank x T/n); masked scores are -1e30
and the final row sums are clamped to 1e-30, as in ``ccv_tpu``.

The blocks are float32 einsums (float64 for float64 inputs), as
``ccv_tpu``'s (outside any Pallas kernel): the flash kernels do not run
inside the ring. Differentiable: the ring's backward sends the k and v
gradients back round the ring.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from ccv_tpu_torch.parallel import mesh as _mesh


def _block_attend(q, k, v, scale: float, q_off: int, k_off: int,
                  causal: bool):
    """The online-softmax statistics (row max m, row sum l, unnormalised
    accumulator acc) of a q slice against one k / v block; q, k, v (B, T,
    H, D), offsets absolute positions."""
    wide = torch.promote_types(q.dtype, torch.float32)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(wide), k.to(wide)) * scale
    tq, tk = q.shape[1], k.shape[1]
    if causal:
        q_pos = q_off + torch.arange(tq, device=q.device)[:, None]
        k_pos = k_off + torch.arange(tk, device=q.device)[None, :]
        s = torch.where(k_pos <= q_pos, s, torch.full_like(s, -1e30))
    m = s.amax(-1, keepdim=True)                        # (B, H, Tq, 1)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    acc = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).to(wide),
                       v.to(wide))
    return m, l, acc


def _merge(m, l, acc, mb, lb, accb):
    m_new = torch.maximum(m, mb)
    c_old, c_new = torch.exp(m - m_new), torch.exp(mb - m_new)
    return m_new, l * c_old + lb * c_new, acc * c_old + accb * c_new


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh: DeviceMesh, seq_axis: str = "seq",
                   scale: Optional[float] = None,
                   is_causal: bool = False) -> torch.Tensor:
    """Attention of this rank's (B, T/n, H, D) slice of q over the whole
    sequence, k and v given as this rank's slices too; returns (B, T/n, H,
    D) in q's type. n is the size of ``mesh``'s ``seq_axis`` (from the mesh
    passed in, never from a name alone)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    group = mesh.get_group(seq_axis)
    n = mesh.size(mesh.mesh_dim_names.index(seq_axis))
    idx = mesh.get_local_rank(seq_axis)
    B, t_local, H, D = q.shape
    wide = torch.promote_types(q.dtype, torch.float32)
    m = torch.full((B, H, t_local, 1), -1e30, dtype=wide, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, H, t_local, D), dtype=wide, device=q.device)
    kv = torch.stack([k, v])
    ring = [(i, (i + 1) % n) for i in range(n)]
    for step in range(n):
        src = (idx - step) % n          # whose k / v block this rank holds
        m, l, acc = _merge(m, l, acc, *_block_attend(
            q, kv[0], kv[1], scale, idx * t_local, src * t_local, is_causal))
        if step != n - 1:
            kv = _mesh.ppermute(kv, group, ring)
    out = acc / torch.clamp(l, min=1e-30)
    return out.permute(0, 2, 1, 3).to(q.dtype)
