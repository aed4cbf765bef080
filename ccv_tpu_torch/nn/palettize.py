"""Palette weight quantization (counterpart of ccv_tpu/nn/palettize.py;
reference: lib/nnc/ccv_nnc_palettize.c:9).

Wire format per block of ``number_in_blocks`` elements: a palette of
2^qbits centroids in the source type (optimal 1-D k-means,
``core.numeric.kmeans1d``), then the bit-packed indices (4 bits: two a byte,
high nibble first; 8 bits: one a byte; 5-7 bits: groups of 8 indices in
qbits bytes, big-endian). qbits in {4, 5, 6, 7, 8}.

Encoding and ``depalettize`` run on the host in numpy, as ``ccv_tpu``'s;
``depalettize_device`` decodes the byte stream with torch ops on the
tensors' device (the role of the reference's depalettize CUDA kernel,
cmd/compression/gpu/ccv_nnc_depalettize.cu): the palettes are bit views
of the stream, the indices come out by static shifts (every index spans at
most two bytes), and one gather per block gives the values.
"""

from __future__ import annotations

import numpy as np
import torch

from ccv_tpu_torch import device as _device
from ccv_tpu_torch.core.numeric import kmeans1d

_DT_SIZE = {0x20000: 2, 0x04000: 4, 0x10000: 8}  # 16F, 32F, 64F
_DT_NP = {0x20000: np.float16, 0x04000: np.float32, 0x10000: np.float64}
_DT_TORCH = {0x20000: torch.float16, 0x04000: torch.float32,
             0x10000: torch.float64}


def _index_bytes(qbits: int, n: int) -> int:
    """Bytes of the packed indices of a block of n elements."""
    if qbits == 4:
        return (n + 1) // 2
    if qbits == 8:
        return n
    return (n + 7) // 8 * qbits


def _pack_bits(indices: np.ndarray, qbits: int) -> np.ndarray:
    if qbits == 8:
        return indices.astype(np.uint8)
    if qbits == 4:
        if len(indices) % 2:
            indices = np.concatenate([indices, [0]])
        pairs = indices.reshape(-1, 2).astype(np.uint8)
        return (pairs[:, 0] << 4) | pairs[:, 1]
    pad = (-len(indices)) % 8
    idx = np.concatenate([indices, np.zeros(pad, indices.dtype)]).astype(
        np.uint64)
    groups = idx.reshape(-1, 8)
    big = np.zeros(len(groups), dtype=np.uint64)
    for j in range(8):
        big = (big << np.uint64(qbits)) | groups[:, j]
    out = np.zeros((len(groups), qbits), np.uint8)
    for b in range(qbits):
        shift = np.uint64(8 * (qbits - 1 - b))
        out[:, b] = ((big >> shift) & np.uint64(0xFF)).astype(np.uint8)
    return out.reshape(-1)


def _unpack_bits(data: np.ndarray, qbits: int, n: int) -> np.ndarray:
    if qbits == 8:
        return data[:n].astype(np.int32)
    if qbits == 4:
        out = np.empty(len(data) * 2, np.int32)
        out[0::2] = data >> 4
        out[1::2] = data & 0xF
        return out[:n]
    groups = data.reshape(-1, qbits).astype(np.uint64)
    big = np.zeros(len(groups), np.uint64)
    for b in range(qbits):
        big = (big << np.uint64(8)) | groups[:, b]
    out = np.zeros((len(groups), 8), np.int32)
    mask = np.uint64((1 << qbits) - 1)
    for j in range(8):
        shift = np.uint64(qbits * (8 - 1 - j))
        out[:, j] = ((big >> shift) & mask).astype(np.int32)
    return out.reshape(-1)[:n]


def palettize(arr, qbits: int = 4, number_in_blocks: int = 512) -> bytes:
    """ccv_nnc_palettize twin: the encoded byte stream of ``arr`` (a numpy
    array or a tensor of float16, float32 or float64)."""
    if qbits not in (4, 5, 6, 7, 8):
        raise ValueError(f"qbits {qbits}: 4 to 8")
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    flat = np.asarray(arr).reshape(-1)
    k = 1 << qbits
    out = bytearray()
    for start in range(0, len(flat), number_in_blocks):
        block = flat[start:start + number_in_blocks].astype(np.float64)
        uniq = np.unique(block)
        if len(uniq) <= k:
            # few values: the palette is them, zero-padded
            centroids = np.zeros(k)
            centroids[:len(uniq)] = uniq
            indices = np.searchsorted(uniq, block).astype(np.int32)
        else:
            indices, centroids = kmeans1d(block, k)
        out += centroids.astype(flat.dtype).tobytes()
        out += _pack_bits(indices, qbits).tobytes()
    return bytes(out)


def depalettize(data: bytes, datatype: int, n_elements: int, qbits: int,
                number_in_blocks: int) -> np.ndarray:
    """ccv_nnc_depalettize twin on the host: n_elements values (numpy)."""
    dt = _DT_NP[datatype & 0xFF000]
    esize = _DT_SIZE[datatype & 0xFF000]
    k = 1 << qbits
    block_bytes = k * esize + _index_bytes(qbits, number_in_blocks)
    raw = np.frombuffer(data, np.uint8)
    out = np.empty(n_elements, dt)
    pos = 0
    for start in range(0, n_elements, number_in_blocks):
        n = min(number_in_blocks, n_elements - start)
        pal = raw[pos:pos + k * esize].view(dt)
        packed = raw[pos + k * esize:pos + k * esize + _index_bytes(qbits, n)]
        out[start:start + n] = pal[_unpack_bits(packed, qbits, n)]
        pos += block_bytes
    return out


def encode_identifier(qbits: int, number_in_blocks: int) -> int:
    """The row identifier of a palettized tensor, ``ccv_tpu``'s scheme:
    (qbits << 16) | number_in_blocks."""
    return (qbits << 16) | number_in_blocks


def decode(data: bytes, datatype: int, shape, identifier: int) -> np.ndarray:
    """A palettized row's values in ``shape`` (host)."""
    qbits = (identifier >> 16) & 0xFF
    nib = identifier & 0xFFFF
    n = int(np.prod(shape))
    return depalettize(data, datatype, n, qbits, nib).reshape(shape)


def depalettize_device(data, datatype: int, n_elements: int, qbits: int,
                       number_in_blocks: int,
                       device: _device.DeviceLike = None) -> torch.Tensor:
    """ccv_nnc_depalettize on ``device`` (default: the device of ``data``
    if it is a tensor, else the card): ``data`` is the encoded stream as
    bytes or a uint8 tensor; returns n_elements values there, equal to
    ``depalettize``'s."""
    like = data if isinstance(data, torch.Tensor) else None
    dev = _device.resolve(device, like)
    if isinstance(data, torch.Tensor):
        raw = data.to(dev, torch.uint8).reshape(-1)
    else:
        raw = torch.frombuffer(bytearray(data), dtype=torch.uint8).to(dev)
    tag = datatype & 0xFF000
    esize, dtype = _DT_SIZE[tag], _DT_TORCH[tag]
    k, nib = 1 << qbits, number_in_blocks
    block_bytes = k * esize + _index_bytes(qbits, nib)
    nblocks = -(-n_elements // nib)
    pad = nblocks * block_bytes - raw.numel()
    if pad > 0:  # the last block's packed indices may stop short
        raw = torch.cat([raw, raw.new_zeros(pad)])
    blocks = raw[:nblocks * block_bytes].reshape(nblocks, block_bytes)
    pal = blocks[:, :k * esize].contiguous().view(dtype)      # (nblocks, k)
    packed = blocks[:, k * esize:].to(torch.int32)
    if qbits == 8:
        idx = packed
    elif qbits == 4:
        idx = torch.stack([packed >> 4, packed & 0xF], dim=-1).reshape(
            nblocks, nib)
    else:
        # index j of a group of 8 starts at bit j * qbits of its qbits
        # bytes; read it from the 16 bits of its first byte and the next
        # (a zero byte closes the group)
        g = packed.reshape(nblocks, nib // 8, qbits)
        g = torch.cat([g, g.new_zeros(nblocks, nib // 8, 1)], dim=-1)
        mask = (1 << qbits) - 1
        outs = []
        for j in range(8):
            b0, sh = divmod(j * qbits, 8)
            v = (g[..., b0] << 8) | g[..., b0 + 1]
            outs.append((v >> (16 - qbits - sh)) & mask)
        idx = torch.stack(outs, dim=-1).reshape(nblocks, nib)
    return torch.gather(pal, 1, idx.long()).reshape(-1)[:n_elements]
