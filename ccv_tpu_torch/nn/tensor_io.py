"""SQLite tensor and model checkpoints (counterpart of
ccv_tpu/nn/tensor_io.py; reference: lib/nnc/ccv_nnc_tensor_io.c,
lib/nnc/ccv_cnnp_model_io.c), the same files both ways.

Schema: ``tensors(name TEXT PRIMARY KEY, type INTEGER, format INTEGER,
datatype INTEGER, dim BLOB(int32[12]), data BLOB)``; the high 32 bits of
``type`` carry an encode identifier (0 = raw). Model checkpoints are rows
named ``__<model>__/<layer index>/<layer name>/<param>`` (and
``.../state/<name>``), as ``ccv_tpu`` writes them.

bfloat16 rows keep their bits: they are read as 16-bit integers and viewed
as ``torch.bfloat16`` (numpy has no bfloat16 of its own). Rows read back
as CPU tensors. ``TensorIoOptions`` carries encode / decode hooks (the
identifier rides in the high 32 bits of ``type``); a row with an identifier
that no hook decodes is palettized (``nn/palettize.py``). ``ExternalStore``
is such a hook pair: payloads in a side file, (offset, size) in the row,
read back as memory-mapped views; ``tensor_new_from_file`` maps a raw
tensor file.
"""

from __future__ import annotations

import dataclasses
import os
import sqlite3
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

MAX_DIM = 12  # CCV_NNC_MAX_DIM_ALLOC (ccv_nnc_tfb.h:76)
FORMAT_NCHW = 0x01
FORMAT_NHWC = 0x02
FORMAT_CHWN = 0x04
CPU_MEMORY = 0x1

# ccv datatype tags (lib/ccv.h:45) by torch type, and the numpy type that
# holds the bits of each
_DT = {torch.float32: 0x04000, torch.int32: 0x02000, torch.float64: 0x10000,
       torch.int64: 0x08000, torch.uint8: 0x01000, torch.float16: 0x20000,
       torch.bfloat16: 0x80000}
_DT_INV = {v: k for k, v in _DT.items()}
_BITS = {torch.float32: np.float32, torch.int32: np.int32,
         torch.float64: np.float64, torch.int64: np.int64,
         torch.uint8: np.uint8, torch.float16: np.float16,
         torch.bfloat16: np.int16}


def _bits_dtype(tag: int) -> Tuple[torch.dtype, np.dtype]:
    """(torch type, numpy type of its bits) of a ccv datatype tag."""
    dtype = _DT_INV[tag & 0xFF000]
    return dtype, np.dtype(_BITS[dtype])


def _from_bits(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(a).view(dtype)


def open_db(path: str) -> sqlite3.Connection:
    conn = sqlite3.connect(path)
    conn.execute(
        "CREATE TABLE IF NOT EXISTS tensors "
        "(name TEXT, type INTEGER, format INTEGER, datatype INTEGER, "
        "dim BLOB, data BLOB, PRIMARY KEY (name))")
    return conn


@dataclasses.dataclass
class TensorIoOptions:
    """ccv_nnc_tensor_io_option_t twin (ccv_nnc.h:674-699): encode / decode
    hooks on tensor rows (encryption, compression, external storage).

    encode(name, data: bytes, datatype: int, shape) -> (encoded bytes,
        identifier) or None to store the row raw;
    decode(name, data: bytes, datatype: int, shape, identifier) -> a
        tensor (or numpy array), or None to fall through to the raw and
        palettized readers.
    Identifier 0 means unencoded; it rides in the high 32 bits of ``type``.
    """

    encode: Optional[Callable] = None
    decode: Optional[Callable] = None


def tensor_write(conn: sqlite3.Connection, name: str,
                 t: Union[torch.Tensor, np.ndarray],
                 format: int = FORMAT_NHWC,
                 options: Optional[TensorIoOptions] = None) -> None:
    """ccv_nnc_tensor_write twin: the tensor's bytes, or what
    ``options.encode`` makes of them."""
    t = torch.as_tensor(t).detach().cpu().contiguous()
    if t.dtype not in _DT:
        raise TypeError(f"no ccv datatype for {t.dtype}")
    bits = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    dim = np.zeros(MAX_DIM, np.int32)
    dim[:t.ndim] = t.shape
    data, type_ = bits.numpy().tobytes(), CPU_MEMORY
    if options is not None and options.encode is not None:
        enc = options.encode(name, data, _DT[t.dtype], tuple(t.shape))
        if enc is not None:
            data, identifier = enc
            type_ = CPU_MEMORY | (int(identifier) << 32)
    conn.execute(
        "REPLACE INTO tensors (name, type, format, datatype, dim, data) "
        "VALUES (?, ?, ?, ?, ?, ?)",
        (name, type_, format, _DT[t.dtype], dim.tobytes(), data))


def tensor_read(conn: sqlite3.Connection, name: str,
                options: Optional[TensorIoOptions] = None) -> torch.Tensor:
    """ccv_nnc_tensor_read twin: a raw, hook-decoded or palettized row as
    a CPU tensor."""
    row = conn.execute(
        "SELECT type, format, datatype, dim, data FROM tensors WHERE name=?",
        (name,)).fetchone()
    if row is None:
        raise KeyError(name)
    type_, _fmt, datatype, dim_blob, data = row
    identifier = (type_ >> 32) & 0xFFFFFFFF
    shape = tuple(int(d) for d in np.frombuffer(dim_blob, np.int32) if d > 0)
    tag = datatype & 0xFFFFFFFF
    dtype, bits = _bits_dtype(tag)
    if options is not None and options.decode is not None:
        out = options.decode(name, data, tag, shape, identifier)
        if out is not None:
            return out if isinstance(out, torch.Tensor) \
                else torch.from_numpy(np.asarray(out))
    if identifier != 0:
        from ccv_tpu_torch.nn import palettize

        return torch.from_numpy(palettize.decode(data, tag, shape,
                                                 identifier))
    return _from_bits(np.frombuffer(bytearray(data), bits).reshape(shape),
                      dtype)


def tensor_new_from_file(path: str, datatype, shape,
                         offset: int = 0) -> torch.Tensor:
    """ccv_nnc_tensor_new_from_file twin (ccv_nnc.h:587): a CPU tensor over
    a memory map of a raw tensor file (copy-on-write: writes stay in this
    process). ``datatype`` is a torch type or a ccv tag."""
    if isinstance(datatype, int):
        dtype, bits = _bits_dtype(datatype)
    else:
        dtype, bits = datatype, np.dtype(_BITS[datatype])
    mm = np.memmap(path, dtype=bits, mode="c", offset=offset,
                   shape=tuple(shape))
    return _from_bits(mm, dtype)


EXTERNAL_STORE_ID = 0x8a0e5    # identifier of side-file rows, as ccv_tpu's


class ExternalStore:
    """External-store hook pair: tensor payloads are appended to a side
    file, and the row carries only (offset, size) as int64; reads are
    memory-mapped views of the file (the loading path for big checkpoints).
    The same rows and side file as ``ccv_tpu``'s.

        store = ExternalStore(path + '.bin')
        tensor_write(conn, name, t, options=store.options())
        t = tensor_read(conn, name, options=store.options())
    """

    def __init__(self, path: str):
        self.path = path

    def options(self) -> TensorIoOptions:
        return TensorIoOptions(encode=self._encode, decode=self._decode)

    def _encode(self, name, data: bytes, tag, shape) -> Tuple[bytes, int]:
        mode = "r+b" if os.path.exists(self.path) else "wb"
        with open(self.path, mode) as f:
            f.seek(0, os.SEEK_END)
            off = f.tell()
            f.write(data)
        return (np.array([off, len(data)], np.int64).tobytes(),
                EXTERNAL_STORE_ID)

    def _decode(self, name, data: bytes, tag, shape, identifier):
        if identifier != EXTERNAL_STORE_ID:
            return None
        off, size = (int(v) for v in np.frombuffer(data, np.int64))
        dtype, bits = _bits_dtype(tag)
        mm = np.memmap(self.path, dtype=bits, mode="c", offset=off,
                       shape=(size // bits.itemsize,))
        return _from_bits(mm, dtype).reshape(shape)


def list_tensors(conn: sqlite3.Connection) -> List[str]:
    return [r[0] for r in conn.execute("SELECT name FROM tensors ORDER BY name")]


# -- model checkpoints -------------------------------------------------------

def _flatten_params(model) -> Dict[str, torch.Tensor]:
    out = {}
    for i, (layer, p) in enumerate(zip(model.layers, model.params)):
        for k, v in p.items():
            out[f"/{i}/{layer.name}/{k}"] = v
    for i, (layer, s) in enumerate(zip(model.layers, model.state)):
        for k, v in s.items():
            out[f"/{i}/{layer.name}/state/{k}"] = v
    return out


def write_model(model, path: str, name: str) -> None:
    conn = open_db(path)
    with conn:
        for key, t in _flatten_params(model).items():
            tensor_write(conn, f"__{name}__{key}", t)
    conn.close()


def read_model(model, path: str, name: str) -> None:
    """Each parameter and state tensor of ``model`` (built) from its row,
    reshaped to the parameter's shape, on its device; a missing parameter
    row raises KeyError, a missing state row keeps the state."""
    conn = sqlite3.connect(path)
    try:
        prefix = f"__{name}__"
        for i, layer in enumerate(model.layers):
            for k, old in list(model.params[i].items()):
                t = tensor_read(conn, f"{prefix}/{i}/{layer.name}/{k}")
                model.params[i][k] = t.reshape(old.shape).to(old.device)
            for k, old in list(model.state[i].items()):
                try:
                    t = tensor_read(conn,
                                    f"{prefix}/{i}/{layer.name}/state/{k}")
                except KeyError:
                    continue
                model.state[i][k] = t.to(old.device)
    finally:
        conn.close()
