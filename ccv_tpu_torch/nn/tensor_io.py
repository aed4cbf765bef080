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
as CPU tensors. Encoded rows (palettized, or written through
``TensorIoOptions`` hooks) are not read yet.
"""

from __future__ import annotations

import sqlite3
from typing import Dict, List, Union

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


def open_db(path: str) -> sqlite3.Connection:
    conn = sqlite3.connect(path)
    conn.execute(
        "CREATE TABLE IF NOT EXISTS tensors "
        "(name TEXT, type INTEGER, format INTEGER, datatype INTEGER, "
        "dim BLOB, data BLOB, PRIMARY KEY (name))")
    return conn


def tensor_write(conn: sqlite3.Connection, name: str,
                 t: Union[torch.Tensor, np.ndarray],
                 format: int = FORMAT_NHWC) -> None:
    """ccv_nnc_tensor_write twin (raw rows)."""
    t = torch.as_tensor(t).detach().cpu().contiguous()
    if t.dtype not in _DT:
        raise TypeError(f"no ccv datatype for {t.dtype}")
    bits = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    dim = np.zeros(MAX_DIM, np.int32)
    dim[:t.ndim] = t.shape
    conn.execute(
        "REPLACE INTO tensors (name, type, format, datatype, dim, data) "
        "VALUES (?, ?, ?, ?, ?, ?)",
        (name, CPU_MEMORY, format, _DT[t.dtype], dim.tobytes(),
         bits.numpy().tobytes()))


def tensor_read(conn: sqlite3.Connection, name: str) -> torch.Tensor:
    """ccv_nnc_tensor_read twin: a raw row as a CPU tensor."""
    row = conn.execute(
        "SELECT type, format, datatype, dim, data FROM tensors WHERE name=?",
        (name,)).fetchone()
    if row is None:
        raise KeyError(name)
    type_, _fmt, datatype, dim_blob, data = row
    if (type_ >> 32) & 0xFFFFFFFF:
        raise NotImplementedError(
            f"{name}: encoded rows (identifier {type_ >> 32:#x}) are not "
            f"read by the port yet")
    shape = tuple(int(d) for d in np.frombuffer(dim_blob, np.int32) if d > 0)
    dtype = _DT_INV[datatype & 0xFF000]
    bits = np.frombuffer(bytearray(data), dtype=_BITS[dtype]).reshape(shape)
    return torch.from_numpy(bits).view(dtype)


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
