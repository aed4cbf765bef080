"""Port parity: ccv_tpu_torch/nn/palettize.py and the encoded rows of
ccv_tpu_torch/nn/tensor_io.py against ccv_tpu's, on the CPU.

- ``palettize``'s bytes equal ``ccv_tpu``'s (4-8 bits, float16 / 32 / 64,
  a partial last block, blocks with few distinct values);
- the reference-encoded goldens ``tests/data/palettize_{f32_q4,f32_q5,
  f16_q8}.bin`` (tests/data/gen/gen_palettize.c) decode equal to the C
  output, by ``depalettize`` and by ``depalettize_device`` (on the card
  in the cuda-marked test);
- rows: palettized and hook-encoded rows written by either package read
  by the other, ``ExternalStore`` side files both ways, and
  ``tensor_new_from_file``'s map of a raw file.
All comparisons are exact.
"""

import os
import sqlite3
import struct

import numpy as np
import pytest
import torch

from ccv_tpu.nn import palettize as jpal
from ccv_tpu.nn import tensor_io as jtio
from ccv_tpu_torch.nn import palettize as tpal
from ccv_tpu_torch.nn import tensor_io as ttio

DATA = os.path.join(os.path.dirname(__file__), "data")
GOLDENS = ["palettize_f32_q4.bin", "palettize_f32_q5.bin",
           "palettize_f16_q8.bin"]
DT_NP = {0x20000: np.float16, 0x04000: np.float32, 0x10000: np.float64}
TAG = {np.float16: 0x20000, np.float32: 0x04000, np.float64: 0x10000}


def _golden(name):
    raw = open(os.path.join(DATA, name), "rb").read()
    datatype, qbits, nb, n = struct.unpack("<4i", raw[:16])
    (sz,) = struct.unpack("<q", raw[16:24])
    comp = raw[24:24 + sz]
    ref = np.frombuffer(raw[24 + sz:], DT_NP[datatype])
    assert len(ref) == n
    return datatype, qbits, nb, n, comp, ref


@pytest.mark.parametrize("name", GOLDENS)
def test_goldens_decode_equal(name):
    datatype, qbits, nb, n, comp, ref = _golden(name)
    np.testing.assert_array_equal(
        tpal.depalettize(comp, datatype, n, qbits, nb), ref)
    dev = tpal.depalettize_device(comp, datatype, n, qbits, nb,
                                  device="cpu")
    assert dev.dtype == torch.from_numpy(ref[:1].copy()).dtype
    np.testing.assert_array_equal(dev.numpy(), ref)
    t = torch.frombuffer(bytearray(comp), dtype=torch.uint8)
    np.testing.assert_array_equal(
        tpal.depalettize_device(t, datatype, n, qbits, nb).numpy(), ref)


CASES = [(np.float32, 4, 512, 1500), (np.float32, 5, 512, 1100)] + [
    (np.float32, q, 512, 520) for q in (6, 7, 8)] + [
    (np.float16, 4, 256, 700), (np.float16, 8, 128, 300),
    (np.float64, 6, 64, 200), (np.float32, 4, 64, 64)]


@pytest.mark.parametrize("dt,qbits,nb,n", CASES)
def test_palettize_bytes_equal(dt, qbits, nb, n):
    rng = np.random.default_rng(qbits * 7 + n)
    x = (rng.standard_normal(n) * 2).astype(dt)
    x[:nb // 2] = np.round(x[:nb // 2])  # a block of few distinct values
    enc = tpal.palettize(x, qbits, nb)
    assert enc == jpal.palettize(x, qbits, nb)
    if qbits == 4:
        assert enc == tpal.palettize(torch.from_numpy(x), qbits, nb)
    tag = TAG[dt]
    want = jpal.depalettize(enc, tag, n, qbits, nb)
    np.testing.assert_array_equal(tpal.depalettize(enc, tag, n, qbits, nb),
                                  want)
    np.testing.assert_array_equal(
        tpal.depalettize_device(enc, tag, n, qbits, nb, device="cpu")
        .numpy(), want)
    ident = tpal.encode_identifier(qbits, nb)
    assert ident == jpal.encode_identifier(qbits, nb)
    np.testing.assert_array_equal(
        tpal.decode(enc, tag, (n,), ident), jpal.decode(enc, tag, (n,), ident))


def _palettizer(pal, qbits=5, nb=128):
    def encode(name, data, tag, shape):
        arr = np.frombuffer(data, DT_NP[tag])
        return pal.palettize(arr, qbits, nb), pal.encode_identifier(qbits, nb)
    return encode


def test_encoded_rows_cross_packages(tmp_path):
    """A palettized row and raw rows written by ccv_tpu read by the port,
    and the port's by ccv_tpu; the identifier in the high bits of type."""
    x = np.random.default_rng(3).standard_normal((12, 40)).astype(np.float32)
    for writer, reader in (("j", "t"), ("t", "j")):
        path = str(tmp_path / f"{writer}.sqlite3")
        conn = (jtio if writer == "j" else ttio).open_db(path)
        mod, pal = (jtio, jpal) if writer == "j" else (ttio, tpal)
        opts = mod.TensorIoOptions(encode=_palettizer(pal))
        mod.tensor_write(conn, "pal", x, options=opts)
        mod.tensor_write(conn, "raw", x)
        conn.commit()
        (type_,) = conn.execute(
            "SELECT type FROM tensors WHERE name='pal'").fetchone()
        assert type_ >> 32 == tpal.encode_identifier(5, 128)
        conn.close()
        conn = sqlite3.connect(path)
        if reader == "t":
            got = ttio.tensor_read(conn, "pal").numpy()
            raw = ttio.tensor_read(conn, "raw").numpy()
        else:
            got = jtio.tensor_read(conn, "pal")
            raw = jtio.tensor_read(conn, "raw")
        conn.close()
        want = jpal.decode(jpal.palettize(x, 5, 128), 0x04000, x.shape,
                           tpal.encode_identifier(5, 128))
        np.testing.assert_array_equal(np.asarray(got), want)
        np.testing.assert_array_equal(np.asarray(raw), x)


def test_decode_hook_wins_and_falls_through(tmp_path):
    path = str(tmp_path / "h.sqlite3")
    conn = ttio.open_db(path)
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    xor = ttio.TensorIoOptions(
        encode=lambda n, d, t, s: (bytes(b ^ 0x5A for b in d), 7),
        decode=lambda n, d, t, s, i: None if i != 7 else np.frombuffer(
            bytes(b ^ 0x5A for b in d), np.float32).reshape(s))
    ttio.tensor_write(conn, "x", x, options=xor)
    ttio.tensor_write(conn, "y", x)
    assert torch.equal(ttio.tensor_read(conn, "x", options=xor), x)
    assert torch.equal(ttio.tensor_read(conn, "y", options=xor), x)
    jx = jtio.tensor_read(conn, "x", options=jtio.TensorIoOptions(
        decode=xor.decode))
    np.testing.assert_array_equal(np.asarray(jx), x.numpy())
    conn.close()


@pytest.mark.parametrize("dtype", ["float32", "int32", "bfloat16"])
def test_external_store_cross_packages(tmp_path, dtype):
    """Rows with (offset, size) into a side file: written by either package,
    read by the other, several tensors appended to one file."""
    import jax.numpy as jnp

    rng = np.random.default_rng(4)
    xs = [(rng.standard_normal(s) * 9).astype(np.float32) for s in
          ((3, 5), (7,), (2, 2, 2))]
    jxs = [np.asarray(jnp.asarray(x, getattr(jnp, dtype))) for x in xs]
    txs = [torch.from_numpy(x).to(getattr(torch, dtype)) for x in xs]
    for writer in ("j", "t"):
        path = str(tmp_path / f"{writer}.sqlite3")
        side = path + ".bin"
        if writer == "j":
            conn, store = jtio.open_db(path), jtio.ExternalStore(side)
            for i, x in enumerate(jxs):
                jtio.tensor_write(conn, f"x{i}", x, options=store.options())
        else:
            conn, store = ttio.open_db(path), ttio.ExternalStore(side)
            for i, x in enumerate(txs):
                ttio.tensor_write(conn, f"x{i}", x, options=store.options())
        conn.commit()
        row = conn.execute("SELECT type, data FROM tensors WHERE name='x1'"
                           ).fetchone()
        assert row[0] >> 32 == ttio.EXTERNAL_STORE_ID == jtio.EXTERNAL_STORE_ID
        assert len(row[1]) == 16
        for i, (jx, tx) in enumerate(zip(jxs, txs)):
            if writer == "j":
                got = ttio.tensor_read(conn, f"x{i}",
                                       options=ttio.ExternalStore(side)
                                       .options())
                assert got.dtype == tx.dtype and torch.equal(got, tx)
            else:
                got = jtio.tensor_read(conn, f"x{i}",
                                       options=jtio.ExternalStore(side)
                                       .options())
                np.testing.assert_array_equal(
                    np.asarray(got).view(np.uint8), jx.view(np.uint8))
        conn.close()


def test_tensor_new_from_file(tmp_path):
    x = np.random.default_rng(5).standard_normal((4, 6)).astype(np.float32)
    path = str(tmp_path / "raw.bin")
    with open(path, "wb") as f:
        f.write(b"\0" * 16 + x.tobytes())
    got = ttio.tensor_new_from_file(path, torch.float32, (4, 6), offset=16)
    np.testing.assert_array_equal(got.numpy(), x)
    by_tag = ttio.tensor_new_from_file(path, 0x04000, (4, 6), offset=16)
    np.testing.assert_array_equal(
        by_tag.numpy(), jtio.tensor_new_from_file(path, 0x04000, (4, 6), 16))
    got[0, 0] = 99.0  # copy-on-write: the file keeps its bytes
    np.testing.assert_array_equal(
        ttio.tensor_new_from_file(path, torch.float32, (4, 6), 16).numpy(), x)


@pytest.mark.cuda
@pytest.mark.parametrize("name", GOLDENS)
def test_cuda_depalettize_device(name):
    """The three goldens decoded on the card, equal to the C output."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    datatype, qbits, nb, n, comp, ref = _golden(name)
    out = tpal.depalettize_device(comp, datatype, n, qbits, nb)
    assert out.device.type == "cuda"
    np.testing.assert_array_equal(out.cpu().numpy(), ref)
