"""Port parity: the content-addressed cache (ccv_tpu_torch/core/cache.py),
its siphash-2-4 and LRU (csrc/ccv_tpu_native.cpp, core/native.py) and the
DenseMatrix signatures, on the CPU, against ccv_tpu on the same bytes.

- siphash24 gives SipHash-2-4's published vector and ccv_tpu's hashes;
- NativeLru behaves as tests/test_aux.py's twin describes;
- generate_signature / derive_signature / from_numpy(...).sig equal
  ccv_tpu's for four dtypes and 2-D / 3-D shapes;
- hit, miss, disable, drain, LRU eviction and 0-signature propagation, as
  tests/test_core.py holds ccv_tpu's;
- the store's (signature, device) key, and a write into a copy of a
  result leaves the next hit unchanged; on the card (marked cuda) a CPU
  matrix never gets the card's result.
"""

import hashlib

import numpy as np
import pytest
import torch

from ccv_tpu.core import cache as jcache
from ccv_tpu.core import dense_matrix as jdm
from ccv_tpu.core import native as jnative
from ccv_tpu_torch import compat as ccv
from ccv_tpu_torch.core import cache, native
from ccv_tpu_torch.core.dense_matrix import DenseMatrix, from_numpy
from ccv_tpu_torch.utils import flags
from ccv_tpu_siphash import siphash_signatures


@pytest.fixture(scope="module", autouse=True)
def ccv_tpu_siphash():
    """ccv_tpu signs with siphash here, as the port does, whichever test
    worker built ccv_tpu's native library."""
    with siphash_signatures():
        yield


@pytest.fixture(autouse=True)
def fresh_cache():
    cache.disable()
    yield
    cache.disable()


def test_siphash_published_vector():
    """SipHash-2-4, key 00..0f, message 00..0e (Aumasson and Bernstein's
    test vectors, the 15-byte entry)."""
    assert native.siphash24(bytes(range(15)),
                            bytes(range(16))) == 0xa129ca6149be45e5


def test_siphash_equals_ccv_tpu():
    assert jnative.load() is not None  # ccv_tpu's library builds here
    rng = np.random.default_rng(0)
    for n in (0, 1, 7, 8, 9, 63, 64, 1000):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert native.siphash24(data) == jnative.siphash24(data)


def test_native_lru():
    lru = native.NativeLru(100)
    assert lru.put(1, b"hello")
    assert lru.get(1) == b"hello"
    assert lru.get(2) is None
    assert lru.put(2, b"x" * 96)  # evicts 1
    assert lru.get(1) is None
    assert not lru.put(3, b"y" * 101)  # larger than the budget
    assert lru.delete(2)
    assert not lru.delete(2)
    assert lru.used_bytes == 0
    lru.put(4, b"abc")
    lru.drain()
    assert lru.used_bytes == 0 and lru.get(4) is None
    lru.close()


ARRAYS = [np.arange(12, dtype=np.uint8).reshape(3, 4),
          np.arange(24, dtype=np.uint8).reshape(2, 4, 3),
          np.arange(20, dtype=np.int32).reshape(4, 5) - 7,
          np.linspace(-1, 1, 30, dtype=np.float32).reshape(5, 6),
          np.linspace(0, 9, 36).reshape(3, 4, 3)]


@pytest.mark.parametrize("arr", ARRAYS,
                         ids=lambda a: f"{a.dtype}-{'x'.join(map(str, a.shape))}")
def test_signatures_equal_ccv_tpu(arr):
    mine = from_numpy(arr, device="cpu")
    assert mine.sig == jdm.from_numpy(arr).sig != 0
    assert from_numpy(arr, signed=False, device="cpu").sig == 0
    np.testing.assert_array_equal(mine.numpy(), arr)
    assert cache.generate_signature(arr.tobytes(), arr.shape, "x") == \
        jcache.generate_signature(arr.tobytes(), arr.shape, "x")
    params = (("dx", 1), ("dy", 0))
    assert cache.derive_signature("ccv_sobel#0", params, (mine.sig,)) == \
        jcache.derive_signature("ccv_sobel#0", params, (mine.sig,))


def test_blake2b_under_disable_native_runtime():
    """With DISABLE_NATIVE_RUNTIME the signature is ccv_tpu's fallback,
    truncated blake2b."""
    data = b"ccv"
    want = int.from_bytes(hashlib.blake2b(
        data + b"|" + repr((1, "a")).encode(), digest_size=8).digest(),
        "little")
    flags.enable_flag(flags.DISABLE_NATIVE_RUNTIME)
    try:
        assert cache.generate_signature(data, 1, "a") == want
    finally:
        flags.disable_flag(flags.DISABLE_NATIVE_RUNTIME)
    assert cache.generate_signature(data, 1, "a") != want


def _img(fill=None):
    arr = ((np.arange(900) % 251).astype(np.uint8).reshape(30, 30)
           if fill is None else np.full((32, 32), fill, np.uint8))
    return from_numpy(arr, device="cpu")


def test_cache_hit_returns_same_result():
    cache.enable()
    img = _img()
    out1 = ccv.ccv_sobel(img, dx=1, dy=0)
    h0 = cache.hits
    out2 = ccv.ccv_sobel(img, dx=1, dy=0)
    assert cache.hits == h0 + 1
    assert out1.sig == out2.sig != 0
    assert out2.tensor is out1.tensor  # the cached tensor itself
    out3 = ccv.ccv_sobel(img, dx=0, dy=1)
    assert out3.sig != out1.sig


def test_cache_disabled_no_memoization():
    img = _img(0)
    h0, m0 = cache.hits, cache.misses
    ccv.ccv_sobel(img, dx=1, dy=0)
    ccv.ccv_sobel(img, dx=1, dy=0)
    assert (cache.hits, cache.misses) == (h0, m0)
    assert not cache.is_enabled()


def test_cache_lru_eviction():
    cache.enable(max_bytes=5000)  # one 32x32 int32 output at most
    img1, img2 = _img(1), _img(2)
    ccv.ccv_sobel(img1, dx=1, dy=0)
    ccv.ccv_sobel(img2, dx=1, dy=0)  # evicts img1's entry
    h0 = cache.hits
    ccv.ccv_sobel(img1, dx=1, dy=0)
    assert cache.hits == h0
    ccv.ccv_sobel(img1, dx=1, dy=0)
    assert cache.hits == h0 + 1


def test_drain_keeps_the_cache_on():
    cache.enable()
    img = _img()
    ccv.ccv_blur(img, sigma=1.0)
    cache.drain()
    assert cache.is_enabled()
    h0 = cache.hits
    ccv.ccv_blur(img, sigma=1.0)
    assert cache.hits == h0
    ccv.ccv_blur(img, sigma=1.0)
    assert cache.hits == h0 + 1


def test_zero_signature_propagates():
    assert cache.derive_signature("op", (), (0,)) == 0
    assert cache.derive_signature("op", (), (123,)) != 0
    cache.enable()
    plain = torch.from_numpy(np.ones((8, 8), np.uint8))
    out = ccv.ccv_sobel(plain, dx=1, dy=0)
    assert out.sig == 0
    unsigned = from_numpy(np.ones((8, 8), np.uint8), signed=False,
                          device="cpu")
    h0, m0 = cache.hits, cache.misses
    assert ccv.ccv_sobel(unsigned, dx=1, dy=0).sig == 0
    assert ccv.ccv_canny(ccv.ccv_blur(unsigned, sigma=1.0), size=3,
                         low_thresh=36, high_thresh=108).sig == 0
    assert (cache.hits, cache.misses) == (h0, m0)


def test_store_is_keyed_by_device():
    """One signature, two devices: an entry answers only its own device."""
    cache.enable()
    cpu = torch.arange(6)
    meta = torch.empty(6, device="meta")
    cache.put(77, cpu)
    assert cache.get(77, "cpu") is cpu
    assert cache.get(77, "cuda:0") is None
    assert cache.get(77, "meta") is None
    cache.put(77, meta)
    assert cache.get(77, "meta") is meta
    assert cache.get(77, "cpu") is cpu
    assert cache._nbytes((cpu, meta)) == 6 * 8 + 6 * 4  # int64, float32


def test_write_into_a_copy_leaves_the_hit_unchanged():
    cache.enable()
    img = _img()
    first = ccv.ccv_dilate(img, fsz=3)
    want = first.tensor.clone()
    copy = first.tensor.clone()
    copy += 1
    again = ccv.ccv_dilate(img, fsz=3)
    assert again.tensor is first.tensor
    assert torch.equal(again.tensor, want)
    assert torch.equal(img.tensor, _img().tensor)  # the input is untouched


@pytest.mark.cuda
def test_card_and_cpu_entries_stay_apart():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cache.enable()
    arr = (np.arange(900) % 251).astype(np.uint8).reshape(30, 30)
    on_card = from_numpy(arr, device="cuda")
    on_cpu = from_numpy(arr, device="cpu")
    assert on_card.sig == on_cpu.sig
    card = ccv.ccv_sobel(on_card, dx=1, dy=0)
    h0 = cache.hits
    cpu = ccv.ccv_sobel(on_cpu, dx=1, dy=0)
    assert cache.hits == h0 and cpu.tensor.device.type == "cpu"
    assert card.tensor.device.type == "cuda"
    assert torch.equal(card.tensor.cpu(), cpu.tensor)
    again = ccv.ccv_sobel(on_card, dx=1, dy=0)
    assert cache.hits == h0 + 1 and again.tensor is card.tensor


def test_dense_matrix_surface():
    m = from_numpy(np.zeros((4, 5, 3), np.uint8), device="cpu")
    assert (m.rows, m.cols, m.channels, m.dtype) == (4, 5, 3, torch.uint8)
    f = m.astype(torch.float32)
    assert f.sig == 0 and f.dtype == torch.float32
    assert "4x5x3" in repr(m) and f"{m.sig:#x}" in repr(m)
    assert DenseMatrix(torch.zeros(2, 2)).sig == 0  # callers' old form
