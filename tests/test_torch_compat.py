"""Port parity: ccv_tpu_torch.compat, every ``ccv_*`` entry point on
crop120.png (gray and RGB) on the CPU with the cache on, against
ccv_tpu.compat on the same image and keywords.

Each op's output signatures equal ccv_tpu's (the derived signature is the
public identity of a result) and so do its values: exactly for integer
outputs, within 1e-5 of the largest for float ones. ``contrast``'s
per-channel float32 mean is a reduction whose order differs from XLA's,
so a pixel on a truncation boundary may differ by 1: the gate allows at
most 1 in value at 0.1% of the pixels (measured: none differ on
crop120.png and crop180.png). A second call of each op is a hit that
returns the cached tensor.
"""

import os

import numpy as np
import pytest
import torch

from ccv_tpu import compat as J
from ccv_tpu.core import cache as jcache
from ccv_tpu.core.io import read as jread
from ccv_tpu_torch import compat as T
from ccv_tpu_torch.core import cache as tcache
from ccv_tpu_siphash import siphash_signatures

DATA = os.path.join(os.path.dirname(__file__), "data")
PERSPECTIVE = dict(zip(("m00", "m01", "m02", "m10", "m11", "m12", "m20",
                        "m21", "m22"),
                       (0.9, 0.05, -10.0, -0.04, 1.1, 5.0, 1e-4, 2e-4, 1.0)))
COMMON = [
    ("ccv_sobel", dict(dx=1, dy=0)), ("ccv_sobel", dict(dx=0, dy=3)),
    ("ccv_sobel", dict(dx=5, dy=5)),
    ("ccv_gradient", dict(dx=1, dy=1)),
    ("ccv_flip", dict(ftype=T.CCV_FLIP_X)),
    ("ccv_flip", dict(ftype=T.CCV_FLIP_Y)),
    ("ccv_flip", dict(ftype=T.CCV_FLIP_X | T.CCV_FLIP_Y)),
    ("ccv_blur", dict(sigma=1.5)),
    ("ccv_erode", dict(fsz=3)), ("ccv_erode", dict(fsz=5)),
    ("ccv_dilate", dict(fsz=3)), ("ccv_dilate", dict(fsz=5)),
    ("ccv_resample", dict(rows=77, cols=91, rows_scale=77 / 120,
                          cols_scale=91 / 120, interp=T.CCV_INTER_AREA)),
    ("ccv_sample_down", {}), ("ccv_sample_up", {}),
    ("ccv_decimal_slice", dict(y=10.5, x=5.25, rows=50, cols=60)),
    ("ccv_perspective_transform", PERSPECTIVE),
    ("ccv_sat", dict(padding=T.CCV_PADDING_ZERO)),
]
GRAY = COMMON + [("ccv_canny", dict(size=3, low_thresh=36,
                                    high_thresh=108))]
RGB = COMMON + [("ccv_color_transform", {}),
                ("ccv_saturation", dict(ds=0.5)),
                ("ccv_saturation", dict(ds=1.5)),
                ("ccv_contrast", dict(ds=0.5)),
                ("ccv_contrast", dict(ds=1.5))]
CASES = ([(T.CCV_IO_GRAY, n, kw) for n, kw in GRAY]
         + [(T.CCV_IO_RGB_COLOR, n, kw) for n, kw in RGB])


def _id(case):
    flags, name, kw = case
    return (f"{'gray' if flags == T.CCV_IO_GRAY else 'rgb'}-{name[4:]}-"
            + "-".join(f"{k}{v:.3g}" if isinstance(v, float) else f"{k}{v}"
                       for k, v in list(kw.items())[:2]))


@pytest.fixture(scope="module", autouse=True)
def ccv_tpu_siphash():
    """ccv_tpu signs with siphash here, as the port does, whichever test
    worker built ccv_tpu's native library."""
    with siphash_signatures():
        yield


@pytest.fixture(scope="module")
def images(ccv_tpu_siphash):
    path = os.path.join(DATA, "crop120.png")
    return {f: (jread(path, f), T.ccv_read(path, f, device="cpu"))
            for f in (T.CCV_IO_GRAY, T.CCV_IO_RGB_COLOR)}


@pytest.fixture(autouse=True)
def both_caches():
    jcache.enable()
    tcache.enable()
    yield
    jcache.disable()
    tcache.disable()


def _outs(x):
    return x if isinstance(x, tuple) else (x,)


def _check(j, t, name):
    want = np.asarray(j.array)
    got = t.tensor.numpy()
    assert t.sig == j.sig != 0
    assert got.shape == want.shape and got.dtype == want.dtype
    if name == "ccv_contrast":
        diff = np.abs(got.astype(np.int64) - want)
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    elif np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want)
    else:
        scale = max(float(np.abs(want).max()), 1.0)
        assert float(np.abs(got - want).max()) <= 1e-5 * scale


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_op_equals_ccv_tpu(images, case):
    flags, name, kw = case
    jimg, timg = images[flags]
    assert timg.sig == jimg.sig
    want = _outs(getattr(J, name)(jimg, **kw))
    got = _outs(getattr(T, name)(timg, **kw))
    assert len(got) == len(want)
    for j, t in zip(want, got):
        _check(j, t, name)
    h0 = tcache.hits
    again = _outs(getattr(T, name)(timg, **kw))
    assert tcache.hits == h0 + len(got)
    assert all(a.tensor is g.tensor and a.sig == g.sig
               for a, g in zip(again, got))


def test_chained_close_outline_and_otsu(images):
    """A signature derived from a derived one (canny -> close_outline), and
    ccv_otsu's Python scalars."""
    jimg, timg = images[T.CCV_IO_GRAY]
    kw = dict(size=3, low_thresh=36, high_thresh=108)
    j = J.ccv_close_outline(J.ccv_canny(jimg, **kw))
    t = T.ccv_close_outline(T.ccv_canny(timg, **kw))
    _check(j, t, "ccv_close_outline")
    assert T.ccv_otsu(timg) == J.ccv_otsu(jimg)
    assert T.ccv_otsu(timg, range_=64)[0] == J.ccv_otsu(jimg, range_=64)[0]


def test_contrast_on_crop180():
    """The measured count behind contrast's tolerance, on the larger
    image."""
    path = os.path.join(DATA, "crop180.png")
    j = jread(path, T.CCV_IO_RGB_COLOR)
    t = T.ccv_read(path, T.CCV_IO_RGB_COLOR, device="cpu")
    for ds in (0.5, 1.5):
        _check(J.ccv_contrast(j, ds=ds), T.ccv_contrast(t, ds=ds),
               "ccv_contrast")


def test_cache_switches(images):
    T.ccv_disable_cache()
    assert not tcache.is_enabled()
    _, timg = images[T.CCV_IO_GRAY]
    h0 = tcache.hits
    T.ccv_flip(timg, ftype=T.CCV_FLIP_X)
    T.ccv_flip(timg, ftype=T.CCV_FLIP_X)
    assert tcache.hits == h0
    T.ccv_enable_default_cache()
    assert tcache.is_enabled() and tcache._max_bytes == 256 << 20
    assert T.ccv_sobel.raw is not None


def test_package_reexports():
    import ccv_tpu_torch
    from ccv_tpu_torch.core import dense_matrix, io
    assert ccv_tpu_torch.DenseMatrix is dense_matrix.DenseMatrix
    assert ccv_tpu_torch.from_numpy is dense_matrix.from_numpy
    assert ccv_tpu_torch.to_numpy is dense_matrix.to_numpy
    assert ccv_tpu_torch.cache is tcache
    assert ccv_tpu_torch.read is io.read is T.ccv_read
    assert ccv_tpu_torch.write is io.write is T.ccv_write
    assert torch.equal(torch.from_numpy(ccv_tpu_torch.to_numpy(
        torch.arange(3))), torch.arange(3))
