"""Port parity: INTER_CUBIC resampling, sample_up / sample_down with source
offsets, and the pyramid builders.

The same seeded numpy inputs go through ``ccv_tpu`` (JAX on the CPU) and
``ccv_tpu_torch`` (PyTorch on the CPU). Integer paths must agree bit for
bit. Float32 paths: the cubic resample within 1e-4 of the largest
magnitude (two float32 matmuls summed in another order), the 2x pyramid
steps within 1e-6 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccv_tpu.ops import pyramid as jpyramid
from ccv_tpu.ops import resample as jresample
from ccv_tpu_torch.ops import pyramid as tpyramid
from ccv_tpu_torch.ops import resample as tresample

SCALES = (0.7, 1.5, 2.0, 3.0)
INTERPS = {"cubic": tresample.INTER_CUBIC, "linear": tresample.INTER_LINEAR,
           "lanczos": tresample.INTER_LANCZOS}


def _image(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return rng.integers(0, 256, shape).astype(np.uint8)
    return rng.normal(0, 60, shape).astype(np.float32)


def test_interp_constants_match_jax():
    for name in ("INTER_AREA", "INTER_LINEAR", "INTER_CUBIC", "INTER_LANCZOS"):
        assert getattr(tresample, name) == getattr(jresample, name)


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("quantize", [False, True])
def test_cubic_weights_match_jax(scale, quantize):
    for n_in in (1, 7, 37):
        n_out = int(n_in * scale + 0.5)
        want = jresample.cubic_weights(n_out, n_in, scale, quantize)
        got = tresample.cubic_weights(n_out, n_in, scale, quantize)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("interp", sorted(INTERPS))
@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("shape", [(23, 31), (17, 12, 3)],
                         ids=["gray", "rgb"])
def test_resample_cubic_u8_matches_jax(interp, scale, shape):
    img = _image(shape, np.uint8, seed=int(scale * 10) + len(shape))
    kw = dict(rows_scale=scale, cols_scale=scale, interp=INTERPS[interp])
    want = np.asarray(jresample.resample(jnp.asarray(img), **kw))
    got = tresample.resample(torch.from_numpy(img), **kw)
    assert got.dtype == torch.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("interp", sorted(INTERPS))
@pytest.mark.parametrize("scale", SCALES)
def test_resample_cubic_float32_matches_jax(interp, scale):
    img = _image((19, 26, 2), np.float32, seed=int(scale * 10))
    kw = dict(rows_scale=scale, cols_scale=scale, interp=INTERPS[interp])
    want = np.asarray(jresample.resample(jnp.asarray(img), **kw))
    got = tresample.resample(torch.from_numpy(img), **kw).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_resample_cubic_explicit_size_matches_jax():
    """rows and cols given with their own scales, as detect's up-scale
    calls it (int(H * ratio + 0.5) rows at the ratio)."""
    img = _image((45, 60, 3), np.uint8, seed=5)
    kw = dict(rows=90, cols=121, rows_scale=2.0, cols_scale=2.0,
              interp=tresample.INTER_CUBIC)
    want = np.asarray(jresample.resample(jnp.asarray(img), **kw))
    got = tresample.resample(torch.from_numpy(img), **kw).numpy()
    np.testing.assert_array_equal(got, want)


def test_area_alone_refuses_to_upscale_in_both():
    img = np.zeros((8, 8), np.uint8)
    with pytest.raises(NotImplementedError):
        jresample.resample(jnp.asarray(img), rows=16, cols=16,
                           interp=jresample.INTER_AREA)
    with pytest.raises(NotImplementedError):
        tresample.resample(torch.from_numpy(img), rows=16, cols=16,
                           interp=tresample.INTER_AREA)


@pytest.mark.parametrize("op", ["sample_down", "sample_up"])
@pytest.mark.parametrize("src_x,src_y", [(0, 0), (1, 0), (0, 1), (1, 1)])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32],
                         ids=["u8", "f32"])
def test_pyramid_steps_with_offsets_match_jax(op, src_x, src_y, dtype):
    for shape in ((22, 30), (17, 13, 3)):  # even and odd sizes
        img = _image(shape, dtype, seed=src_x + 2 * src_y + len(shape))
        want = np.asarray(getattr(jresample, op)(jnp.asarray(img), src_x,
                                                 src_y))
        got = getattr(tresample, op)(torch.from_numpy(img), src_x,
                                     src_y).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape
        if dtype == np.uint8:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6,
                                       atol=1e-6 * np.abs(want).max())


def test_pyramid_sizes_match_jax():
    for h, w, n in ((480, 640, 5), (97, 61, 3), (31, 17, 1)):
        assert tpyramid.octave_sizes(h, w, n) == jpyramid.octave_sizes(h, w, n)
        for mh, mw in ((24, 24), (48, 20), (500, 500)):
            assert tpyramid.max_octaves(h, w, mh, mw) == \
                jpyramid.max_octaves(h, w, mh, mw)


PYRAMIDS = {
    "octave": (lambda m, t: m.octave_pyramid(t, 3), (40, 52)),
    "scale": (lambda m, t: m.scale_pyramid(t, (0.9, 0.31)), (33, 47, 3)),
    "scale-cubic": (lambda m, t: m.scale_pyramid(t, (1.7,),
                                                 tresample.INTER_CUBIC),
                    (21, 26, 3)),
    "interval": (lambda m, t: m.interval_pyramid(t, 2, 3), (40, 52)),
}


@pytest.mark.parametrize("name", sorted(PYRAMIDS))
def test_pyramids_match_jax(name):
    build, shape = PYRAMIDS[name]
    img = _image(shape, np.uint8, seed=11)
    got = build(tpyramid, torch.from_numpy(img))
    want = build(jpyramid, jnp.asarray(img))
    if name == "interval":
        assert len(got) == len(want) == 2
        got = [lv for row in got for lv in row]
        want = [lv for row in want for lv in row]
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.dtype == torch.uint8
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["cubic-up", "cubic-down", "sample_up",
                                "sample_down"])
def test_card_equals_cpu(op):
    """On the card the integer paths give the CPU's bytes: the cubic
    resample sums in float64, the pyramid steps in int32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    img = torch.from_numpy(_image((270, 480, 3), np.uint8, seed=21))
    fn = {"cubic-up": lambda a: tresample.resample(
              a, rows_scale=2.0, cols_scale=2.0,
              interp=tresample.INTER_CUBIC),
          "cubic-down": lambda a: tresample.resample(
              a, rows_scale=0.7, cols_scale=0.7,
              interp=tresample.INTER_CUBIC),
          "sample_up": lambda a: tresample.sample_up(a, 1, 0),
          "sample_down": lambda a: tresample.sample_down(a, 0, 1)}[op]
    got = fn(img.cuda())
    assert got.is_cuda
    assert torch.equal(got.cpu(), fn(img))
