"""ccv-compatible public API surface (counterpart of ccv_tpu/compat.py).

The reference's entry points (``ccv_sobel``, ``ccv_blur``, ...) on
DenseMatrix inputs, behind the transparent content-addressed cache
(``core/cache.py``): every op derives its output signature from its name,
its keyword params and the input signatures, exactly as ``ccv_tpu`` does,
and returns at once on a hit. Pass params by keyword: positional
arguments are taken as matrices.

    from ccv_tpu_torch import compat as ccv
    ccv.ccv_enable_default_cache()
    img = ccv.ccv_read("image.png", ccv.CCV_IO_GRAY)   # on the card
    edges = ccv.ccv_canny(img, size=3, low_thresh=36, high_thresh=108)

A hit is looked up on the device of the first input, so a CPU matrix
never gets a card result or the reverse. The results handed out are
shared with the cache and with every later hit: do not write into them in
place. Plain tensors and arrays can be passed too; they have no signature,
so nothing is cached, as in the reference for sig-less matrices.
"""

from __future__ import annotations

from ccv_tpu_torch.core import algebra as _algebra
from ccv_tpu_torch.core import cache
from ccv_tpu_torch.core.cache import cached_op
from ccv_tpu_torch.core.dense_matrix import as_array
from ccv_tpu_torch.ops import basic as _basic
from ccv_tpu_torch.ops import classic as _classic
from ccv_tpu_torch.ops import color as _color
from ccv_tpu_torch.ops import resample as _resample
from ccv_tpu_torch.ops import transform as _transform

# re-exported flag constants and I/O
from ccv_tpu_torch.ops.basic import FLIP_X as CCV_FLIP_X  # noqa: F401
from ccv_tpu_torch.ops.basic import FLIP_Y as CCV_FLIP_Y  # noqa: F401
from ccv_tpu_torch.ops.resample import (  # noqa: F401
    INTER_AREA as CCV_INTER_AREA,
    INTER_CUBIC as CCV_INTER_CUBIC,
    INTER_LINEAR as CCV_INTER_LINEAR,
)
from ccv_tpu_torch.core.algebra import (  # noqa: F401
    NO_PADDING as CCV_NO_PADDING,
    PADDING_ZERO as CCV_PADDING_ZERO,
)
from ccv_tpu_torch.core.io import (  # noqa: F401
    IO_GRAY as CCV_IO_GRAY,
    IO_RGB_COLOR as CCV_IO_RGB_COLOR,
)
from ccv_tpu_torch.core.io import read as ccv_read  # noqa: F401
from ccv_tpu_torch.core.io import write as ccv_write  # noqa: F401

ccv_sobel = cached_op("ccv_sobel")(_basic.sobel)
ccv_gradient = cached_op("ccv_gradient", n_outputs=2)(_basic.gradient)
ccv_flip = cached_op("ccv_flip")(_basic.flip)
ccv_blur = cached_op("ccv_blur")(_basic.blur)
ccv_erode = cached_op("ccv_erode")(_basic.erode)
ccv_dilate = cached_op("ccv_dilate")(_basic.dilate)
ccv_resample = cached_op("ccv_resample")(_resample.resample)
ccv_sample_down = cached_op("ccv_sample_down")(_resample.sample_down)
ccv_sample_up = cached_op("ccv_sample_up")(_resample.sample_up)
ccv_color_transform = cached_op("ccv_color_transform")(_color.color_transform)
ccv_saturation = cached_op("ccv_saturation")(_color.saturation)
ccv_contrast = cached_op("ccv_contrast")(_color.contrast)
ccv_decimal_slice = cached_op("ccv_decimal_slice")(_transform.decimal_slice)
ccv_perspective_transform = cached_op("ccv_perspective_transform")(
    _transform.perspective_transform)
ccv_canny = cached_op("ccv_canny")(_classic.canny)
ccv_close_outline = cached_op("ccv_close_outline")(_classic.close_outline)
ccv_sat = cached_op("ccv_sat")(_algebra.sat)


def ccv_otsu(a, range_: int = 256):
    """(threshold, variance) as Python scalars."""
    t, v = _classic.otsu(as_array(a), range_)
    return int(t), float(v)


def ccv_enable_default_cache() -> None:
    cache.enable()


def ccv_disable_cache() -> None:
    cache.disable()
