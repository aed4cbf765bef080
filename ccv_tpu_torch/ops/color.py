"""Colour ops (counterpart of ccv_tpu/ops/color.py; reference:
lib/ccv_image_processing.c).

``rgb_to_yuv`` takes the reference's /4096 fixed-point path for integer
inputs, where C division truncates toward zero (``torch.trunc(x / d)``, as
``ccv_tpu``; torch's ``//`` floors). ``saturation`` lerps each pixel
against its Rec.601 luma and ``contrast`` stretches around the
per-channel mean; both truncate, then clamp at an integer store.

Every product and sum is its own torch op, so each rounds once in float32
in ``ccv_tpu``'s order; no multiply-add is fused. ``contrast``'s mean is a
float32 reduction over the whole image, whose summation order differs from
XLA's, so an integer result that lands on a truncation boundary can
differ from ``ccv_tpu``'s by one (tests/test_torch_compat.py states how
many do).
"""

from __future__ import annotations

import torch

from ccv_tpu_torch.ops.filters import from_hwc, is_int, to_hwc

CCV_RGB_TO_YUV = 0x01


def _trunc_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """C integer division: truncate toward zero."""
    return torch.trunc(x / d)


def rgb_to_yuv(a: torch.Tensor) -> torch.Tensor:
    """ccv_color_transform(CCV_RGB_TO_YUV) twin (ccv_image_processing.c:4)
    on (..., 3) pixels."""
    r, g, b = (a[..., i].to(torch.float32) for i in range(3))
    if is_int(a):
        y = _trunc_div(r * 1225 + g * 2404 + b * 467, 4096)
        u = _trunc_div((b - y) * 2015, 4096) + 128
        v = _trunc_div((r - y) * 3592, 4096) + 128
        return torch.stack([y, u, v], -1).clamp(0, 255).to(a.dtype)
    y = (r * 1225 + g * 2404 + b * 467) / 4096
    u = (b - y) * 2015 / 4096 + 128
    v = (r - y) * 3592 / 4096 + 128
    return torch.stack([y, u, v], -1).to(a.dtype)


def color_transform(a: torch.Tensor, flag: int = CCV_RGB_TO_YUV
                    ) -> torch.Tensor:
    if flag != CCV_RGB_TO_YUV:
        raise ValueError(f"color_transform: unknown flag {flag:#x}")
    return rgb_to_yuv(a)


def saturation(a: torch.Tensor, ds: float) -> torch.Tensor:
    """ccv_saturation twin: lerp each pixel against its Rec.601 luma."""
    x = a.to(torch.float32)
    gs = (x[..., 0] * 0.299 + x[..., 1] * 0.587 + x[..., 2] * 0.114)[..., None]
    out = (x - gs) * ds + gs
    if is_int(a):
        # the C setter truncates toward zero and clamps
        # (lib/ccv_internal.h:266)
        out = torch.trunc(out).clamp(0, 255).to(a.dtype)
    return out


def contrast(a: torch.Tensor, ds: float) -> torch.Tensor:
    """ccv_contrast twin: stretch around the per-channel mean."""
    a, had = to_hwc(a)
    x = a.to(torch.float32)
    ms = x.mean(dim=(-3, -2), keepdim=True)
    out = (x - ms) * ds + ms
    if is_int(a):
        out = torch.trunc(out).clamp(0, 255).to(a.dtype)
    return from_hwc(out, had)
