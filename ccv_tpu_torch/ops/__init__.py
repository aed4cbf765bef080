"""Image-processing ops of the port (counterpart of ``ccv_tpu.ops``, whose
names it re-exports); the hand-written kernels live in ``ops.kernels``."""

from ccv_tpu_torch.ops import basic, resample, color, transform, classic, pyramid

__all__ = ["basic", "resample", "color", "transform", "classic", "pyramid"]
