"""The classic detectors of the port (counterpart of
``ccv_tpu.detectors``, whose names it re-exports)."""

from ccv_tpu_torch.detectors import scd

__all__ = ["scd"]
