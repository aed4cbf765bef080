"""Model families of the port (counterpart of ``ccv_tpu.models``, whose
names it re-exports)."""

from ccv_tpu_torch.models import vgg, convnet

__all__ = ["vgg", "convnet"]
