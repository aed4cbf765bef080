"""Model families of the port (counterpart of ``ccv_tpu.models``, whose
names it re-exports in ``__all__``), and the legacy convnet's trainer,
``ConvnetTrainParams`` and ``supervised_train``."""

from ccv_tpu_torch.models import vgg, convnet
from ccv_tpu_torch.models.convnet import ConvnetTrainParams, supervised_train

__all__ = ["vgg", "convnet"]
