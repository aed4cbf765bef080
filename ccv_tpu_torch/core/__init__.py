"""Dense matrices, the op cache, image I/O, algebra and numeric helpers of
the port (counterpart of ``ccv_tpu.core``, whose names it re-exports)."""

from ccv_tpu_torch.core.dense_matrix import DenseMatrix, from_numpy, to_numpy
from ccv_tpu_torch.core import cache, io

__all__ = ["DenseMatrix", "from_numpy", "to_numpy", "cache", "io"]
