"""ccv_tpu_torch: the PyTorch + CUDA port of ccv_tpu.

Module paths and names mirror ``ccv_tpu`` so each counterpart is easy to
find. Plain tensor code is PyTorch; every Pallas kernel of ``ccv_tpu`` on
a ported path is a CUDA kernel written for Hopper (``csrc/``), built on
first use and bound with ctypes. The package imports neither ``jax`` nor
``ccv_tpu``, and importing it needs no card.

The classic surface is re-exported here, as ``ccv_tpu`` does:
``DenseMatrix``, ``from_numpy``, ``to_numpy``, the op ``cache``, ``read``
and ``write``; ``ccv_tpu_torch.compat`` holds the ``ccv_*`` entry points.
"""

from ccv_tpu_torch import device  # noqa: F401  (sets the f32 matmul policy)
from ccv_tpu_torch.core import cache  # noqa: F401
from ccv_tpu_torch.core.dense_matrix import (  # noqa: F401
    DenseMatrix,
    from_numpy,
    to_numpy,
)
from ccv_tpu_torch.core.io import read, write  # noqa: F401
