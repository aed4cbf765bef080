"""ccv_tpu_torch: the PyTorch + CUDA port of ccv_tpu.

Module paths and names mirror ``ccv_tpu`` so each counterpart is easy to
find. Plain tensor code is PyTorch; every Pallas kernel of ``ccv_tpu`` on
a ported path is a CUDA kernel written for Hopper (``csrc/``), built on
first use and bound with ctypes. The package imports neither ``jax`` nor
``ccv_tpu``.

The first slice is SCD face detection over an image pyramid
(``ccv_tpu_torch.detectors.scd.detect``).
"""

from ccv_tpu_torch import device  # noqa: F401  (sets the f32 matmul policy)
