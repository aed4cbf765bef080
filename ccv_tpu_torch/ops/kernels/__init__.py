"""Hand-written CUDA kernels of the port, with their plain PyTorch versions.

Sources live in ``ccv_tpu_torch/csrc``; ``_build`` compiles them with nvcc
on first use."""
