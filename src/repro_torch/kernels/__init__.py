"""Hopper kernels of the port, their plain PyTorch versions (``ref``) and
the backend-dispatched entry points (``ops``). CUDA sources live in
``repro_torch/csrc`` and build with nvcc at first use (``build``)."""
