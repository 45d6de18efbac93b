"""PyTorch/CUDA port of the MoR package (``repro``) for NVIDIA Hopper.

The JAX package stays the reference; this package mirrors its layout
(``configs``, ``core``, ``kernels``, ``models``, ``serve``) with the same
module and function names. It imports ``torch``, numpy and the stdlib
only -- never ``jax`` and never ``repro``.

This slice ports the quantized serving path: ahead-of-time weight
quantization (``core.mor.quantize_for_gemm`` -> the ``mor_select_pack``
CUDA kernel) and the mixed-representation GEMM every served matmul runs
through (the ``mixed_gemm`` CUDA kernel), driven by the paged
continuous-batching ``serve.engine.Engine``.
"""
