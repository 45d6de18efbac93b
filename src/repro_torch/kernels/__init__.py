"""Hopper kernels of the port, their plain PyTorch versions (``ref``) and
the backend-dispatched entry points (``ops``). CUDA sources live in
``repro_torch/csrc`` and build with nvcc at first use (``build``).

The entry points are exported here as the reference exports its own
(``repro.kernels``): ``flash_attention`` and ``fp8_gemm`` are the kernel
API's serving / attention entry points, which no model path calls."""
from .ops import (
    MixedOperand,
    MorSelect,
    QuantErr,
    flash_attention,
    fp8_gemm,
    gam_quant,
    mixed_gemm,
    mor_select,
    quant_err,
    resolve_backend,
)

__all__ = [
    "MixedOperand",
    "MorSelect",
    "QuantErr",
    "flash_attention",
    "fp8_gemm",
    "gam_quant",
    "mixed_gemm",
    "mor_select",
    "quant_err",
    "resolve_backend",
]
