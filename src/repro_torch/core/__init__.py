"""MoR core of the port: formats, GAM scaling, partitions, policies, the
real-quantization entry point and the serving forward of ``mor_dot``."""
from .linear import N_FWD_EVENTS, mor_dot
from .mor import STATS_WIDTH, quantize_for_gemm
from .policy import (
    BF16_BASELINE,
    SUBTENSOR2_MOR,
    SUBTENSOR3_MOR,
    SUBTENSOR4_MOR,
    TENSOR_MOR,
    MoRDotPolicy,
    MoRPolicy,
)

__all__ = [
    "N_FWD_EVENTS", "mor_dot", "STATS_WIDTH", "quantize_for_gemm",
    "BF16_BASELINE", "SUBTENSOR2_MOR", "SUBTENSOR3_MOR", "SUBTENSOR4_MOR",
    "TENSOR_MOR", "MoRDotPolicy", "MoRPolicy",
]
