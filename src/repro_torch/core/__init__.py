"""MoR core of the port: formats, GAM scaling, partitions, policies, the
decision path (``mor``) and the quantized GEMM primitive (``linear``).

``mor`` and ``linear`` dispatch through ``repro_torch.kernels``, whose
modules import this package's formats and partitions; they load on
first access here, so either package can be imported first.
"""
import importlib

from .collectives import pmax_over, psum_over
from .policy import (
    BF16_BASELINE,
    SUBTENSOR2_MOR,
    SUBTENSOR3_MOR,
    SUBTENSOR4_MOR,
    TENSOR_MOR,
    MoRDotPolicy,
    MoRPolicy,
    paper_default,
    with_mesh_axes,
)

_LAZY = {
    "N_FWD_EVENTS": "linear", "N_BWD_EVENTS": "linear", "mor_dot": "linear",
    "new_token": "linear", "STATS_WIDTH": "mor", "mor_quantize": "mor",
    "quantize_for_gemm": "mor", "quant_dequant": "mor",
    "relative_error": "metrics", "block_relative_error_sums": "metrics",
    "block_dynamic_range_ok": "metrics",
}

__all__ = [*_LAZY, "BF16_BASELINE", "SUBTENSOR2_MOR", "SUBTENSOR3_MOR",
           "SUBTENSOR4_MOR", "TENSOR_MOR", "MoRDotPolicy", "MoRPolicy",
           "paper_default", "with_mesh_axes", "pmax_over", "psum_over"]


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(f".{_LAZY[name]}", __name__),
                       name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
