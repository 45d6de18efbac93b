"""mor_dot: the MoR-quantized GEMM primitive, forward only (port of the
serving part of ``repro.core.linear``).

A weight that is already real-quantized (``serve.quantized.QTensor``;
anything exposing ``as_mixed_operand()``) is consumed directly by the
mixed-representation GEMM against a BF16-passthrough activation pack. A
disabled policy runs the plain dot. The fake-quant and fused lowerings
and the backward (with its stats token) belong to the training slice;
the port's ``mor_dot`` therefore takes no token.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import ops as kops

from .mor import STATS_WIDTH
from .policy import MoRDotPolicy

__all__ = ["N_FWD_EVENTS", "mor_dot"]

N_FWD_EVENTS = 2  # x, w


def _flat2d(x: torch.Tensor):
    return x.reshape(-1, x.shape[-1]), tuple(x.shape[:-1])


def mor_dot(x: torch.Tensor, w,
            policy: MoRDotPolicy) -> Tuple[torch.Tensor, torch.Tensor]:
    """y = MoR(x) @ MoR(w). x: (..., K), w: (K, N) or a QTensor.

    Returns (y: (..., N) in x.dtype, fwd_stats (N_FWD_EVENTS,
    STATS_WIDTH)); the serving and disabled paths report zero stats.
    """
    fwd_stats = torch.zeros((N_FWD_EVENTS, STATS_WIDTH),
                            dtype=torch.float32, device=x.device)
    x2, lead = _flat2d(x)
    if hasattr(w, "as_mixed_operand"):
        y = kops.mixed_dot(x2, w.as_mixed_operand(), out_dtype=x.dtype,
                           backend=policy.weight.backend)
        return y.reshape(*lead, w.shape[1]), fwd_stats
    if not policy.enabled:
        # Exact bf16 products, f32 accumulation, one rounding to x.dtype.
        y = (x2.to(torch.float32) @ w.to(torch.float32)).to(x.dtype)
        return y.reshape(*lead, w.shape[1]), fwd_stats
    raise NotImplementedError(
        "mor_dot against an unquantized weight under an enabled policy "
        "(fake-quant / fused lowering) belongs to the training slice "
        "(ROADMAP Queue 1); quantize serving weights with "
        "serve.quantized.quantize_params first"
    )
