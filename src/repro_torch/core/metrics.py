"""Acceptance metrics for the MoR framework, paper Eqs. 1-4 (port of
``repro.core.metrics``).

All metrics are computed over *non-zero* elements of the original tensor
(zero quantizes exactly and would otherwise dilute relative error; zero
padding introduced by blocking is excluded for the same reason).
"""
from __future__ import annotations

import torch

from .formats import true_divide
from .partition import Partition, to_blocks

__all__ = ["relative_error", "block_relative_error_sums",
           "block_dynamic_range_ok", "E5M2_RANGE_RATIO",
           "NVFP4_RANGE_RATIO"]

# Eq. 4: max-representable(E5M2) / min-normal(E5M2).
E5M2_RANGE_RATIO = 57344.0 / 2.0**-14

# Eq. 4 analog for the NVFP4 candidate: block amax over the smallest
# non-zero micro-group amax must fit E2M1's (6 / 0.5) span on top of
# the E4M3 micro scales' finite span (448 / 2^-9).
NVFP4_RANGE_RATIO = (6.0 / 0.5) * (448.0 / 2.0**-9)


def _rel_err(x: torch.Tensor, xq: torch.Tensor):
    """|x - xq| / |x| where x is non-zero, 0 elsewhere, and the mask."""
    nz = x != 0
    err = torch.where(nz, torch.abs(true_divide(
        x - xq, torch.where(nz, x, torch.ones_like(x)))), 0.0)
    return err, nz


def relative_error(x: torch.Tensor, xq: torch.Tensor) -> torch.Tensor:
    """Mean relative quantization error over non-zero elements (Eqs. 1-2).

    Returns a scalar f32. Defined as 0 for an all-zero tensor.
    """
    err, nz = _rel_err(x.to(torch.float32), xq.to(torch.float32))
    n = torch.sum(nz.to(torch.int32))
    mean = true_divide(torch.sum(err),
                       torch.clamp_min(n, 1).to(torch.float32))
    return torch.where(n > 0, mean, 0.0)


def block_relative_error_sums(x2d: torch.Tensor, xq2d: torch.Tensor,
                              part: Partition):
    """Per-block (sum of relative errors over non-zero elements (f32),
    non-zero count (int32)), each (nm, nk): Eq. 3 compares the per-block
    sums, and Eq. 2's tensor-level error is sum(err_sums) / sum(counts).
    """
    err, nz = _rel_err(to_blocks(x2d.to(torch.float32), part),
                       to_blocks(xq2d.to(torch.float32), part))
    return (torch.sum(err, dim=(2, 3)),
            torch.sum(nz.to(torch.int32), dim=(2, 3), dtype=torch.int32))


def block_dynamic_range_ok(x2d: torch.Tensor,
                           part: Partition) -> torch.Tensor:
    """Eq. 4: per-block max(abs) / min(abs over non-zeros) < E5M2's
    normal range. Blocks with <= 1 distinct non-zero magnitude trivially
    pass. Returns (nm, nk) bool."""
    xb = torch.abs(to_blocks(x2d.to(torch.float32), part))
    nz = xb != 0
    bmax = torch.amax(xb, dim=(2, 3))
    big = torch.finfo(torch.float32).max
    bmin = torch.amin(torch.where(nz, xb, big), dim=(2, 3))
    any_nz = torch.any(nz.flatten(2), dim=2)
    ratio = torch.where(any_nz, true_divide(
        bmax, torch.where(any_nz, bmin, torch.ones_like(bmin))), 1.0)
    return ratio < E5M2_RANGE_RATIO
