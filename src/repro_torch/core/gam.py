"""Group Amax Mantissa (GAM) scaling -- Algorithm 1 (port of
``repro.core.gam``).

The per-block scale is ``m_g * 2^{e_b}``: one shared group mantissa
``m_g`` and one E8M0 exponent per block, with ``e_b -= 1`` whenever
``m_g > m_b`` so no block saturates. Ablations: ``e8m0`` (pure power of
two) and ``fp32_amax`` (the ideal per-block scale).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .formats import FormatSpec, true_divide
from .partition import Partition, block_amax

__all__ = ["GamScales", "split_mantissa_exponent", "compute_scales",
           "scales_from_bmax", "exp2i", "E8M0_BIAS"]

E8M0_BIAS = 127


class GamScales(NamedTuple):
    scale: torch.Tensor           # (nm, nk) f32
    group_mantissa: torch.Tensor  # () f32 in [1, 2)
    block_exp: torch.Tensor       # (nm, nk) int32
    group_amax: torch.Tensor      # () f32


def exp2i(e: torch.Tensor) -> torch.Tensor:
    """Exact 2^e for integer e clamped to [-126, 127] (exponent-field
    bitcast: scale reconstruction must be exact power-of-two
    arithmetic)."""
    e = torch.clamp(e.to(torch.int32), -126, 127)
    return ((e + 127) << 23).view(torch.float32)


def split_mantissa_exponent(s: torch.Tensor):
    """s = m * 2^e with m in [1, 2) (exact, via frexp like jnp.frexp)."""
    fr, e = torch.frexp(s.to(torch.float32))
    return (fr * 2.0).to(torch.float32), (e - 1).to(torch.int32)


def compute_scales(x2d: torch.Tensor, part: Partition, fmt: FormatSpec,
                   algo: str = "gam") -> GamScales:
    return scales_from_bmax(block_amax(x2d, part), fmt, algo)


def scales_from_bmax(bmax: torch.Tensor, fmt: FormatSpec,
                     algo: str = "gam",
                     group_amax: torch.Tensor | None = None) -> GamScales:
    """Algorithm 1 from per-block amaxes. Zero and nonfinite guards: an
    all-zero or poisoned block scales as if its amax were the (guarded)
    group amax, and a zero or nonfinite group amax is replaced by 1.0."""
    g_amax = torch.amax(bmax) if group_amax is None else group_amax
    g_amax = torch.as_tensor(g_amax, dtype=torch.float32,
                             device=bmax.device)
    one = torch.ones((), dtype=torch.float32, device=bmax.device)
    g_ok = (g_amax > 0) & torch.isfinite(g_amax)
    safe_g = torch.where(g_ok, g_amax, one)
    safe_b = torch.where((bmax > 0) & torch.isfinite(bmax), bmax, safe_g)

    s_g = true_divide(fmt.amax, safe_g)
    s_b = true_divide(fmt.amax, safe_b)

    if algo == "fp32_amax":
        return GamScales(s_b.to(torch.float32), one,
                         split_mantissa_exponent(s_b)[1], g_amax)

    m_b, e_b = split_mantissa_exponent(s_b)
    if algo == "e8m0":
        e_b = torch.clamp(e_b, -126, 127)
        return GamScales(exp2i(e_b), one, e_b, g_amax)

    if algo != "gam":
        raise ValueError(f"unknown scaling algo: {algo}")

    m_g, _ = split_mantissa_exponent(s_g)
    e_b = torch.where(m_g <= m_b, e_b, e_b - 1)
    e_b = torch.clamp(e_b, -126, 127)
    scale = m_g * exp2i(e_b)
    return GamScales(scale.to(torch.float32), m_g, e_b, g_amax)
