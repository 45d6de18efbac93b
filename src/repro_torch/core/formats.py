"""Numeric format specifications (port of ``repro.core.formats``).

E4M3 / E5M2 fp8, BF16 passthrough and the two-level NVFP4 scheme (E2M1
payload + one E4M3 micro scale per NVFP4_MICRO contraction elements).

fp8 casts clip to +-amax *before* casting. Torch's fp8 casts saturate
overflow where ml_dtypes returns NaN, so without the clip an
out-of-range value would give a different byte than the reference.
The E2M1 snap is the reference's exact power-of-two bit arithmetic, not
torch's ``float4_e2m1fn_x2`` cast (which, like ml_dtypes, maps NaN to a
number; the reference keeps NaN as NaN).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

__all__ = [
    "FormatSpec", "E4M3", "E5M2", "BF16", "NVFP4", "FORMATS",
    "cast_to_format", "cast_to_nvfp4", "round_to_e2m1",
    "encode_e2m1", "decode_e2m1", "NVFP4_MICRO", "E2M1_AMAX", "true_divide",
]

NVFP4_MICRO = 16
E2M1_AMAX = 6.0


@dataclasses.dataclass(frozen=True)
class FormatSpec:
    """A quantization target format (fields as in the reference)."""

    name: str
    amax: float
    min_normal: float
    min_subnormal: float
    dtype: Any
    mantissa_bits: int
    bits: int

    @property
    def is_passthrough(self) -> bool:
        return self.dtype is None or self.name == "bf16"

    @property
    def eps(self) -> float:
        return 2.0 ** -(self.mantissa_bits + 1)


E4M3 = FormatSpec("e4m3", 448.0, 2.0**-6, 2.0**-9, torch.float8_e4m3fn,
                  3, 8)
E5M2 = FormatSpec("e5m2", 57344.0, 2.0**-14, 2.0**-16, torch.float8_e5m2,
                  2, 8)
BF16 = FormatSpec("bf16", 3.3895314e38, 2.0**-126, 2.0**-133, None, 7, 16)
# Block-level GAM target of the two-level scheme: 448 * 6.
NVFP4 = FormatSpec("nvfp4", E4M3.amax * E2M1_AMAX, 1.0, 0.5, None, 1, 4)

FORMATS = {f.name: f for f in (E4M3, E5M2, BF16, NVFP4)}


def true_divide(a, b) -> torch.Tensor:
    """IEEE ``a / b`` with either side a Python number. PyTorch lowers
    ``number / tensor`` to a reciprocal times the number (and, on CUDA,
    ``tensor / number`` to a multiply by the reciprocal), which rounds
    twice; the reference's scale arithmetic divides once."""
    if not isinstance(a, torch.Tensor):
        a = b.new_full((), a)
    if not isinstance(b, torch.Tensor):
        b = a.new_full((), b)
    return torch.div(a, b)


def _pow2_from_exp(e: torch.Tensor) -> torch.Tensor:
    return ((e + 127) << 23).to(torch.int32).view(torch.float32)


def _e2m1_ulp(a: torch.Tensor) -> torch.Tensor:
    """Spacing of the E2M1 grid at |a| (a in [0, 6]): 2^(e-1) with
    e = floor(log2(max(a, 1))) read from the f32 exponent field."""
    a1 = torch.clamp_min(a.to(torch.float32), 1.0)
    bits = a1.view(torch.int32)
    e = ((bits >> 23) & 0xFF) - 127
    return _pow2_from_exp(e - 1)


def round_to_e2m1(x: torch.Tensor) -> torch.Tensor:
    """RNE snap of f32 ``x`` to the E2M1 grid, saturating at +-6.
    ``torch.round`` rounds half to even, like ``jnp.round``."""
    xf = x.to(torch.float32)
    a = torch.clamp_max(xf.abs(), E2M1_AMAX)
    ulp = _e2m1_ulp(a)
    mag = torch.round(a / ulp) * ulp
    return torch.where(xf < 0, -mag, mag)


def encode_e2m1(v: torch.Tensor) -> torch.Tensor:
    """E2M1 grid values -> int32 4-bit codes (sign << 3 | magnitude)."""
    m = v.to(torch.float32).abs()
    ulp = _e2m1_ulp(m)
    bits = torch.clamp_min(m, 1.0).view(torch.int32)
    e = ((bits >> 23) & 0xFF) - 127
    hi = 4 + 2 * (e - 1) + (m / ulp).to(torch.int32) - 2
    code = torch.where(m < 2.0, (m * 2.0).to(torch.int32), hi)
    sign = (v < 0).to(torch.int32)
    return code | (sign << 3)


def decode_e2m1(code: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """4-bit E2M1 codes -> grid values in ``dtype`` (exact in bf16)."""
    c = code.to(torch.int32)
    m = c & 7
    low = m.to(dtype) * 0.5
    high = (1.0 + 0.5 * (m & 1).to(dtype)) * torch.where(
        m >= 6, 4.0, 2.0
    ).to(dtype)
    mag = torch.where(m < 4, low, high)
    return torch.where((c >> 3) == 1, -mag, mag)


def cast_to_nvfp4(xs: torch.Tensor) -> torch.Tensor:
    """Two-level NVFP4 fake-quantization of a block-scaled array, along
    the last axis (zero-padded to a multiple of NVFP4_MICRO)."""
    xs = xs.to(torch.float32)
    k = xs.shape[-1]
    pad = (-k) % NVFP4_MICRO
    if pad:
        xs = torch.cat(
            [xs, xs.new_zeros((*xs.shape[:-1], pad))], dim=-1
        )
    g = xs.reshape(*xs.shape[:-1], -1, NVFP4_MICRO)
    # torch.amax propagates NaN, like jnp.max.
    d = true_divide(torch.amax(g.abs(), dim=-1, keepdim=True), E2M1_AMAX)
    d_q = cast_to_format(d, E4M3)
    safe_d = torch.where(d_q > 0, d_q, torch.ones_like(d_q))
    out = round_to_e2m1(g / safe_d) * safe_d
    out = out.reshape(*xs.shape[:-1], xs.shape[-1])
    return out[..., :k]


def cast_to_format(x: torch.Tensor, fmt: FormatSpec) -> torch.Tensor:
    """Round-trip f32 ``x`` through ``fmt`` (clip, then cast)."""
    if fmt.name == "nvfp4":
        return cast_to_nvfp4(x)
    if fmt.is_passthrough:
        return x.to(torch.bfloat16).to(torch.float32)
    clipped = torch.clamp(x, -fmt.amax, fmt.amax)
    return clipped.to(fmt.dtype).to(torch.float32)
