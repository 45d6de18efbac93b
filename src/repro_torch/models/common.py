"""Shared model building blocks: norms, RoPE, activations (port of
``repro.models.common``; the mesh constraints and scan helpers have no
counterpart in an eager single-device port)."""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.formats import true_divide

__all__ = ["rms_norm", "layer_norm", "rope_freqs", "apply_rope",
           "activation", "glu_split"]


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.to(torch.float32))).to(x.dtype)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32) + bias.to(torch.float32)).to(x.dtype)


def rope_freqs(head_dim: int, theta: float,
               device=None) -> torch.Tensor:
    exps = true_divide(torch.arange(0, head_dim, 2, dtype=torch.float32,
                                    device=device), float(head_dim))
    return true_divide(1.0, theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (B, S, H, dh), positions: (B, S) or (S,) int."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, device=x.device)
    ang = positions.to(torch.float32)[..., None] * freqs
    if ang.ndim == 2:
        ang = ang[None]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    # jax.nn.silu lowers to x * 1 / (1 + exp(-x)) with every op rounded
    # to the tensor's dtype; the same chain here agrees bit for bit in
    # bf16 (torch.sigmoid rounds once and differs in ~1/3 of elements).
    if name in ("swiglu", "silu"):
        return lambda x: x * torch.reciprocal(1 + torch.exp(-x))
    if name in ("geglu", "gelu"):
        return lambda x: torch.nn.functional.gelu(x, approximate="tanh")
    if name == "relu2":
        return lambda x: torch.square(torch.relu(x))
    raise ValueError(name)


def glu_split(h: torch.Tensor, gated: bool, act_fn):
    """Apply the (gated) activation to the fc1 output."""
    if gated:
        g, u = torch.chunk(h, 2, dim=-1)
        return act_fn(g) * u
    return act_fn(h)
