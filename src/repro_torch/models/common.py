"""Shared model building blocks: norms, RoPE, activations, chunk sizes,
the chunked scan of the recurrent mixers and sinusoidal positions (port
of ``repro.models.common``, with the reference transformer's
per-position ``_sinusoidal_at``; the mesh constraints have no
counterpart in an eager single-device port)."""
from __future__ import annotations

import math
from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.formats import true_divide

__all__ = ["rms_norm", "layer_norm", "rope_freqs", "apply_rope",
           "sinusoidal_positions", "sinusoidal_at", "activation",
           "glu_split", "pick_chunk", "chunked_scan"]


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


def sinusoidal_at(index: torch.Tensor, d_model: int) -> torch.Tensor:
    """The sinusoidal embedding at each position of an integer tensor
    ``index`` (any shape): (*index.shape, d_model) f32, sin at the even
    columns and cos at the odd ones of index / 10000^(2i / d_model) (the
    reference's ``transformer._sinusoidal_at`` mapped over every element;
    decode adds it at each row's own position)."""
    dim = torch.arange(0, d_model, 2, dtype=torch.float32,
                       device=index.device)
    ang = true_divide(index.to(torch.float32)[..., None],
                      10000.0 ** true_divide(dim, float(d_model)))
    out = torch.empty((*index.shape, d_model), dtype=torch.float32,
                      device=index.device)
    out[..., 0::2] = torch.sin(ang)
    out[..., 1::2] = torch.cos(ang)
    return out


def sinusoidal_positions(seq: int, d_model: int,
                         device=None) -> torch.Tensor:
    """(seq, d_model) f32 sinusoidal embeddings of positions 0 .. seq-1."""
    return sinusoidal_at(torch.arange(seq, device=device), d_model)


class _Silu(torch.autograd.Function):
    """silu as JAX computes it in bf16, value and derivative.

    ``jax.nn.silu`` is x * logistic(x), and XLA lowers logistic to
    1 / (1 + exp(-x)) with every op rounded to the tensor's dtype; the
    same chain here agrees bit for bit in bf16 (``torch.sigmoid`` rounds
    once and differs in ~1/3 of elements). JAX differentiates silu as
    g * s + (x * g) * (s * (1 - s)), each op rounded (read from its
    compiled HLO); autograd through the forward chain would compute
    another formula (s^2 exp(-x)) and differ in the last bf16 bit of
    many elements."""

    @staticmethod
    def forward(ctx, x):
        s = torch.reciprocal(1 + torch.exp(-x))
        ctx.save_for_backward(x, s)
        return x * s

    @staticmethod
    def backward(ctx, g):
        x, s = ctx.saved_tensors
        return g * s + (x * g) * (s * (1 - s))


class _Gelu(torch.autograd.Function):
    """tanh-approximate gelu as JAX computes it, value and derivative.

    ``jax.nn.gelu(x, approximate=True)`` is x * (0.5 * (1 + tanh(c2 *
    (x + c1 * x**3)))) with c1 = 0.044715 and c2 = sqrt(2 / pi) cast to
    x's dtype, x**3 as (x * x) * x, and every op rounded to the dtype; the
    same chain here agrees bit for bit in bf16 (``F.gelu(approximate=
    'tanh')`` rounds once and differs in ~40% of elements). The backward
    is JAX's formula, read from the compiled HLO of its vjp, op for op:
    with i = tanh(.) and l = 0.5 * (1 + i),
    p = (0.5 * (x * g)) * (1 - i), s = c2 * (p + p * i),
    dx = (g * l + s) + (c1 * s) * (3 * x * x)."""

    @staticmethod
    def forward(ctx, x):
        # Fills, not copies from host memory (which would synchronise
        # the card's stream).
        c1 = torch.full((), 0.044715, dtype=x.dtype, device=x.device)
        c2 = torch.full((), math.sqrt(2 / math.pi), dtype=x.dtype,
                        device=x.device)
        x2 = x * x
        i = torch.tanh(c2 * (x + c1 * (x2 * x)))
        l = 0.5 * (1 + i)
        ctx.save_for_backward(x, x2, i, l, c1, c2)
        return x * l

    @staticmethod
    def backward(ctx, g):
        x, x2, i, l, c1, c2 = ctx.saved_tensors
        p = (0.5 * (x * g)) * (1 - i)
        s = c2 * (p + p * i)
        return (g * l + s) + (c1 * s) * (3 * x2)


def activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name in ("swiglu", "silu"):
        return _Silu.apply
    if name in ("geglu", "gelu"):
        return _Gelu.apply
    if name == "relu2":
        return lambda x: torch.square(torch.relu(x))
    raise ValueError(name)


def glu_split(h: torch.Tensor, gated: bool, act_fn):
    """Apply the (gated) activation to the fc1 output."""
    if gated:
        g, u = torch.chunk(h, 2, dim=-1)
        return act_fn(g) * u
    return act_fn(h)


def pick_chunk(n: int, target: int) -> int:
    """Largest divisor of n that is <= target (>= 1)."""
    c = min(target, n)
    while n % c:
        c -= 1
    return c


def _scan_chunk(f, n_carry, *args):
    """``f`` over the steps of one chunk: args are the carry's tensors,
    then the chunk's inputs (leading axis = steps). Returns the final
    carry's tensors and the stacked per-step outputs."""
    carry, xs = tuple(args[:n_carry]), args[n_carry:]
    ys = []
    for x_t in zip(*(x.unbind(0) for x in xs)):
        carry, y = f(carry, x_t)
        ys.append(y)
    return (*carry, torch.stack(ys))


def chunked_scan(f: Callable, init, xs, length: int, chunk: int,
                 remat: bool = False):
    """The reference's ``lax.scan`` over ``length`` steps in outer chunks
    of ``pick_chunk(length, chunk)`` steps (a prime length above
    ``chunk`` falls to chunks of 1, as there).

    ``f(carry, x_t) -> (carry, y_t)``; ``init`` is a tuple of tensors,
    ``xs`` a tuple of tensors with leading axis ``length``, ``y_t`` one
    tensor. Returns (final carry, ys stacked on a leading ``length``
    axis). With ``remat`` (train mode) each chunk runs under
    ``torch.utils.checkpoint`` (non-reentrant), as the reference's inner
    ``jax.checkpoint``: the backward keeps only the chunk-boundary
    carries and recomputes one chunk's steps at a time."""
    chunk = pick_chunk(length, chunk)
    carry, n = tuple(init), len(init)
    ys = []
    for c0 in range(0, length, chunk):
        xs_c = tuple(x[c0:c0 + chunk] for x in xs)
        if remat:
            out = checkpoint(_scan_chunk, f, n, *carry, *xs_c,
                             use_reentrant=False)
        else:
            out = _scan_chunk(f, n, *carry, *xs_c)
        carry = tuple(out[:n])
        ys.append(out[n])
    return carry, torch.cat(ys)
