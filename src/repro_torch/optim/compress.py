"""Gradient compression through the MoR selection machinery (port of the
single-device part of ``repro.optim.compress``).

:func:`compress_grads` is the gradient round trip the train step applies
before the optimizer. The legacy modes ('fp8', 'fp8_ef') keep the
per-tensor GAM-scaled E4M3 round trip, in plain PyTorch as the
reference's jnp arithmetic is; the 'mor' / 'mor_ef' modes route every
gradient leaf's f32 2-D view through :func:`repro_torch.core.mor.
mor_quantize`, the per-block sub2 / sub3 / sub4 selection the GEMM
operands use (on a CUDA leaf, one launch of the select kernel's f32
instance). The ``_ef`` variants keep a persistent error-feedback
residual per leaf: it is added to the raw gradient *before* selection,
and the new residual is ``corrected - quantized``.

:func:`ef_init` makes the zero residual tree. ``make_pod_compressed_psum``
(the cross-pod collective of shard_map trainers) belongs to the
multi-device port and raises.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.core.formats import E4M3, true_divide
from repro_torch.core.mor import EVENT_GRAD, STAT_EVENT_KIND, mor_quantize
from repro_torch.core.policy import MoRPolicy

from .adamw import tree_map

__all__ = ["GRAD_COMPRESS_MODES", "DEFAULT_GRAD_POLICY",
           "compress_decompress_grads", "compress_grads", "ef_init",
           "leaf2d", "make_pod_compressed_psum"]

GRAD_COMPRESS_MODES = ("fp8", "fp8_ef", "mor", "mor_ef")

# Per-block three-way selection is the default gradient recipe (E5M2's
# wider range matters most for gradients).
DEFAULT_GRAD_POLICY = MoRPolicy(recipe="sub3")


def leaf2d(x: torch.Tensor) -> torch.Tensor:
    """The 2-D quantization view of one leaf: trailing axis kept, leading
    axes flattened; vectors become one row, scalars (1, 1)."""
    if x.ndim == 0:
        return x.reshape(1, 1)
    if x.ndim == 1:
        return x.reshape(1, -1)
    return x.reshape(-1, x.shape[-1])


def _q_roundtrip(g: torch.Tensor) -> torch.Tensor:
    """Per-tensor GAM-scaled E4M3 round trip in the gradient's dtype (the
    legacy 'fp8' mode: one scale per tensor, no selection)."""
    gf = g.to(torch.float32)
    amax = torch.amax(gf.abs())
    scale = torch.where(amax > 0, true_divide(E4M3.amax, amax),
                        torch.ones_like(amax))
    q = torch.clamp(gf * scale, -E4M3.amax, E4M3.amax).to(E4M3.dtype)
    return torch.div(q.to(torch.float32), scale).to(g.dtype)


def _mor_roundtrip(g: torch.Tensor,
                   policy: MoRPolicy) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fake-quantize one leaf's f32 view through the shared MoR decision
    path: (the round-tripped leaf in g's dtype, its stats row stamped
    EVENT_GRAD)."""
    y2d, stats = mor_quantize(leaf2d(g.to(torch.float32)), policy)
    stats[STAT_EVENT_KIND] = EVENT_GRAD  # a fresh row of this event
    return y2d.reshape(g.shape).to(g.dtype), stats


def ef_init(grads) -> Any:
    """Zero f32 residuals shaped like ``grads``."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


def compress_grads(grads, mode: str = "mor", ef_state: Optional[Any] = None,
                   policy: Optional[MoRPolicy] = None):
    """Gradient compression round trip with per-event stats.

    Returns ``(new_grads, new_ef_state, stats)``: the grads after the
    round trip in their own dtypes; the new residual tree for the
    ``*_ef`` modes (``ef_state`` unchanged otherwise); for 'mor' /
    'mor_ef' a tree like ``grads`` of STATS_WIDTH rows with
    ``event_kind = EVENT_GRAD``, None for the legacy modes. Functional:
    the inputs are left as they are. Each leaf is finished before the
    next starts, so the f32 temporaries are one leaf's size."""
    if mode not in GRAD_COMPRESS_MODES:
        raise ValueError(f"mode {mode!r} not in {GRAD_COMPRESS_MODES}")
    pol = policy if policy is not None else DEFAULT_GRAD_POLICY

    if mode == "fp8":
        return tree_map(_q_roundtrip, grads), ef_state, None

    if mode == "mor":
        pairs = tree_map(lambda g: _mor_roundtrip(g, pol), grads)
        return (_pick(pairs, 0, grads), ef_state, _pick(pairs, 1, grads))

    if ef_state is None:
        raise ValueError(f"mode {mode!r} needs ef_state (see ef_init)")

    def one(g, e):
        corrected = g.to(torch.float32) + e
        if mode == "fp8_ef":
            q, stats = _q_roundtrip(corrected), None
        else:  # mor_ef
            q, stats = _mor_roundtrip(corrected, pol)
        # corrected is this leaf's own: the residual takes its place.
        return q.to(g.dtype), corrected.sub_(q.to(torch.float32)), stats

    triples = tree_map(one, grads, ef_state)
    stats = None if mode == "fp8_ef" else _pick(triples, 2, grads)
    return _pick(triples, 0, grads), _pick(triples, 1, grads), stats


def _pick(tuples, i: int, like):
    """Element ``i`` of each tuple leaf of ``tuples`` (a tree shaped like
    ``like``)."""
    if isinstance(like, dict):
        return {k: _pick(tuples[k], i, like[k]) for k in like}
    return tuples[i]


def compress_decompress_grads(grads, mode: str = "fp8",
                              ef_state: Optional[Any] = None,
                              policy: Optional[MoRPolicy] = None):
    """Signature-stable wrapper: always ``(grads, ef_state)``; the non-EF
    modes return ``ef_state`` unchanged (None if not given)."""
    new_g, new_e, _ = compress_grads(grads, mode, ef_state, policy)
    return new_g, new_e


def make_pod_compressed_psum(axis_name: str = "pod",
                             policy: Optional[MoRPolicy] = None,
                             inner_axes: Tuple[str, ...] = ()):
    """The cross-pod compressed sum of shard_map trainers: not ported (it
    is part of the multi-device port, ``repro.core.collectives`` and
    ``repro.sharding``)."""
    raise NotImplementedError(
        "make_pod_compressed_psum: the cross-pod collective is not ported "
        "yet (multi-device: repro.core.collectives, repro.sharding)")
