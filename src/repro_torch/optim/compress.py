"""Gradient compression through the MoR selection machinery (port of
``repro.optim.compress``).

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

:func:`make_pod_compressed_psum` is the cross-pod collective of a
sharded trainer, over the ``torch.distributed`` ranks of a mesh bound by
``core.collectives.use_mesh``. With a policy, each pod packs its partial
gradient with :func:`quantize_for_gemm` (its group statistics reduced
over the within-pod axes ``inner_axes``, so each shard's lanes are those
of a single-device pack of the whole pod gradient), gathers the pack's
six lanes over the pod axis as they are, decodes every pod's pack and
sums the pods in f32, in pod order. Without one, the legacy flat path:
one per-tensor E4M3 payload and one f32 scale per pod. On the wire a
rank sends every lane the pack holds: the fp8 payload (1 B an element),
the dense bf16 lane (2 B an element, zeros outside BF16 blocks) and,
under sub4, the nibbles and micro scales; the tags and scales are 8 B a
block. The decode and the sum are plain PyTorch, as the reference's are
XLA outside its kernels.

:func:`ef_init` makes the zero residual tree.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch.core.collectives import all_gather_over
from repro_torch.core.formats import E4M3, true_divide
from repro_torch.core.mor import (EVENT_GRAD, STAT_EVENT_KIND, mor_quantize,
                                  quantize_for_gemm)
from repro_torch.core.policy import MoRPolicy
from repro_torch.kernels.ref import MixedOperand

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


def _e4m3_payload(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the per-tensor GAM-scaled E4M3 payload of ``g``, its f32 scale)."""
    gf = g.to(torch.float32)
    amax = torch.amax(gf.abs())
    scale = torch.where(amax > 0, true_divide(E4M3.amax, amax),
                        torch.ones_like(amax))
    return torch.clamp(gf * scale, -E4M3.amax, E4M3.amax).to(
        E4M3.dtype), scale


def _q_roundtrip(g: torch.Tensor) -> torch.Tensor:
    """Per-tensor GAM-scaled E4M3 round trip in the gradient's dtype (the
    legacy 'fp8' mode: one scale per tensor, no selection)."""
    q, scale = _e4m3_payload(g)
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


# The six lanes a pack ships, in the order of the reference's gather.
POD_LANES = ("payload_q", "payload_bf16", "payload_nib", "micro_scales",
             "tags", "scales")


def _gather_decode_sum(mo: MixedOperand, axis_name: Optional[str],
                       out_dtype) -> torch.Tensor:
    """Gather the six lanes of ``mo`` over the pod axis, decode each pod's
    pack and sum the pods in f32, in pod order: exactly
    sum(dequant(pack(g_pod))). Every pod's pack keeps the local pack's
    ``has_nvfp4`` (the recipe's, not the data's)."""
    g = {lane: all_gather_over(getattr(mo, lane), axis_name)
         for lane in POD_LANES}
    total = None
    for i in range(g["tags"].shape[0]):
        moi = dataclasses.replace(mo, **{k: v[i] for k, v in g.items()})
        d = moi.dequant().to(torch.float32)
        total = d if total is None else total + d
    return total.to(out_dtype)


def make_pod_compressed_psum(axis_name: Optional[str] = "pod",
                             policy: Optional[MoRPolicy] = None,
                             inner_axes: Tuple[str, ...] = ()):
    """The compressed cross-pod sum of a sharded trainer: returns
    ``psum(g)``, to be called on every rank inside ``use_mesh`` of a mesh
    with ``axis_name`` (and ``inner_axes``).

    Without ``policy``: the legacy flat path, one per-tensor E4M3 payload
    and one f32 scale per pod, gathered and dequant-summed.

    With ``policy``: each pod packs its partial gradient through the
    selection machinery (:func:`quantize_for_gemm` on the :func:`leaf2d`
    view in bf16, the within-pod reduction dtype) and the collective
    ships the pack's six lanes. Name the mesh axes that shard the pod's
    gradient in ``inner_axes``: every pack statistic is then reduced
    within the pod, so the shards of one pod emit the tags, scales and
    payload bytes a single-device pack of the whole pod gradient would.
    ``axis_name`` may be in neither ``inner_axes`` nor
    ``policy.mesh_axes``: pods hold different partial sums, not shards
    of one tensor.

    ``axis_name=None`` is the local pack / decode round trip (a one-pod
    mesh, or the numerics without a mesh)."""
    if policy is not None and axis_name in policy.mesh_axes:
        raise ValueError(f"policy.mesh_axes {policy.mesh_axes} must not "
                         f"include the pod axis {axis_name!r}")
    if policy is not None and axis_name in inner_axes:
        raise ValueError(f"inner_axes {inner_axes} must not include the "
                         f"pod axis {axis_name!r}: pods hold independent "
                         f"partial sums")

    def psum_fp8(g: torch.Tensor) -> torch.Tensor:
        q, scale = _e4m3_payload(g)
        qs = all_gather_over(q, axis_name)  # (n_pods, ...) fp8 payloads
        ss = all_gather_over(scale, axis_name)  # (n_pods,) f32
        deq = torch.div(qs.to(torch.float32),
                        ss.reshape((-1,) + (1,) * (qs.ndim - 1)))
        # As the reference's sum: over one pod the value itself (-0.0
        # kept), over more a sum that starts from +0.0.
        total = deq[0] if deq.shape[0] == 1 else deq.sum(dim=0)
        return total.to(g.dtype)

    if policy is None:
        return psum_fp8

    pol = policy.replace(mesh_axes=tuple(inner_axes))

    def psum_mor(g: torch.Tensor) -> torch.Tensor:
        mo, _ = quantize_for_gemm(leaf2d(g).to(torch.bfloat16), pol)
        out2d = _gather_decode_sum(mo, axis_name, torch.float32)
        return out2d.reshape(g.shape).to(g.dtype)

    return psum_mor
