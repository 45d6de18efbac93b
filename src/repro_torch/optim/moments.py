"""Adam moments as packed MoR payloads (port of ``repro.optim.moments``).

A dense f32 Adam state costs 8 bytes a parameter for the two moments.
Under a :class:`MomentPolicy` each moment leaf is stored as a
:class:`PackedMoment` instead: the mixed block layout of
``kernels.ref.MixedOperand`` that the mixed GEMM consumes, encoded by
``core.mor.quantize_for_gemm`` (on a CUDA leaf, one launch of the
selection kernel's pack variant on the leaf's bf16 view), so the per-block
Eq. 3 / Eq. 4 decisions pick each 128 x 128 block's representation. A
fully-fp8 moment costs ~1 B/param (+8 bytes of tag and scale a block), a
fully-NVFP4 second moment 0.5625 B/param.

The port stores each pack with the lanes no tag references dropped to
one don't-care block (``MixedOperand.compact``: the bytes the reference's
:func:`physical_bytes_per_param` counts), so the card holds the budget it
reports; the stored values, tags and scales are the reference's.
Decoding (:func:`decode_moment`, :func:`decode_rows`) runs over row
stripes of ~16 M elements, so its temporaries stay a stripe's size
whatever the leaf's.

Leaves smaller than ``MomentPolicy.min_leaf`` elements stay dense f32.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.formats import NVFP4_MICRO
from repro_torch.core.mor import (EVENT_MOMENT_M, STAT_EVENT_KIND,
                                  STAT_PAYLOAD_BPE, STATS_WIDTH,
                                  quantize_for_gemm)
from repro_torch.core.policy import MoRPolicy
from repro_torch.kernels.ref import MixedOperand, decode_mixed_ref

from .adamw import tree_leaves

__all__ = ["MomentPolicy", "PackedMoment", "FP8_MOMENTS", "WIDE_RANGE_V",
           "SUB4_V_MOMENTS", "encode_moment", "decode_moment",
           "maybe_encode_moment", "decode_any", "moment_stats_rows",
           "mean_logical_bpe", "block_overhead_bpe",
           "logical_bytes_per_param", "physical_bytes_per_param",
           "without_lanes", "decode_rows", "row_stripes", "packs"]

# Elements a row stripe of a leaf's 2-D view spans (at least 128 rows):
# the decode's and the update's temporaries are a stripe's size.
STRIPE_ELEMS = 1 << 24


@dataclasses.dataclass(frozen=True)
class MomentPolicy:
    """Which MoR recipe each Adam moment is stored under: ``m`` / ``v``
    per-moment policies ('off' = dense f32); leaves of fewer than
    ``min_leaf`` elements stay dense."""

    m: MoRPolicy = MoRPolicy(recipe="off")
    v: MoRPolicy = MoRPolicy(recipe="off")
    min_leaf: int = 1024

    @property
    def enabled(self) -> bool:
        return self.m.enabled or self.v.enabled

    def replace(self, **kw) -> "MomentPolicy":
        return dataclasses.replace(self, **kw)


# Both moments per-block three-way selected (the training default).
FP8_MOMENTS = MomentPolicy(m=MoRPolicy(recipe="sub3"),
                           v=MoRPolicy(recipe="sub3"))
# A second-moment policy biased toward the wide-exponent arms (the Eq. 3
# acceptance gate tightened).
WIDE_RANGE_V = MoRPolicy(recipe="sub3", threshold=0.02)
# The NVFP4 arm on the second moment (0.5625 B/param fully selected).
SUB4_V_MOMENTS = MomentPolicy(m=MoRPolicy(recipe="sub3"),
                              v=MoRPolicy(recipe="sub4"))


@dataclasses.dataclass
class PackedMoment:
    """One moment leaf in the mixed block layout: ``mo`` the payload
    lanes of the leaf's 2-D view (``optim.compress.leaf2d``), compact
    where no tag references a lane; ``stats`` the encode event's
    STATS_WIDTH row (event_kind EVENT_MOMENT_M / V); ``shape`` the
    leaf's shape."""

    mo: MixedOperand
    stats: torch.Tensor
    shape: Tuple[int, ...]


def _is_pm(x) -> bool:
    return isinstance(x, PackedMoment)


def encode_moment(x: torch.Tensor, policy: MoRPolicy,
                  kind: float) -> PackedMoment:
    """Pack one f32 moment leaf. The 2-D view is cast to bf16 first: BF16
    is the top arm of every recipe, so a stored block is fp8 / NVFP4 /
    bf16, never f32."""
    from .compress import leaf2d  # sibling module; late import

    mo, stats = quantize_for_gemm(leaf2d(x).to(torch.bfloat16), policy)
    stats[STAT_EVENT_KIND] = kind  # a fresh row of this event
    return PackedMoment(mo=mo.compact(), stats=stats, shape=tuple(x.shape))


def row_stripes(R: int, K: int):
    """(r0, r1) stripes of an (R, K) view: multiples of 128 rows (so of
    every block's rows once R >= 128; one stripe below) of about
    STRIPE_ELEMS elements."""
    step = max(128, STRIPE_ELEMS // max(K, 1) // 128 * 128)
    return [(r0, min(r0 + step, R)) for r0 in range(0, R, step)]


def decode_rows(pm: PackedMoment, r0: int, r1: int) -> torch.Tensor:
    """Rows [r0, r1) of a packed leaf's 2-D view, decoded to f32 (r0 a
    multiple of the block's rows)."""
    mo = pm.mo
    br = mo.block[0]
    rows = decode_mixed_ref(_stripe(mo, r0 // br, -(-r1 // br)))
    return rows[:r1 - r0, :mo.shape[1]].to(torch.float32)


def decode_moment(pm: PackedMoment) -> torch.Tensor:
    """The stored values of a packed moment leaf, in f32 (decoded a row
    stripe at a time)."""
    R, K = pm.mo.shape
    out = torch.empty((R, K), dtype=torch.float32, device=pm.mo.device)
    for r0, r1 in row_stripes(R, K):
        out[r0:r1] = decode_rows(pm, r0, r1)
    return out.reshape(pm.shape)


def _stripe(mo: MixedOperand, i0: int, i1: int) -> MixedOperand:
    """Block rows [i0, i1) of ``mo``. A compact lane stays as it is: it
    holds zeros that no tag reads, as in the whole operand."""
    br, bk = mo.block
    Rp, Kp = mo.padded_shape

    def cut(lane, full, rows_a_block):
        if tuple(lane.shape) != full:
            return lane
        return lane[i0 * rows_a_block:i1 * rows_a_block]

    return MixedOperand(
        payload_q=cut(mo.payload_q, (Rp, Kp), br),
        payload_bf16=cut(mo.payload_bf16, (Rp, Kp), br),
        tags=mo.tags[i0:i1], scales=mo.scales[i0:i1], block=mo.block,
        shape=((i1 - i0) * br, Kp),
        payload_nib=cut(mo.payload_nib, (Rp // 2, Kp), br // 2),
        micro_scales=cut(mo.micro_scales, (Rp, Kp // NVFP4_MICRO), br),
        has_nvfp4=mo.has_nvfp4)


def maybe_encode_moment(x: torch.Tensor, moments: Optional[MomentPolicy],
                        kind: float) -> Any:
    """``x`` packed under the policy for ``kind``, or ``x`` itself (the
    dense / packed split is a property of the leaf's size and the
    policy, so init and every step agree on it)."""
    if not packs(moments, kind, x.numel()):
        return x
    return encode_moment(x, moments.m if kind == EVENT_MOMENT_M
                         else moments.v, kind)


def packs(moments: Optional[MomentPolicy], kind: float, numel: int) -> bool:
    """Whether a leaf of ``numel`` elements is stored packed for the
    moment ``kind`` under ``moments``."""
    if moments is None:
        return False
    pol = moments.m if kind == EVENT_MOMENT_M else moments.v
    return pol.enabled and numel >= moments.min_leaf


def decode_any(x: Any) -> torch.Tensor:
    """decode_moment for packed leaves, identity for dense ones."""
    return decode_moment(x) if _is_pm(x) else x


def block_overhead_bpe(mo: MixedOperand) -> float:
    """Byte cost of the tag and scale grids (int32 tag + f32 scale, 8
    bytes a block) per logical element."""
    nblocks = int(np.prod(tuple(mo.tags.shape)))
    nelem = int(np.prod(mo.shape))
    return 8.0 * nblocks / max(nelem, 1)


def logical_bytes_per_param(pm: PackedMoment) -> torch.Tensor:
    """Payload bytes a parameter implied by the encode's tag mixture
    (stats lane [11]) plus the block metadata."""
    return pm.stats[STAT_PAYLOAD_BPE] + torch.tensor(
        block_overhead_bpe(pm.mo), dtype=torch.float32,
        device=pm.stats.device)


def physical_bytes_per_param(pm: PackedMoment) -> float:
    """Device bytes a parameter of the pack after ``compact()`` (the
    port stores packs compact, so this is what the state holds)."""
    mo = pm.mo.compact()
    nbytes = sum(l.numel() * l.element_size()
                 for l in (mo.payload_q, mo.payload_bf16, mo.payload_nib,
                           mo.micro_scales, mo.tags, mo.scales))
    return nbytes / max(int(np.prod(pm.shape)), 1)


def without_lanes(pm: PackedMoment) -> PackedMoment:
    """``pm`` with its payload lanes emptied: what the metrics read (the
    stats row, the shape and the block grid) without the bytes."""
    mo = pm.mo

    def empty(lane):
        return lane.new_empty((0,) * lane.ndim)

    return PackedMoment(
        mo=MixedOperand(
            payload_q=empty(mo.payload_q), payload_bf16=empty(
                mo.payload_bf16), tags=mo.tags, scales=mo.scales,
            block=mo.block, shape=mo.shape,
            payload_nib=empty(mo.payload_nib),
            micro_scales=empty(mo.micro_scales), has_nvfp4=mo.has_nvfp4),
        stats=pm.stats, shape=pm.shape)


def _packed(tree):
    """The packed leaves of a tree (nested dicts, or a list of leaves)."""
    leaves = tree if isinstance(tree, list) else tree_leaves(tree)
    return [l for l in leaves if _is_pm(l)]


def moment_stats_rows(tree) -> Optional[torch.Tensor]:
    """The STATS_WIDTH rows of every packed leaf of a moment tree,
    stacked (None when it holds none)."""
    rows = [l.stats for l in _packed(tree)]
    if not rows:
        return None
    return torch.stack(rows).reshape(-1, STATS_WIDTH)


def mean_logical_bpe(tree) -> torch.Tensor:
    """Parameter-weighted mean logical bytes a parameter over the packed
    leaves of a moment tree (0.0 when none is packed)."""
    leaves = _packed(tree)
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    dev = leaves[0].stats.device
    sizes = torch.tensor([float(np.prod(l.shape)) for l in leaves],
                         dtype=torch.float32, device=dev)
    bpes = torch.stack([logical_bytes_per_param(l) for l in leaves])
    return torch.sum(bpes * sizes) / torch.sum(sizes)
