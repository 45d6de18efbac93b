"""The MoR framework (Algorithm 2) and the paper's recipes (port of
``repro.core.mor``).

:func:`mor_quantize` fake-quantizes one 2-D operand view (contraction
last) under a :class:`~repro_torch.core.policy.MoRPolicy` and returns
the STATS_WIDTH stats vector; :func:`quantize_for_gemm` makes the same
decisions and real-quantizes into the mixed block layout instead. Both
go through one decision path, :func:`_decide`, so they can never
disagree on a block's representation or on a stats row. Every event
runs through :mod:`repro_torch.kernels.ops`: ``quant_err`` (the
``gam_quant`` kernel) for the 'tensor' and 'e4m3' recipes,
``mor_select`` (the select kernel) for sub2/sub3/sub4, and
``quantize_pack`` (the pack kernel) for the sub-tensor recipes' real
packs.

Stats layout v4 (14 f32 lanes) is the reference's; index it through the
``STAT_*`` constants.

Under ``MoRPolicy.mesh_axes`` each rank quantizes its shard and every
tensor-global aggregate (the group amax in ``kernels.ops``; here the
counts, error sums, tag counts, fallback count and element count) is
reduced over the mesh (``core.collectives``), at the reference's sites.
The sums of one event go through one collective (:func:`_global_sums`);
each lane is still reduced on its own, so the stats are the reference's.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as _kref
from repro_torch.kernels.ref import TAG_NVFP4, MixedOperand

from .collectives import pmax_over, psum_over
from .formats import E4M3, FormatSpec, cast_to_format, true_divide
from .gam import GamScales, compute_scales
from .partition import Partition, from_blocks, to_blocks
from .policy import MoRPolicy

__all__ = [
    "STATS_WIDTH", "STAT_DECISION", "STAT_REL_ERR", "STAT_AMAX",
    "STAT_FRAC_E4M3", "STAT_FRAC_E5M2", "STAT_FRAC_BF16",
    "STAT_NONZERO_FRAC", "STAT_GROUP_MANTISSA", "STAT_FRAC_NVFP4",
    "STAT_MICRO_SCALE_BPE", "STAT_EVENT_KIND", "STAT_PAYLOAD_BPE",
    "STAT_GUARD_FLAGS", "STAT_FALLBACK_COUNT", "GUARD_OK",
    "GUARD_NONFINITE_AMAX", "GUARD_BLOCK_FALLBACK", "GUARD_STALE_SCALE",
    "EVENT_GEMM", "EVENT_GRAD", "EVENT_MOMENT_M", "EVENT_MOMENT_V",
    "mor_quantize", "quantize_for_gemm", "partition_of", "quant_dequant",
    "quant_dequant_with_scales",
]

STATS_WIDTH = 14

STAT_DECISION = 0
STAT_REL_ERR = 1
STAT_AMAX = 2
STAT_FRAC_E4M3 = 3
STAT_FRAC_E5M2 = 4
STAT_FRAC_BF16 = 5
STAT_NONZERO_FRAC = 6
STAT_GROUP_MANTISSA = 7
STAT_FRAC_NVFP4 = 8
STAT_MICRO_SCALE_BPE = 9
STAT_EVENT_KIND = 10
STAT_PAYLOAD_BPE = 11
STAT_GUARD_FLAGS = 12
STAT_FALLBACK_COUNT = 13

GUARD_OK = 0.0
GUARD_NONFINITE_AMAX = 1.0
GUARD_BLOCK_FALLBACK = 2.0
GUARD_STALE_SCALE = 4.0

EVENT_GEMM = 0.0
EVENT_GRAD = 1.0
EVENT_MOMENT_M = 2.0
EVENT_MOMENT_V = 3.0


def partition_of(policy: MoRPolicy) -> Partition:
    # sub4 blocks pair rows (nibble packing) and 16-divide the
    # contraction axis (micro scales).
    align = (2, 16) if policy.recipe == "sub4" else (1, 1)
    return Partition(kind=policy.partition, block_shape=policy.block_shape,
                     sub=policy.sub, align=align)


def quant_dequant_with_scales(x2d: torch.Tensor, part: Partition,
                              fmt: FormatSpec,
                              scales: GamScales) -> torch.Tensor:
    """Fake-quantize with precomputed per-block scales. Returns f32 (M,
    K)."""
    xb = to_blocks(x2d.to(torch.float32), part)
    s = scales.scale[:, :, None, None]
    xq = true_divide(cast_to_format(xb * s, fmt), s)
    return from_blocks(xq, tuple(x2d.shape))


def quant_dequant(x2d: torch.Tensor, part: Partition, fmt: FormatSpec,
                  algo: str = "gam") -> Tuple[torch.Tensor, GamScales]:
    """GAM-scale + fake-quantize. Returns (f32 (M, K), scales)."""
    scales = compute_scales(x2d, part, fmt, algo=algo)
    return quant_dequant_with_scales(x2d, part, fmt, scales), scales


def _f32(v, device, shape=()) -> torch.Tensor:
    """An f32 lane of ``shape`` on ``device``: a tensor as it is
    (broadcast), a Python number by a fill (``torch.as_tensor`` would
    copy it from host memory, which synchronises the card's stream)."""
    if isinstance(v, torch.Tensor):
        return v.to(dtype=torch.float32, device=device).expand(shape)
    return torch.full(shape, v, dtype=torch.float32, device=device)


def _stats(decision, rel_err, amax, f_e4, f_e5, f_bf, nz_frac, m_g,
           f_nv=0.0, micro_bpe=0.0, guard_flags=0.0, fallback_count=0.0,
           device=None, shape=()) -> torch.Tensor:
    """The STATS_WIDTH vector of one event, or (*shape, STATS_WIDTH) rows
    of a stack of events whose lanes are ``shape`` tensors."""
    lanes = [decision, rel_err, amax, f_e4, f_e5, f_bf, nz_frac, m_g,
             f_nv, micro_bpe, EVENT_GEMM]
    v = [_f32(x, device, shape) for x in lanes]
    # [11] payload_bpe from the tag mixture: fp8 1 B/elt, BF16 2,
    # NVFP4 half a byte plus one micro-scale byte per 16 elements.
    payload_bpe = (v[STAT_FRAC_E4M3] + v[STAT_FRAC_E5M2]
                   + 2.0 * v[STAT_FRAC_BF16]
                   + (0.5 + 1.0 / _kref.NVFP4_MICRO) * v[STAT_FRAC_NVFP4])
    v += [payload_bpe, _f32(guard_flags, device, shape),
          _f32(fallback_count, device, shape)]
    return torch.stack(v, dim=-1)


def _blocks_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum over the block grid (the last two axes) of each event."""
    return t.sum(dim=(-2, -1))


def _size(x: torch.Tensor) -> float:
    """Elements of one event's (M, K) operand (this rank's shard)."""
    return float(x.shape[-2] * x.shape[-1])


def _global_sums(axes, *lanes):
    """Each lane (a Python number, or a tensor of one event or of a
    stack's events) summed over the mesh ``axes`` -- the reference's
    ``psum_over`` of each, a number's as ``global_size`` -- in one
    collective; with no axes the lanes as they are."""
    if not axes:
        return lanes
    ts = [l for l in lanes if isinstance(l, torch.Tensor)]
    shape = torch.broadcast_shapes(*(t.shape for t in ts))
    v = psum_over(torch.stack([_f32(l, ts[0].device, shape)
                               for l in lanes]), axes)
    return tuple(v.unbind(0))


def _fallback_count(block_err_sums) -> torch.Tensor:
    """Blocks of the event whose error sum is nonfinite (a NaN/Inf
    element makes its block's error sum nonfinite)."""
    return _blocks_sum((~torch.isfinite(block_err_sums)).to(torch.float32))


def _guard_lanes(group_amax, fallback=None):
    """Guard lanes [12]/[13] from the (reduced) group amax and the
    event's (reduced) count of nonfinite blocks."""
    amax_bad = ~torch.isfinite(group_amax.to(torch.float32))
    flags = torch.where(amax_bad, GUARD_NONFINITE_AMAX, GUARD_OK)
    if fallback is None:
        return flags, 0.0
    flags = flags + torch.where(fallback > 0, GUARD_BLOCK_FALLBACK,
                                GUARD_OK)
    return flags, fallback


def _tensor_level(x2d: torch.Tensor, policy: MoRPolicy):
    """Tensor-level MoR [E4M3, BF16] (paper §3.1): block-scaled E4M3
    candidate, one global accept/reject of the mean relative error
    against the Eq. 2 threshold (over the mesh: every rank takes the
    same branch). A nonfinite error rejects (NaN < threshold is False),
    so a poisoned event stays BF16."""
    axes = policy.mesh_axes
    q = kops.quant_err(x2d, partition_of(policy), E4M3, policy.algo,
                       backend=policy.backend, mesh_axes=axes)
    cnt, esum, fb, size = _global_sums(
        axes, _blocks_sum(q.counts), _blocks_sum(q.err_sums),
        _fallback_count(q.err_sums), _size(x2d))
    err = esum / torch.clamp_min(cnt, 1.0)
    ok = err < policy.threshold
    y = torch.where(ok[..., None, None], q.y, x2d)
    okf = ok.to(torch.float32)
    nz = true_divide(cnt, size)
    gf, fb = _guard_lanes(q.group_amax, fb)
    stats = _stats(okf, err, q.group_amax, okf, 0.0, 1.0 - okf, nz,
                   q.group_mantissa, guard_flags=gf, fallback_count=fb,
                   device=x2d.device, shape=ok.shape)
    tags = torch.where(ok[..., None, None], _kref.TAG_E4M3,
                       _kref.TAG_BF16).to(torch.int32).expand(
                           q.err_sums.shape).contiguous()
    return y, stats, tags


def _static_e4m3(x2d: torch.Tensor, policy: MoRPolicy):
    """Always-E4M3 static recipe: no BF16 arm, so the guard lanes only
    report poisoned blocks."""
    axes = policy.mesh_axes
    q = kops.quant_err(x2d, partition_of(policy), E4M3, policy.algo,
                       backend=policy.backend, mesh_axes=axes)
    cnt, esum, fb, size = _global_sums(
        axes, _blocks_sum(q.counts), _blocks_sum(q.err_sums),
        _fallback_count(q.err_sums), _size(x2d))
    err = esum / torch.clamp_min(cnt, 1.0)
    nz = true_divide(cnt, size)
    gf, fb = _guard_lanes(q.group_amax, fb)
    stats = _stats(1.0, err, q.group_amax, 1.0, 0.0, 0.0, nz,
                   q.group_mantissa, guard_flags=gf, fallback_count=fb,
                   device=x2d.device, shape=err.shape)
    tags = torch.full(tuple(q.err_sums.shape), _kref.TAG_E4M3,
                      dtype=torch.int32, device=x2d.device)
    return q.y, stats, tags


def _sub_tensor_stats(r, policy: MoRPolicy, x_size: int) -> torch.Tensor:
    """Aggregate one sub-tensor selection event into the stats vector
    (over the mesh: block, tag, nonzero and nonfinite-block counts, the
    E4M3 error sums and the element count summed over it)."""
    dev = r.sel.device
    tags = {"sub2": (0,), "sub3": (0, 1)}.get(policy.recipe,
                                             (0, 1, TAG_NVFP4))
    nblocks, cnt, e4, fb, size, *n_tag = _global_sums(
        policy.mesh_axes, float(r.sel.shape[-2] * r.sel.shape[-1]),
        _blocks_sum(r.counts), _blocks_sum(r.e4_sums),
        _fallback_count(r.e4_sums), float(x_size),
        *(_blocks_sum((r.sel == t).to(torch.float32)) for t in tags))
    nz = true_divide(cnt, size)
    tot_n = torch.clamp_min(cnt, 1.0)
    global_e4_err = e4 / tot_n
    shape = cnt.shape

    def frac(i):
        return true_divide(n_tag[i], nblocks)

    f4 = frac(0)
    gf, fb = _guard_lanes(r.group_amax, fb)
    if policy.recipe == "sub2":
        return _stats(f4, global_e4_err, r.group_amax, f4, 0.0, 1.0 - f4,
                      nz, r.group_mantissa, guard_flags=gf,
                      fallback_count=fb, device=dev, shape=shape)
    f5 = frac(1)
    if policy.recipe == "sub3":
        return _stats(f4, global_e4_err, r.group_amax, f4, f5,
                      1.0 - f4 - f5, nz, r.group_mantissa, guard_flags=gf,
                      fallback_count=fb, device=dev, shape=shape)
    f_nv = frac(2)
    return _stats(f_nv, global_e4_err, r.group_amax, f4, f5,
                  1.0 - f4 - f5 - f_nv, nz, r.group_mantissa, f_nv,
                  true_divide(f_nv, float(_kref.NVFP4_MICRO)), guard_flags=gf,
                  fallback_count=fb, device=dev, shape=shape)


def _off_stats(x2d: torch.Tensor, mesh_axes=()) -> torch.Tensor:
    """Stats of a disabled event: decision = -1.0 (the sentinel that
    aggregation consumers filter on); nonzero fraction and amax over the
    mesh."""
    nnz, size = _global_sums(mesh_axes,
                             _blocks_sum((x2d != 0).to(torch.float32)),
                             _size(x2d))
    nz = true_divide(nnz, size)
    amax = pmax_over(torch.amax(x2d.to(torch.float32).abs(), dim=(-2, -1)),
                     mesh_axes)
    gf, _ = _guard_lanes(amax)
    return _stats(-1.0, 0.0, amax, 0.0, 0.0, 1.0, nz, 1.0, guard_flags=gf,
                  device=x2d.device, shape=amax.shape)


def _sub_tensor(x2d: torch.Tensor, policy: MoRPolicy):
    """Sub-tensor MoR (§3.2 + sub4): one fused selection pass per block
    (``kops.mor_select``); only the stats aggregation lives here."""
    r = kops.mor_select(x2d, partition_of(policy), mode=policy.recipe,
                        algo=policy.algo, backend=policy.backend,
                        mesh_axes=policy.mesh_axes)
    return r.y, _sub_tensor_stats(r, policy, _size(x2d)), r.sel


def _decide(x2d: torch.Tensor, policy: MoRPolicy):
    """The shared recipe dispatch: (fake-quant y, stats, per-block
    tags)."""
    if policy.recipe == "tensor":
        return _tensor_level(x2d, policy)
    if policy.recipe in ("sub2", "sub3", "sub4"):
        return _sub_tensor(x2d, policy)
    if policy.recipe == "e4m3":
        return _static_e4m3(x2d, policy)
    raise ValueError(f"unknown recipe: {policy.recipe}")


def mor_quantize(x2d: torch.Tensor,
                 policy: MoRPolicy) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fake-quantize one 2-D operand view (contraction last) under
    ``policy``: (y in x2d's dtype and shape, STATS_WIDTH stats)."""
    if not policy.enabled:
        return x2d, _off_stats(x2d, policy.mesh_axes)
    y, stats, _ = _decide(x2d, policy)
    # Row-major whatever the view or the backend: the GEMM that consumes
    # y picks its summation order by layout, so kernel and plain paths
    # must hand it the same one.
    return y.to(x2d.dtype).contiguous(), stats


def quantize_for_gemm(x: torch.Tensor,
                      policy: MoRPolicy) -> Tuple[MixedOperand, torch.Tensor]:
    """Real-quantize one (R, K) operand view (contraction last) into the
    mixed block layout. Returns (MixedOperand, stats vector): the same
    decisions and stats as :func:`mor_quantize`. The sub-tensor recipes
    are one pass (the pack kernel writes the lanes); the 'tensor' and
    'e4m3' recipes decide first (a global accept/reject no block pass
    can make) and then pack under the decided tags. A stack (E, R, K) of
    operands (the MoE experts') is E events, each its own group: every
    lane and the stats gain a leading axis, the kernel launches once an
    entry."""
    if x.ndim == 2:
        mo, stats = _quantize_for_gemm(x[None], policy)
        return mo.stack_index(0), stats.squeeze(0)
    return _quantize_for_gemm(x, policy)


def _quantize_for_gemm(x: torch.Tensor, policy: MoRPolicy):
    """:func:`quantize_for_gemm` of a stack (E, R, K)."""
    E = x.shape[0]
    if not policy.enabled:
        block = Partition("block", policy.block_shape).resolve(
            tuple(x.shape[-2:]))
        return (kops._stacked_mixed([_kref.passthrough_mixed(x[e], block)
                                     for e in range(E)]),
                _off_stats(x, policy.mesh_axes))
    if policy.partition != "block":
        raise ValueError(
            "quantize_for_gemm requires partition='block' (got "
            f"{policy.partition!r})"
        )
    part = partition_of(policy)
    block = part.resolve(tuple(x.shape[-2:]))
    if policy.recipe == "sub4" and not _kref.nvfp4_block_capable(block):
        raise ValueError(
            f"sub4 packing needs an even-row, 16-divisible-column block; "
            f"policy block_shape {policy.block_shape} resolved to {block} "
            f"for operand {tuple(x.shape[-2:])}"
        )
    if policy.recipe in ("sub2", "sub3", "sub4"):
        mo, r = kops.quantize_pack(x, part, mode=policy.recipe,
                                   algo=policy.algo,
                                   backend=policy.backend,
                                   mesh_axes=policy.mesh_axes)
        return mo, _sub_tensor_stats(r, policy, _size(x))
    _, stats, tags = _decide(x, policy)
    # The decision path's group amax (over the mesh under mesh_axes), so
    # the pack's Alg. 1 scales can never disagree with the decisions in
    # `tags`.
    return kops._stacked_mixed([
        _kref.pack_mixed(x[e], tags[e], block, policy.algo,
                         group_amax=stats[e, STAT_AMAX], with_nvfp4=False)
        for e in range(E)]), stats
