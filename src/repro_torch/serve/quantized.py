"""Real-quantized serving weights (port of ``repro.serve.quantized``).

Ahead of serving, every GEMM weight's per-block MoR decision becomes a
per-block *storage* decision: a :class:`QTensor` holds the weight's
(N, K) quantization view as a ``MixedOperand`` (fp8 bytes, BF16
passthrough, NVFP4 nibbles per block), with every lane no tag uses
compacted away, so a weight whose blocks all went fp8 stores ~1 byte per
element. Every matmul against it runs through the mixed GEMM.
Layer-stacked (L, K, N) weights quantize per layer and keep the layer
axis on every lane; :meth:`QTensor.layer` gives one layer's 2-D view.

Tensor-parallel serving (``Engine(mesh=)``, :func:`shard_params`): each
rank keeps its blocks of every quantized weight, as the reference's
rules cut them (``sharding.rules.quantized_param_specs``), in a
:class:`ShardedQTensor`, and its vocabulary rows of a dense embedding in
a :class:`ShardedEmbed`; a weight whose block grid the axis does not
divide stays whole on every rank (llama3-8b's head on four ranks).
Activations stay *replicated* between GEMMs. A column-parallel weight
(view rows sharded: ``wqkv``, ``mlp/wi``, the head) multiplies the whole activation by its rows and the output
columns are gathered in rank order; a row-parallel one (contraction
blocks sharded: ``wo``, ``mlp/wo``) multiplies the activation's slice of
its K blocks and the f32 partials are summed over the ranks. The
reference's rules cut the fused ``wqkv`` and the fused swiglu ``wi`` in
contiguous quarters of their columns (at llama3-8b on four ranks, rank 2
holds q heads 24-31 and k heads 0-3, ranks 0-1 only gate columns), so a
head- or gate-local layout that skipped the gathers would be a layout
the reference lacks: the gather after each column-parallel GEMM is the
price of the reference's layout. No rank builds a dequantized copy of a
weight.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core.formats import NVFP4_MICRO
from repro_torch.core.mor import (
    STAT_FRAC_BF16,
    STAT_FRAC_E4M3,
    STAT_FRAC_E5M2,
    STAT_FRAC_NVFP4,
    STAT_REL_ERR,
    quantize_for_gemm,
)
from repro_torch.core.policy import MoRPolicy
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import (TAG_BF16, MixedOperand,
                                    activation_row_block, compact_lane_shapes,
                                    passthrough_mixed)

__all__ = ["QTensor", "quantize_weight", "quantize_weight_stacked", "qdot",
           "quantize_params", "ShardedQTensor", "ShardedEmbed",
           "shard_params", "replicated_bytes"]

_LANES = ("payload_q", "payload_bf16", "payload_nib", "micro_scales",
          "tags", "scales")


@dataclasses.dataclass
class QTensor:
    """A real-quantized weight: ``mo`` is the (N, K) quantization view
    (contraction last), ``shape`` the original (K, N), ``stats`` the
    STATS_WIDTH stats vector (one row per layer when stacked)."""

    mo: MixedOperand
    stats: torch.Tensor
    shape: Tuple[int, ...]

    def as_mixed_operand(self) -> MixedOperand:
        """The (N, K) view (the reference's hook of the same name)."""
        return self.mo

    def serve_dot(self, x2: torch.Tensor, *, out_dtype,
                  backend: str = "auto") -> torch.Tensor:
        """x2 (M, K) @ W -> (M, N) through the mixed GEMM: the serving
        product that ``core.linear.mor_dot`` and the quantized head
        dispatch on (a :class:`ShardedQTensor` has its own)."""
        return kops.mixed_dot(x2, self.mo, out_dtype=out_dtype,
                              backend=backend)

    @property
    def is_stacked(self) -> bool:
        return self.mo.tags.ndim == 3

    @property
    def nbytes(self) -> int:
        """Actual storage bytes (payloads + tags + scales + stats)."""
        ts = [getattr(self.mo, lane) for lane in _LANES] + [self.stats]
        return int(sum(t.numel() * t.element_size() for t in ts))

    @property
    def tags(self) -> torch.Tensor:
        return self.mo.tags

    @property
    def is_quantized(self) -> bool:
        """True if any block is stored as an fp8 payload (any tag but
        BF16), as the reference's ``QTensor.is_quantized``."""
        return bool((self.mo.tags.cpu().numpy() != TAG_BF16).any())

    @property
    def frac_quantized(self) -> float:
        return float((self.mo.tags.cpu().numpy() != TAG_BF16).mean())

    def to(self, device) -> "QTensor":
        """The QTensor with every lane on ``device`` (no copy of lanes
        already there)."""
        mo = dataclasses.replace(self.mo, **{
            lane: getattr(self.mo, lane).to(device) for lane in _LANES})
        return QTensor(mo, self.stats.to(device), self.shape)

    def layer(self, l: int) -> "QTensor":
        """Layer ``l`` of a stacked weight as a single-matrix QTensor
        (views of the lanes; the counterpart of lax.scan slicing)."""
        return QTensor(self.mo.stack_index(l), self.stats[l], self.shape)

    def dequant(self) -> torch.Tensor:
        """(K, N) -- or (L, K, N) if stacked -- bf16 reconstruction."""
        if not self.is_stacked:
            return self.mo.dequant().T.to(torch.bfloat16)
        return torch.stack([
            self.mo.stack_index(l).dequant().T
            for l in range(self.mo.tags.shape[0])
        ]).to(torch.bfloat16)


def _block_policy(policy: MoRPolicy) -> MoRPolicy:
    return policy if policy.partition == "block" else policy.replace(
        partition="block")


def _info(stats: torch.Tensor, qt: QTensor) -> Dict[str, float]:
    """Decision summary; a stacked weight averages its layers' rows."""
    s = stats.reshape(-1, stats.shape[-1]).cpu().numpy().mean(axis=0)
    return {
        "rel_err": float(s[STAT_REL_ERR]),
        "quantized": float(qt.frac_quantized > 0),
        "frac_e4m3": float(s[STAT_FRAC_E4M3]),
        "frac_e5m2": float(s[STAT_FRAC_E5M2]),
        "frac_bf16": float(s[STAT_FRAC_BF16]),
        "frac_nvfp4": float(s[STAT_FRAC_NVFP4]),
    }


def quantize_weight(w: torch.Tensor,
                    policy: MoRPolicy) -> Tuple[QTensor, Dict[str, float]]:
    """Apply the MoR decision to one (K, N) weight matrix, per block,
    on its (N, K) view."""
    if w.ndim != 2:
        raise ValueError(
            f"quantize_weight wants a 2-D weight, got {tuple(w.shape)}")
    mo, stats = quantize_for_gemm(w.T, _block_policy(policy))
    qt = QTensor(mo.compact(), stats, tuple(w.shape))
    return qt, _info(stats, qt)


def _stack_lanes(mos) -> MixedOperand:
    """Stack per-layer (already compacted) packs: a lane that any layer
    keeps dense is dense for all (zeros where a layer's is compact) --
    the same bytes as stacking the full packs and compacting after."""
    first = mos[0]
    Rp, Kp = first.padded_shape
    full = {"payload_q": (Rp, Kp), "payload_bf16": (Rp, Kp),
            "payload_nib": (Rp // 2, Kp),
            "micro_scales": (Rp, Kp // NVFP4_MICRO)}
    lanes = {}
    for lane in _LANES:
        ts = [getattr(m, lane) for m in mos]
        if lane in full and len({tuple(t.shape) for t in ts}) > 1:
            ts = [t if tuple(t.shape) == full[lane]
                  else torch.zeros(full[lane], dtype=t.dtype,
                                   device=t.device) for t in ts]
        lanes[lane] = torch.stack(ts)
    return MixedOperand(block=first.block, shape=first.shape,
                        has_nvfp4=any(m.has_nvfp4 for m in mos), **lanes)


def quantize_weight_stacked(w3: torch.Tensor, policy: MoRPolicy
                            ) -> Tuple[QTensor, Dict[str, float]]:
    """Per-block MoR decision for a layer-stacked (L, K, N) weight; each
    layer quantizes independently (own group amax and decisions) and is
    compacted before stacking to bound the transient memory."""
    if w3.ndim != 3:
        raise ValueError("quantize_weight_stacked wants a layer-stacked "
                         f"(L, K, N) weight, got {tuple(w3.shape)}")
    pol = _block_policy(policy)
    mos, rows = [], []
    for l in range(w3.shape[0]):
        mo, st = quantize_for_gemm(w3[l].T, pol)
        mos.append(mo.compact())
        rows.append(st)
    qt = QTensor(_stack_lanes(mos).compact(), torch.stack(rows),
                 tuple(w3.shape[1:]))
    return qt, _info(qt.stats, qt)


def qdot(x: torch.Tensor, qw: QTensor, *, backend: str = "auto",
         tile=None):
    """x @ W for a single-matrix QTensor weight. ``tile`` (the
    reference's TPU VMEM tiling) is accepted and ignored."""
    if qw.is_stacked:
        raise ValueError("qdot takes a single-matrix QTensor; slice a "
                         "stacked weight with QTensor.layer first")
    x2, lead = x.reshape(-1, x.shape[-1]), tuple(x.shape[:-1])
    y = kops.mixed_dot(x2, qw.mo, out_dtype=x.dtype, backend=backend)
    return y.reshape(*lead, qw.shape[1])


# Leaves the recurrent mixers read in plain einsums and elementwise code
# (``models.recurrent``), never as a mor_dot weight: the mamba mixer's
# conv taps, B/C and dt projections, dt bias, A and skip D, the mLSTM's
# gate projection and bias. The reference quantizes those that pass
# ``min_size`` and its mamba_mix then fails on them (a QTensor has no
# ``astype``); the port keeps them dense, as the reference's routers.
_MIXER_LEAVES = ("conv_w", "w_bc", "w_dt_down", "w_dt_up", "dt_bias",
                 "A_log", "D", "w_gate", "gate_bias")


def _is_gemm_weight(name: str, leaf) -> bool:
    """Leaves that feed a mor_dot / head GEMM as the weight: 2-D single
    matrices and 3-D layer stacks, excluding embeddings, norm scales,
    routers, biases and the recurrent mixers' plain leaves by name
    segment. 4-D stacked-expert MoE weights (and the sLSTM's 4-D
    recurrence) stay dense, as in the reference (the expert GEMMs run
    through mor_dot under the serving policy)."""
    if not isinstance(leaf, torch.Tensor) or leaf.ndim not in (2, 3):
        return False
    for seg in name.split("/"):
        if ("embed" in seg or "norm" in seg or seg.startswith("ln")
                or seg in ("scale", "bias", "router")
                or seg in _MIXER_LEAVES):
            return False
    return True


def quantize_params(params, policy: MoRPolicy, min_size: int = 1 << 16):
    """Quantize every GEMM-weight leaf of a params tree (nested dicts):
    returns (new tree with QTensor leaves, per-leaf stats keyed by the
    reference's ``/``-joined key paths). Leaves with fewer than
    ``min_size`` elements per matrix stay dense."""
    stats: Dict[str, Dict[str, float]] = {}

    def visit(tree, prefix):
        out = {}
        for key, leaf in tree.items():
            name = f"{prefix}/{key}" if prefix else str(key)
            if isinstance(leaf, dict):
                out[key] = visit(leaf, name)
            elif (_is_gemm_weight(name, leaf)
                  and leaf.shape[-2] * leaf.shape[-1] >= min_size):
                qt, st = (quantize_weight(leaf, policy) if leaf.ndim == 2
                          else quantize_weight_stacked(leaf, policy))
                stats[name] = st
                out[key] = qt
            else:
                out[key] = leaf
        return out

    return visit(params, ""), stats


def param_bytes(params) -> int:
    """Stored bytes of a params tree (QTensor leaves at their packed
    size; a sharded leaf at this rank's bytes)."""
    total = 0
    for leaf in params.values():
        if isinstance(leaf, dict):
            total += param_bytes(leaf)
        elif isinstance(leaf, (QTensor, ShardedQTensor, ShardedEmbed)):
            total += leaf.nbytes
        else:
            total += leaf.numel() * leaf.element_size()
    return total


def replicated_bytes(params) -> int:
    """Bytes of a rank's serving params (:func:`shard_params`) that every
    rank holds whole: the leaves the rules replicate, and of a
    :class:`ShardedQTensor` its stats and its compact (one-block) payload
    lanes. The rest is cut: a rank holds 1/n of it."""
    total = 0
    for leaf in params.values():
        if isinstance(leaf, dict):
            total += replicated_bytes(leaf)
        elif isinstance(leaf, ShardedQTensor):
            mo = leaf.local.mo
            cq, cnib, cms = compact_lane_shapes(mo.block)
            lanes = [leaf.local.stats] + [
                t for t, c in ((mo.payload_q, cq), (mo.payload_bf16, cq),
                               (mo.payload_nib, cnib),
                               (mo.micro_scales, cms))
                if tuple(t.shape[-2:]) == tuple(c)]
            total += sum(t.numel() * t.element_size() for t in lanes)
        elif isinstance(leaf, QTensor):
            total += leaf.nbytes
        elif not isinstance(leaf, ShardedEmbed):
            total += leaf.numel() * leaf.element_size()
    return total


def tag_counts(params) -> np.ndarray:
    """Blocks per tag (index = tag id) over every QTensor of a params
    tree."""
    counts = np.zeros(4, np.int64)
    for leaf in params.values():
        if isinstance(leaf, dict):
            counts += tag_counts(leaf)
        elif isinstance(leaf, QTensor):
            counts += np.bincount(leaf.tags.reshape(-1).cpu().numpy(),
                                  minlength=4)[:4]
    return counts


# ------------------------------------------------ tensor-parallel --


@dataclasses.dataclass
class ShardedQTensor:
    """This rank's blocks of a QTensor serving weight under the
    reference's rules: ``local`` (``sharding.rules.local_shards``), the
    mesh ``axis`` its view rows (``parallel='col'``) or contraction
    blocks (``'row'``) shard over, and the global (K, N) ``shape``. Its
    product runs on the mesh bound by ``use_mesh`` (the engine binds it
    around every model call)."""

    local: QTensor
    axis: str
    parallel: str
    shape: Tuple[int, int]

    @property
    def is_stacked(self) -> bool:
        return self.local.is_stacked

    @property
    def nbytes(self) -> int:
        """This rank's storage bytes."""
        return self.local.nbytes

    def layer(self, l: int) -> "ShardedQTensor":
        return dataclasses.replace(self, local=self.local.layer(l))

    def serve_dot(self, x2: torch.Tensor, *, out_dtype,
                  backend: str = "auto") -> torch.Tensor:
        """x2 (M, K), replicated, @ W -> (M, N), replicated: the rank's
        ``sharded_mixed_gemm``, then the columns gathered in rank order
        (column-parallel) or the f32 partials summed (row-parallel)."""
        from repro_torch.core.collectives import all_gather_over, bound_mesh

        mesh = bound_mesh((self.axis,))
        mo = self.local.mo
        bk = mo.block[1]
        M, (K, N) = x2.shape[0], self.shape
        if self.parallel == "col":
            a = passthrough_mixed(x2, (activation_row_block(M, bk), bk))
            y = kops.sharded_mixed_gemm(a, mo, mesh=mesh, col_axis=self.axis,
                                        out_dtype=out_dtype, backend=backend)
            parts = all_gather_over(y, self.axis)  # (n, M, N / n)
            return parts.permute(1, 0, 2).reshape(M, -1)[:, :N]
        kl = mo.padded_shape[1]
        k0 = mesh.axis_index(self.axis) * kl
        a = passthrough_mixed(x2[:, k0:k0 + kl],
                              (activation_row_block(M, bk), bk))
        return kops.sharded_mixed_gemm(a, mo, mesh=mesh,
                                       contract_axis=self.axis,
                                       out_dtype=out_dtype, backend=backend)


@dataclasses.dataclass
class ShardedEmbed:
    """This rank's vocabulary rows of a dense (V, d) embedding sharded
    over ``axis`` (the reference's ``P('model', None)``): ``local`` holds
    rows ``[r V / n, (r + 1) V / n)`` of rank coordinate r; ``shape`` is
    the global (V, d). Its lookup runs on the mesh bound by
    ``use_mesh``."""

    local: torch.Tensor
    axis: str
    shape: Tuple[int, int]

    @property
    def nbytes(self) -> int:
        return self.local.numel() * self.local.element_size()

    def lookup(self, ids: torch.Tensor) -> torch.Tensor:
        """``embed[ids]``: each rank looks the ids up in its own range
        (clamped into it), the ranks' rows are gathered and the owner's
        row of each id is selected. The partials are not summed: a sum
        would turn an embedding's -0.0 into +0.0."""
        from repro_torch.core.collectives import all_gather_over, bound_mesh

        rows = self.local.shape[0]
        lo = bound_mesh((self.axis,)).axis_index(self.axis) * rows
        mine = self.local[(ids - lo).clamp(0, rows - 1)]
        parts = all_gather_over(mine, self.axis)  # (n, *ids, d)
        owner = torch.div(ids, rows, rounding_mode="floor")
        idx = owner[None, ..., None].expand(1, *mine.shape)
        return torch.take_along_dim(parts, idx, dim=0)[0]

    def tied_head(self) -> "_TiedHead":
        """The tied head ``embed.T`` (d, V), column-parallel."""
        return _TiedHead(self)


@dataclasses.dataclass
class _TiedHead:
    """``embed.T`` of a :class:`ShardedEmbed`: each rank multiplies by its
    vocabulary columns (``models.transformer.HeadMatmul``, the
    one-rank head's product), the f32 logits gathered in rank order."""

    embed: ShardedEmbed

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.embed.shape[1], self.embed.shape[0])

    def serve_dot(self, x2: torch.Tensor, *, out_dtype=torch.float32,
                  backend: str = "auto") -> torch.Tensor:
        from repro_torch.core.collectives import all_gather_over
        from repro_torch.models.transformer import HeadMatmul

        y = HeadMatmul.apply(x2, self.embed.local.T)
        parts = all_gather_over(y, self.embed.axis)  # (n, M, V / n)
        return parts.permute(1, 0, 2).reshape(
            x2.shape[0], -1).to(out_dtype)


def shard_params(cfg, params, mesh):
    """This rank's serving params under the reference's rules
    (``sharding.rules.quantized_param_specs`` with block-grid demotion,
    then ``local_shards``): a QTensor cut along an axis becomes a
    :class:`ShardedQTensor`, the vocab-sharded dense ``embed`` a
    :class:`ShardedEmbed`, replicated leaves stay as they are. A dense
    GEMM weight that the rules shard raises a ValueError naming it:
    tensor-parallel serving shards quantized weights (quantize it, or
    lower ``quantize_min_size``)."""
    from repro_torch.sharding.rules import local_shards, quantized_param_specs

    specs = quantized_param_specs(cfg, params, mesh)

    def visit(tree, spec, prefix):
        out = {}
        for key, leaf in tree.items():
            name = f"{prefix}/{key}" if prefix else str(key)
            sp = spec[key]
            if isinstance(leaf, dict):
                out[key] = visit(leaf, sp, name)
                continue
            if isinstance(leaf, QTensor):
                lead = leaf.mo.tags.ndim - 2
                rows, cols = sp.mo.tags[lead], sp.mo.tags[lead + 1]
                if rows is None and cols is None:
                    out[key] = leaf
                    continue
                out[key] = ShardedQTensor(
                    local_shards(leaf, sp, mesh, name),
                    rows if rows is not None else cols,
                    "col" if rows is not None else "row",
                    tuple(leaf.shape))
                continue
            if all(e is None for e in sp):
                out[key] = leaf
            elif key == "embed" and tuple(sp) == ("model", None):
                out[key] = ShardedEmbed(local_shards(leaf, sp, mesh, name),
                                        "model", tuple(leaf.shape))
            else:
                raise ValueError(
                    f"{name}: a dense leaf the rules shard ({sp}); "
                    "tensor-parallel serving shards quantized weights "
                    "(quantize it, or lower quantize_min_size)")
        return out

    return visit(params, specs, "")
