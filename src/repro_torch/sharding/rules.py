"""Sharding rules (port of ``repro.sharding.rules``): parameter,
optimizer-state, batch, cache and quantized-weight partition specs for
every architecture, and each rank's pieces of a tree under them.

Megatron-style TP over 'model':
  wqkv / fc1 / expert-w1  -> column-parallel (shard output features)
  wo   / fc2 / expert-w2  -> row-parallel    (shard input features)
  embeddings / lm_head    -> vocab-sharded
  MoE experts             -> expert-parallel (shard E)
  norms / small ssm vecs  -> replicated
DP over ('pod','data') shards the batch. ZeRO-1: optimizer moments and
f32 master weights are additionally sharded over 'data' on the largest
dimension the param spec leaves free.

Quantized leaves (docs/sharding.md): a ``MixedOperand`` shards *as one
unit* -- uint8 payload, original-precision dual buffer, per-block tag
and GAM-scale grids all partition along the same block grid
(:func:`mixed_operand_pspec`), so a shard owns complete blocks with
their metadata and the mixed GEMM kernel runs shard-locally.
``QTensor`` serving weights reuse the dense rule of the weight they
replace, transposed into the (N, K) quantization view
(:func:`qtensor_pspec_from_dense`).

A spec is a :class:`PartitionSpec`, the port's own small immutable tuple
of axis entries (``None``, an axis name, or a tuple of names) that
prints and compares like ``jax.sharding.PartitionSpec``. The spec of a
``QTensor`` is a QTensor whose ``mo`` holds the six lane specs
(:class:`MixedSpec`) and whose ``stats`` is the stats spec, as the
reference's QTensor-of-specs; a ``PackedMoment``'s likewise.

The reference places a tree with ``jax.device_put(tree,
named_shardings(mesh, specs))`` and runs the sharded GEMM inside
``compat_shard_map``; neither has a counterpart here. One process runs
per shard (``core.collectives``), so :func:`local_shards` takes the
place of that ``device_put``: it cuts from a whole tree the pieces this
rank holds, its slice along each named axis by its mesh coordinate
(:class:`NamedSharding` pairs one leaf's spec with its mesh, as the
reference's ``jax.sharding.NamedSharding`` does). A
``QTensor`` keeps whole blocks of every lane; a compact lane is
replicated. An axis that does not divide a dense dimension raises a
``ValueError`` that names the leaf, as does a quantized leaf whose block
grid a spec built without a mesh would split.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.formats import NVFP4_MICRO
from repro_torch.kernels.ref import MixedOperand

__all__ = [
    "PartitionSpec", "P", "MixedSpec",
    "param_specs", "opt_state_spec_from_param", "batch_spec",
    "cache_specs_tree", "zero1_spec",
    "mixed_operand_pspec", "qtensor_pspec_from_dense",
    "quantized_param_specs", "packed_moment_pspec", "opt_state_specs",
    "local_shards", "local_mixed", "NamedSharding",
]


class PartitionSpec(tuple):
    """Axis entries of a leaf's dimensions, leading dimensions first: None
    (replicated), an axis name, or a tuple of names (sharded over their
    product, the first name major)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec({', '.join(map(repr, self))})"


P = PartitionSpec


class MixedSpec(NamedTuple):
    """The six lane specs of one mixed-layout operand, in the order of the
    reference's ``mixed_operand_pspec`` tuple."""

    payload_q: PartitionSpec
    payload_bf16: PartitionSpec
    payload_nib: PartitionSpec
    micro_scales: PartitionSpec
    tags: PartitionSpec
    scales: PartitionSpec


def _leaf_spec(path: str, leaf) -> PartitionSpec:
    ndim = leaf.ndim
    # Embeddings / heads: vocab-sharded.
    if path.endswith("embed") or path.endswith("lm_head"):
        # embed (V, d) -> shard V; lm_head (d, V) -> shard V.
        return P("model", None) if path.endswith("embed") else P(None, "model")
    # Norm scales / biases / small vectors: replicated.
    if ndim <= 1:
        return P(*([None] * ndim))
    # MoE experts (E, d, f): expert-parallel on E.
    if "moe" in path and ("w1" in path or "w2" in path):
        return P("model", None, None)
    if "router" in path:
        return P(None, None)
    # Column-parallel (shard output dim).
    col = ("wqkv", "wi", "w_in", "w_up", "w_qkv", "w_x", "xwq", "xwkv",
           "w_ff1")
    # Row-parallel (shard input dim).
    row = ("wo", "w_out", "w_down", "xwo", "w_ff2")
    last = path.split("/")[-1]
    if last in col:
        return P(*([None] * (ndim - 1)), "model")
    if last in row:
        return P("model", *([None] * (ndim - 1)))
    if last == "r":  # sLSTM recurrence (H, dh, 4dh): head-sharded if even.
        return P(None, None, None)
    if last == "conv_w":
        return P(None, "model")
    if last in ("w_bc", "w_dt_down"):
        return P("model", None)
    if last == "w_dt_up":
        return P(None, "model")
    if last in ("A_log", "D", "dt_bias"):
        return P("model", None) if ndim == 2 else P("model")
    return P(*([None] * ndim))


class _ShapeView:
    """Duck-typed (ndim, shape) stand-in for _leaf_spec rule matching."""

    def __init__(self, shape):
        self.shape = tuple(shape)
        self.ndim = len(self.shape)


def _unstacked(leaf) -> _ShapeView:
    """Shape view dropping the stacked layer axis."""
    return _ShapeView(tuple(leaf.shape)[1:])


def _map(fn: Callable[[str, Any], Any], tree, is_leaf=None, prefix=""):
    """``fn(path, leaf)`` over a tree of nested dicts, the path spelled as
    the reference's ``_path_str`` ('blocks/dense/wqkv')."""
    if isinstance(tree, dict) and not (is_leaf and is_leaf(tree)):
        return {k: _map(fn, v, is_leaf, f"{prefix}/{k}" if prefix
                        else str(k)) for k, v in tree.items()}
    return fn(prefix, tree)


def _map2(fn, a, b):
    """``fn(x, y)`` over two dict trees of one structure (``a``'s)."""
    if isinstance(a, dict):
        return {k: _map2(fn, v, b[k]) for k, v in a.items()}
    return fn(a, b)


def param_specs(cfg: ArchConfig, params_shape) -> Any:
    """PartitionSpec tree matching a params (shape) tree; any leaf with
    ``ndim`` and ``shape`` will do.

    Stacked block params (leading n_units axis) get a leading None.
    """

    def spec_for(p, leaf):
        stacked = "blocks" in p
        base = _leaf_spec(p, _unstacked(leaf) if stacked else leaf)
        if stacked:
            return P(None, *base)
        return base

    return _map(spec_for, params_shape)


def zero1_spec(spec: PartitionSpec, shape: Tuple[int, ...],
               data_axes=("data",)) -> PartitionSpec:
    """Extend a param spec with 'data' sharding on the largest free dim
    divisible by the data-axis size (ZeRO-1 optimizer partitioning)."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    best, best_size = None, 0
    for i, (s, n) in enumerate(zip(entries, shape)):
        if s is None and n % 16 == 0 and n > best_size:
            best, best_size = i, n
    if best is not None:
        entries[best] = data_axes if len(data_axes) > 1 else data_axes[0]
    return P(*entries)


def opt_state_spec_from_param(cfg: ArchConfig, params_shape,
                              multi_pod=False):
    """Specs for (master, m, v) f32 optimizer triples: param spec +
    ZeRO-1 over 'data' (``multi_pod`` is accepted and, as in the
    reference, not read)."""
    pspecs = param_specs(cfg, params_shape)
    data_axes = ("data",)
    return _map2(lambda spec, leaf: zero1_spec(spec, tuple(leaf.shape),
                                               data_axes),
                 pspecs, params_shape)


def batch_spec(multi_pod: bool = False) -> PartitionSpec:
    return P(("pod", "data") if multi_pod else "data")


_TP = 16  # model-axis size of the production meshes


def _cache_leaf_spec(path: str, shape, batch) -> PartitionSpec:
    """Cache entries: (n_units, B, ...) -- batch over data axes; the kv
    seq dim over 'model' when divisible (context-parallel decode,
    docs/sharding.md), else replicated over model."""
    ndim = len(shape)

    def tp_if(axis):
        return "model" if shape[axis] % _TP == 0 else None

    if path.endswith("/k") or path.endswith("/v") or path.endswith("xk") \
            or path.endswith("xv"):
        # (L, B, S, hkv, hd): shard S over model (works for any kv count).
        return P(None, batch, tp_if(2), None, None)
    if path.endswith("k_scale") or path.endswith("v_scale"):
        return P(None, batch, tp_if(2), None)
    if path.endswith("C"):
        return P(None, batch, None, tp_if(3), None)
    if path.endswith("conv"):
        return P(None, batch, None, tp_if(3))
    if path.endswith("/h") and ndim == 4:  # mamba h (L,B,di,N)
        return P(None, batch, tp_if(2), None)
    return P(None, batch, *([None] * (ndim - 2)))


def cache_specs_tree(cfg: ArchConfig, cache_shape, multi_pod: bool = False):
    """Specs of a cache tree (nested dicts of anything with ``shape``)."""
    batch = ("pod", "data") if multi_pod else "data"
    return _map(lambda p, leaf: _cache_leaf_spec(
        "/" + p, tuple(leaf.shape), batch), cache_shape)


# --------------------------------------------------------- quantized --


def mixed_operand_pspec(mo: MixedOperand, rows=None, cols=None) -> MixedSpec:
    """(payload_q, payload_bf16, payload_nib, micro_scales, tags,
    scales) specs for one mixed-layout operand, sharding its
    quantization-view rows over ``rows`` and its contraction blocks
    over ``cols``.

    All six leaves partition along the same block grid -- the packed
    4-bit NVFP4 lane holds whole (br/2, bk) nibble blocks per payload
    block and the (br, bk/16) micro-scale grid holds whole micro-scale
    rows per block, so a shard owns complete blocks together with
    *all* their metadata -- the invariant the per-shard mixed GEMM
    kernel relies on. A *compact* payload buffer (one don't-care block,
    see ``MixedOperand.compact``) is replicated: it has no row extent
    to shard and is dead weight either way. Leading stack axes
    (layer-stacked serving weights) stay unsharded.
    """
    lead = mo.tags.ndim - 2
    Rp, Kp = mo.padded_shape

    def sp(*axes) -> PartitionSpec:
        return P(*([None] * lead), *axes)

    def payload_spec(buf, full_shape) -> PartitionSpec:
        if tuple(buf.shape[-2:]) != tuple(full_shape):  # compact buffer
            return sp(None, None)
        return sp(rows, cols)

    return MixedSpec(
        payload_spec(mo.payload_q, (Rp, Kp)),
        payload_spec(mo.payload_bf16, (Rp, Kp)),
        payload_spec(mo.payload_nib, (Rp // 2, Kp)),
        payload_spec(mo.micro_scales, (Rp, Kp // NVFP4_MICRO)),
        sp(rows, cols),
        sp(rows, cols),
    )


def _axis_size(mesh, entry) -> int:
    """Ranks along a spec entry: 1 for None, else the product of the
    named axes' sizes (``mesh.axis_sizes``)."""
    if entry is None:
        return 1
    names = entry if isinstance(entry, tuple) else (entry,)
    n = 1
    for a in names:
        n *= mesh.axis_sizes[a]
    return n


def qtensor_pspec_from_dense(qt, dense_spec: PartitionSpec, mesh=None):
    """A QTensor-shaped spec from the dense rule of the (K, N) weight it
    replaced.

    The QTensor stores the weight in its transposed (N, K) quantization
    view, so a dense ``P(a_K, a_N)`` becomes rows=``a_N``,
    cols=``a_K`` on the mixed-operand leaves; stats are replicated.
    Stacked weights (dense ``P(None, a_K, a_N)``) keep the leading
    layer axis unsharded.

    With ``mesh``, an axis that does not divide the *block grid* is
    demoted to replicated: quantized leaves shard in whole blocks or not
    at all (a split block would separate payload rows from their
    tag/scale cell).
    """
    from repro_torch.serve.quantized import QTensor  # avoid import cycle

    lead = qt.mo.tags.ndim - 2
    entries = list(dense_spec) + [None] * (lead + 2 - len(dense_spec))
    a_k, a_n = entries[-2], entries[-1]
    if mesh is not None:
        nr, nk = qt.mo.tags.shape[-2], qt.mo.tags.shape[-1]
        if nr % _axis_size(mesh, a_n):
            a_n = None
        if nk % _axis_size(mesh, a_k):
            a_k = None
    mo_spec = mixed_operand_pspec(qt.mo, rows=a_n, cols=a_k)
    return QTensor(mo=mo_spec, stats=P(*([None] * qt.stats.ndim)),
                   shape=qt.shape)


def _is_qtensor(x) -> bool:
    from repro_torch.serve.quantized import QTensor  # avoid import cycle
    return isinstance(x, QTensor)


def quantized_param_specs(cfg: ArchConfig, params, mesh=None) -> Any:
    """Spec tree for a params tree whose GEMM weights were replaced by
    QTensors (``serve.quantized.quantize_params``).

    Dense leaves keep their :func:`param_specs` rule; each QTensor leaf
    derives its spec from the dense rule of the weight it replaced, so
    e.g. a row-parallel ``wo`` stays row-parallel in its (N, K)
    quantization view and the serving GEMMs stay tensor-parallel
    *without dequantizing*. ``mesh`` enables block-grid divisibility
    demotion (see :func:`qtensor_pspec_from_dense`).
    """

    def spec_for(p, leaf):
        stacked = "blocks" in p
        if _is_qtensor(leaf):
            # Dense rule on the original (K, N) shape, stack axis
            # re-inserted for layer-stacked weights, then transposed
            # into the quantization view.
            base = _leaf_spec(p, _ShapeView(leaf.shape))
            dense = P(None, *base) if leaf.is_stacked else base
            return qtensor_pspec_from_dense(leaf, dense, mesh)
        base = _leaf_spec(p, _unstacked(leaf) if stacked else leaf)
        return P(None, *base) if stacked else base

    return _map(spec_for, params)


# ------------------------------------------------ compressed opt state --


def packed_moment_pspec(pm, rows=None, mesh=None):
    """A PackedMoment-shaped spec for one packed Adam moment.

    ZeRO-style: the quantization-view *rows* shard over ``rows``
    (normally the 'data' axis) when the block grid divides the axis
    size -- whole block rows move together with their tag/scale cells,
    the same invariant as :func:`mixed_operand_pspec`. An axis that does
    not divide the block grid is demoted to replicated. The stats row is
    replicated.
    """
    from repro_torch.optim.moments import PackedMoment  # avoid cycle

    a_r = rows
    if mesh is not None and a_r is not None:
        if pm.mo.tags.shape[-2] % _axis_size(mesh, a_r):
            a_r = None
    return PackedMoment(mo=mixed_operand_pspec(pm.mo, rows=a_r, cols=None),
                        stats=P(None), shape=pm.shape)


def opt_state_specs(cfg: ArchConfig, opt_state, data_axes=("data",),
                    mesh=None):
    """An OptState-shaped spec tree for the (possibly MoR-compressed)
    optimizer state.

    Master weights and dense moment leaves get the param spec extended
    with ZeRO-1 data sharding (:func:`zero1_spec`); PackedMoment leaves
    get :func:`packed_moment_pspec` (rows over the data axis, block-grid
    divisibility demotion under ``mesh``); the error-feedback residual
    -- gradient-shaped -- reuses the master layout; ``step`` is
    replicated.
    """
    from repro_torch.optim.adamw import OptState
    from repro_torch.optim.moments import PackedMoment  # avoid cycle

    rows = data_axes if len(data_axes) > 1 else data_axes[0]
    pspecs = param_specs(cfg, opt_state.master)

    def ext(spec, leaf):
        return zero1_spec(spec, tuple(leaf.shape), data_axes)

    def moment(leaf, spec):
        if isinstance(leaf, PackedMoment):
            return packed_moment_pspec(leaf, rows=rows, mesh=mesh)
        return ext(spec, leaf)

    return OptState(
        master=_map2(lambda s, l: ext(s, l), pspecs, opt_state.master),
        m=_map2(moment, opt_state.m, pspecs),
        v=_map2(moment, opt_state.v, pspecs),
        step=P(),
        ef=(None if opt_state.ef is None
            else _map2(lambda s, l: ext(s, l), pspecs, opt_state.ef)),
    )


# ------------------------------------------------------ local shards --


def _shard_index(mesh, entry) -> int:
    """This rank's shard along a spec entry: its coordinate on the axis,
    or on a tuple of axes the row-major index over them (first name
    major), as ``NamedSharding`` numbers the shards."""
    names = entry if isinstance(entry, tuple) else (entry,)
    idx = 0
    for a in names:
        idx = idx * mesh.axis_sizes[a] + mesh.axis_index(a)
    return idx


def _cut(t: torch.Tensor, spec, mesh, name: str, grid=None):
    """This rank's piece of ``t`` under ``spec``: an owned copy where any
    dimension is cut (so the whole tensor can be freed), ``t`` itself
    where the spec replicates it. ``grid``: the block-grid extents of
    the dimensions, which the axis must divide (a quantized lane)."""
    entries = tuple(spec) + (None,) * (t.ndim - len(spec))
    if len(entries) != t.ndim:
        raise ValueError(f"{name}: spec {spec} has more entries than its "
                         f"{t.ndim} dimensions")
    out, cut = t, False
    for dim, entry in enumerate(entries):
        if entry is None:
            continue
        n = _axis_size(mesh, entry)
        extent = t.shape[dim] if grid is None else grid[dim]
        if extent % n:
            what = "dimension" if grid is None else "block grid"
            raise ValueError(
                f"{name}: {what} {extent} of dim {dim} (shape "
                f"{tuple(t.shape)}) is not divisible by mesh axis "
                f"{entry!r} ({n})")
        size = t.shape[dim] // n
        out = out.narrow(dim, _shard_index(mesh, entry) * size, size)
        cut = True
    return out.clone() if cut else t


def local_mixed(mo: MixedOperand, spec: MixedSpec, mesh,
                name: str = "operand") -> MixedOperand:
    """This rank's whole blocks of every lane of ``mo`` under ``spec``
    (:func:`mixed_operand_pspec`). Its logical shape is, along a cut
    view dimension, the local padded extent (padding blocks decode to
    zero; the last shard holds the padding), along an uncut one the
    whole operand's, as the reference's ``_local_mixed``."""
    grid = tuple(mo.tags.shape)
    lanes = {}
    for lane in MixedSpec._fields:
        t, sp = getattr(mo, lane), getattr(spec, lane)
        if all(e is None for e in sp):
            lanes[lane] = t
            continue
        lanes[lane] = _cut(t, sp, mesh, f"{name}.{lane}", grid=grid)
    lead = mo.tags.ndim - 2
    rows_cut, cols_cut = (spec.tags[lead] is not None,
                          spec.tags[lead + 1] is not None)
    tags = lanes["tags"]
    shape = (tags.shape[-2] * mo.block[0] if rows_cut else mo.shape[0],
             tags.shape[-1] * mo.block[1] if cols_cut else mo.shape[1])
    return dataclasses.replace(mo, shape=shape, **lanes)


def local_shards(tree, specs, mesh, prefix: str = ""):
    """This rank's pieces of every leaf of ``tree`` (nested dicts of
    tensors and QTensors) under ``specs`` (:func:`param_specs`,
    :func:`quantized_param_specs`, :func:`cache_specs_tree`): the
    port's form of ``device_put(tree, named_shardings(mesh, specs))``.
    A QTensor keeps whole blocks of every lane (:func:`local_mixed`) and
    its (K, N) shape becomes the local view's, transposed."""
    if isinstance(tree, dict):
        return {k: local_shards(v, specs[k], mesh,
                                f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if _is_qtensor(tree):
        mo = local_mixed(tree.mo, specs.mo, mesh, prefix)
        return dataclasses.replace(tree, mo=mo, shape=(mo.shape[1],
                                                       mo.shape[0]))
    if isinstance(tree, torch.Tensor):
        return _cut(tree, specs, mesh, prefix)
    raise TypeError(f"{prefix}: local_shards takes tensors and QTensors, "
                    f"got {type(tree).__name__}")


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec over a mesh (``jax.sharding.NamedSharding``'s counterpart):
    :meth:`shard` cuts this rank's block of a whole tensor and places it
    on the mesh's device. A leaf of a tree, not a node of one."""

    mesh: Any
    spec: PartitionSpec

    def shard(self, t: torch.Tensor, name: str = "leaf",
              dtype=None) -> torch.Tensor:
        """This rank's block of ``t`` (an axis that does not divide its
        dimension raises, naming ``name``), on the mesh's device in
        ``dtype`` (t's own by default)."""
        out = _cut(t, self.spec, self.mesh, name)
        return out.to(dtype=dtype or out.dtype, device=self.mesh.device)
