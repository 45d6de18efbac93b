"""Public kernel entry points with backend dispatch (port of
``repro.kernels.ops``).

``backend='auto'`` launches the CUDA kernel for a CUDA tensor and runs
the plain PyTorch version (:mod:`repro_torch.kernels.ref`) for a CPU
tensor; ``'torch'`` is an explicit request for the plain version;
``'cuda'`` insists on the kernel. A CUDA tensor never falls back to the
plain version: the kernel launches or the call raises.

One routing rule is the reference's own and is kept as it is
(:func:`_kernel_backend`): recipe-level events on 'tensor', 'channel'
and 'subchannel' partitions, and sub4 selection on a contraction block
that is not a multiple of 16, take the plain version on any device --
the reference sends them to its XLA lowering on the TPU too, since the
kernels tile (bm, bk) blocks.

The reference's ``GemmTile`` / ``decode_cache`` / ``bn_mult`` tiling
knobs are TPU VMEM choices and have no counterpart here; nor have
``flash_attention``'s ``block_q`` / ``block_k``, which are accepted and
checked but not emulated.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core.formats import (
    E4M3,
    E5M2,
    NVFP4,
    NVFP4_MICRO,
    FormatSpec,
    true_divide,
)
from repro_torch.core.collectives import pmax_over
from repro_torch.core.gam import split_mantissa_exponent
from repro_torch.core.partition import Partition

from . import ref as _ref
from .flash_attention import flash_attention_fwd, flash_layout, flash_offsets
from .fp8_gemm import check_fp8_gemm, fp8_gemm_blocks
from .gam_quant import gam_quant_blocks
from .mixed_gemm import mixed_gemm_blocks
from .mor_select import mor_select_pack, mor_select_select
from .ref import MixedOperand, MorSelect, QuantErr

__all__ = ["resolve_backend", "quant_err", "mor_select", "gam_quant",
           "quantize_pack", "mixed_gemm", "mixed_dot", "sharded_mixed_gemm",
           "fp8_gemm",
           "flash_attention", "MixedOperand", "MorSelect", "QuantErr"]


def resolve_backend(backend: str, x: torch.Tensor) -> str:
    """'torch' (plain version) or 'cuda' (kernel) for tensor ``x``."""
    if backend == "torch":
        return "torch"
    if backend == "auto":
        return "cuda" if x.is_cuda else "torch"
    if backend == "cuda":
        if not x.is_cuda:
            raise ValueError(
                "backend='cuda' needs CUDA tensors, got one on "
                f"{x.device}"
            )
        return "cuda"
    raise ValueError(
        f"unknown backend: {backend!r} (want 'auto', 'torch' or 'cuda')"
    )


def _kernel_backend(backend: str, part: Partition, x: torch.Tensor) -> str:
    """Backend of a recipe-level event: the reference's routing of
    kernel-hostile layouts. 'channel' and 'subchannel' partitions resolve
    to (1, k) rows and 'tensor' to one whole-operand block; the
    reference's kernels do not take them and it lowers those events
    through XLA on every device, so here they take the plain version
    (on a CUDA tensor too). Every 'block' partition goes to the kernel
    on a CUDA tensor."""
    be = resolve_backend(backend, x)
    if be == "cuda" and part.kind in ("tensor", "channel", "subchannel"):
        return "torch"
    return be


# Elements a stripe of _amax_abs spans: a leaf-sized |x| temporary of the
# port's largest operands (1 G elements) would cost 4 GB.
_AMAX_STRIPE = 1 << 26


def _amax_abs(x: torch.Tensor) -> torch.Tensor:
    """max |x| of a 2-D operand, or of each operand of a stack (E, M, K),
    in f32 (NaN if any element is NaN; exact in x's dtype), over row
    stripes of at most _AMAX_STRIPE elements for a large operand."""
    M, K = x.shape[-2:]
    rows = max(_AMAX_STRIPE // max(K, 1), 1)
    if M * K <= _AMAX_STRIPE or M <= rows:
        return torch.amax(x.abs(), dim=(-2, -1)).to(torch.float32)
    return torch.amax(torch.stack([torch.amax(s.abs(), dim=(-2, -1))
                                   for s in x.split(rows, dim=-2)]),
                      dim=0).to(torch.float32)


def _group_mantissa(safe_g: torch.Tensor, fmt: FormatSpec, algo: str):
    """The Alg. 1 shared mantissa m_g (1.0 for the ablation algos)."""
    if algo != "gam":
        return torch.ones((), dtype=torch.float32, device=safe_g.device)
    m_g, _ = split_mantissa_exponent(true_divide(fmt.amax, safe_g))
    return m_g


# The formats whose group mantissas the selection kernels take.
SELECT_FORMATS = (E4M3, E5M2, NVFP4)


def _group_amax(x: torch.Tensor, mesh_axes=()) -> torch.Tensor:
    """Each event's raw group amax (E,) of a stack (E, M, K), reduced over
    ``mesh_axes`` (one collective for the stack) when each rank holds a
    shard: the group amax, and the Alg. 1 mantissa derived from it, must
    be the amax of the *whole* tensor, not of this rank's shard."""
    return pmax_over(_amax_abs(x), mesh_axes)


def _kernel_inputs(x: torch.Tensor, block, fmts, algo: str, mesh_axes=()):
    """The kernels' prologue of a stack of E events (E, M, K), each its
    own group: the stack padded to the block grid, each event's raw group
    amax (E,) (over the mesh: :func:`_group_amax`), and the (E, len(fmts)
    + 1) kernel scalars (each format's group mantissa, then the guarded
    group amax), all computed once for the stack (the kernel wrappers
    then launch once an event)."""
    bm, bk = block
    _, M, K = x.shape
    pm, pk = (-M) % bm, (-K) % bk
    xp = (F.pad(x, (0, pk, 0, pm)) if pm or pk else x).contiguous()
    g_amax = _group_amax(x, mesh_axes)
    # Zero and nonfinite guard: an Inf amax would otherwise poison the
    # Alg. 1 mantissa of every block; the raw value goes to the stats'
    # guard lanes.
    safe_g = torch.where((g_amax > 0) & torch.isfinite(g_amax), g_amax,
                         torch.ones_like(g_amax))
    mg = torch.stack([_group_mantissa(safe_g, f, algo).expand(safe_g.shape)
                      for f in fmts] + [safe_g], dim=1).to(torch.float32)
    return xp, g_amax, mg.contiguous()


def _stack(ts):
    """Tensors stacked on a leading axis (one: a view)."""
    return ts[0][None] if len(ts) == 1 else torch.stack(ts)


def _stacked(parts):
    """Each field of a list of per-event results stacked on a leading
    axis (a None field stays None)."""
    return [None if f[0] is None else _stack(f) for f in zip(*parts)]


def _one(r):
    """A result of a stack of one (``QuantErr``, ``MorSelect``) without
    its leading axis."""
    return type(r)(*(None if f is None else f[0] for f in r))


def _plain_amax(x: torch.Tensor, mesh_axes):
    """Per-event group amaxes for the plain versions of a stack: None off
    a mesh (each derives its event's own), else the reduced ones."""
    return [None] * x.shape[0] if not mesh_axes else list(
        _group_amax(x, mesh_axes))


def _stacked_mixed(mos) -> MixedOperand:
    """Per-event packs stacked into one MixedOperand with a leading axis
    on every lane."""
    m = mos[0]
    lanes = ("payload_q", "payload_bf16", "tags", "scales", "payload_nib",
             "micro_scales")
    return MixedOperand(block=m.block, shape=m.shape, has_nvfp4=m.has_nvfp4,
                        **{k: _stack([getattr(o, k) for o in mos])
                           for k in lanes})


def quant_err(x: torch.Tensor, part: Partition, fmt: FormatSpec = E4M3,
              algo: str = "gam", *, backend: str = "auto",
              mesh_axes=()) -> QuantErr:
    """Fused quantize + per-block error sums of a 2-D operand: the
    event of the 'tensor' and 'e4m3' recipes. The kernel path pads to
    the block grid (zeros quantize exactly and add nothing to the sums
    or counts), computes the group amax and m_g outside the kernel (as
    the reference does) and launches ``gam_quant`` once.

    A 3-D x is a stack of E events (the MoE experts' operands, each its
    own group): every field gains a leading axis; the prologue runs once
    for the stack and the kernel launches once an event.

    ``mesh_axes``: the mesh axes x is sharded over (``MoRPolicy.
    mesh_axes``); the group amax is then reduced over them, on both
    backends."""
    if x.ndim == 2:
        return _one(_quant_err(x[None], part, fmt, algo, backend,
                               mesh_axes))
    return _quant_err(x, part, fmt, algo, backend, mesh_axes)


def _quant_err(x, part, fmt, algo, backend, mesh_axes) -> QuantErr:
    """:func:`quant_err` of a stack (E, M, K)."""
    be = _kernel_backend(backend, part, x)
    E, M, K = x.shape
    if be == "torch":
        ga = _plain_amax(x, mesh_axes)
        return QuantErr(*_stacked([_ref.quant_err_ref(x[e], part, fmt, algo,
                                                      group_amax=ga[e])
                                   for e in range(E)]))
    bm, bk = part.resolve((M, K))
    xp, g_amax, mg = _kernel_inputs(x, (bm, bk), (fmt,), algo, mesh_axes)
    xq, _, err_sums, counts = gam_quant_blocks(
        xp, mg, block=(bm, bk), q_amax=fmt.amax, fmt_dtype=fmt.dtype,
        algo=algo)
    return QuantErr(xq[:, :M, :K], err_sums, counts, g_amax, mg[:, 0])

def gam_quant(x: torch.Tensor, *, block=(128, 128), fmt: FormatSpec = E4M3,
              algo: str = "gam", backend: str = "auto"):
    """Fused quantize of a 2-D operand: (xq, block_exp, err_sums,
    counts), with ``block_exp`` the per-block E8M0 exponents."""
    be = resolve_backend(backend, x)
    part = Partition("block", tuple(block))
    if be == "torch":
        return _ref.gam_quant_ref(x, part, fmt, algo)
    M, K = x.shape
    bm, bk = part.resolve((M, K))
    xp, _, mg = _kernel_inputs(x[None], (bm, bk), (fmt,), algo)
    xq, block_exp, err_sums, counts = gam_quant_blocks(
        xp[0], mg[0], block=(bm, bk), q_amax=fmt.amax, fmt_dtype=fmt.dtype,
        algo=algo)
    return xq[:M, :K], block_exp, err_sums, counts


def mor_select(x: torch.Tensor, part: Partition, mode: str = "sub3",
               algo: str = "gam", *, backend: str = "auto",
               mesh_axes=()) -> MorSelect:
    """Fused sub-tensor MoR selection (sub2/sub3/sub4) of a 2-D operand
    with the fake-quant output ``y`` in x's dtype: one
    ``mor_select_select`` launch on a CUDA tensor, of the kernel's
    instance for x's dtype (bf16, or f32 as the gradient compression's
    views are). A stack of events and ``mesh_axes`` as in
    :func:`quant_err`."""
    if x.ndim == 2:
        return _one(_mor_select(x[None], part, mode, algo, backend,
                                mesh_axes))
    return _mor_select(x, part, mode, algo, backend, mesh_axes)


def _mor_select(x, part, mode, algo, backend, mesh_axes) -> MorSelect:
    """:func:`mor_select` of a stack (E, M, K)."""
    be = _kernel_backend(backend, part, x)
    E, M, K = x.shape
    bm, bk = part.resolve((M, K))
    if mode == "sub4" and bk % NVFP4_MICRO:
        # Micro blocks need 16-divisible contraction blocks; the sub4
        # recipe's aligned partition guarantees it, and the reference
        # sends other callers to its XLA path.
        be = "torch"
    if be == "torch":
        ga = _plain_amax(x, mesh_axes)
        return MorSelect(*_stacked([_ref.mor_select_ref(x[e], part, mode,
                                                        algo, ga[e])
                                    for e in range(E)]))
    xp, g_amax, mg = _kernel_inputs(x, (bm, bk), SELECT_FORMATS, algo,
                                    mesh_axes)
    f = mor_select_select(xp, mg, block=(bm, bk), mode=mode, algo=algo)
    return MorSelect(
        y=f["y"][:, :M, :K], sel=f["sel"], e4_sums=f["e4_sums"],
        e5_sums=f["e5_sums"], counts=f["counts"], group_amax=g_amax,
        group_mantissa=mg[:, 0], nv_sums=f.get("nv_sums"))


def quantize_pack(x: torch.Tensor, part: Partition, mode: str = "sub3",
                  algo: str = "gam", *, backend: str = "auto",
                  mesh_axes=()):
    """One-pass sub-tensor selection *and* real packing of a 2-D
    operand: returns ``(MixedOperand, MorSelect)`` with ``y=None``.

    The kernel path pads the operand to the block grid, computes the
    group amax and the three Alg. 1 group mantissas outside the kernel
    (as the reference does), and launches ``mor_select_pack`` once. A
    stack of events and ``mesh_axes`` as in :func:`quant_err`: one
    MixedOperand with a leading axis on every lane.
    """
    if x.ndim == 2:
        mo, r = _quantize_pack(x[None], part, mode, algo, backend,
                               mesh_axes)
        return mo.stack_index(0), _one(r)
    return _quantize_pack(x, part, mode, algo, backend, mesh_axes)


def _quantize_pack(x, part, mode, algo, backend, mesh_axes):
    """:func:`quantize_pack` of a stack (E, M, K)."""
    be = _kernel_backend(backend, part, x)
    E, M, K = x.shape
    bm, bk = part.resolve((M, K))
    if be == "torch":
        ga = _plain_amax(x, mesh_axes)
        packs = [_ref.quantize_pack_ref(x[e], part, mode, algo, ga[e])
                 for e in range(E)]
        return (_stacked_mixed([p[0] for p in packs]),
                MorSelect(*_stacked([p[1] for p in packs])))
    xp, g_amax, mg = _kernel_inputs(x, (bm, bk), SELECT_FORMATS, algo,
                                    mesh_axes)
    return _pack_launch(xp, g_amax, mg, (bm, bk), (M, K), mode, algo)

def _pack_launch(xp, g_amax, mg, block, shape, mode: str, algo: str):
    """``mor_select_pack`` on a padded stack of operands (one launch
    each; every lane has the leading axis): (MixedOperand, MorSelect with
    y=None)."""
    bm, bk = block
    if mode == "sub4" and not _ref.nvfp4_block_capable((bm, bk)):
        raise ValueError(
            f"sub4 packing needs an even-row, {NVFP4_MICRO}-divisible-"
            f"column block, got {(bm, bk)}"
        )
    out = mor_select_pack(xp, mg, block=(bm, bk), mode=mode, algo=algo)
    mo = MixedOperand(
        payload_q=out["payload_q"],
        payload_bf16=out["payload_bf16"],
        tags=out["sel"],
        scales=out["scales"],
        block=(bm, bk),
        shape=tuple(shape),
        payload_nib=out.get("payload_nib"),
        micro_scales=out.get("micro_scales"),
        has_nvfp4=(mode == "sub4"),
    )
    r = MorSelect(
        y=None, sel=out["sel"], e4_sums=out["e4_sums"],
        e5_sums=out["e5_sums"], counts=out["counts"], group_amax=g_amax,
        group_mantissa=mg[:, 0], nv_sums=out.get("nv_sums"),
    )
    return mo, r


def mixed_gemm(a: MixedOperand, b: MixedOperand, *,
               out_dtype=torch.bfloat16, backend: str = "auto", tile=None,
               _plan=None):
    """C = A @ B^T over two mixed operands, unpadded (M, N): every block
    decoded per its tag to its stored value, f32 accumulation.
    ``tile`` (the reference's TPU VMEM tiling, a ``GemmTile``) is
    accepted and ignored: the CUDA kernels plan their own tiles.
    ``_plan`` (internal, :func:`sharded_mixed_gemm`) plans the launch by
    another (M, N) than the operands' (``mixed_gemm_blocks``)."""
    be = resolve_backend(backend, b.tags)
    if be == "torch":
        return _ref.mixed_gemm_ref(a, b, out_dtype)
    return mixed_gemm_blocks(a, b, out_dtype=out_dtype, _plan=_plan)


def mixed_dot(x2: torch.Tensor, mo: MixedOperand, *,
              out_dtype=torch.bfloat16, backend: str = "auto", tile=None):
    """x2 @ W^T for an unquantized (M, K) activation against a mixed
    (N, K)-view weight: the activation becomes an all-BF16 pack with a
    row block sized to it (decode steps have a handful of rows).
    ``tile`` is accepted and ignored, as in :func:`mixed_gemm`."""
    bk = mo.block[1]
    a = _ref.passthrough_mixed(
        x2, (_ref.activation_row_block(x2.shape[0], bk), bk)
    )
    return mixed_gemm(a, mo, out_dtype=out_dtype, backend=backend)


def _local_mixed(mo: MixedOperand, rows_cut: bool,
                 cols_cut: bool) -> MixedOperand:
    """A shard-local operand whose logical extent along a cut dimension is
    its padded one: per-shard padding blocks decode to zeros, so they add
    nothing to the product, and the caller trims the assembled output to
    the logical (M, N) once (the reference's ``_local_mixed``)."""
    Rp, Kp = mo.padded_shape
    shape = (Rp if rows_cut else mo.shape[0], Kp if cols_cut else mo.shape[1])
    return mo if shape == tuple(mo.shape) else dataclasses.replace(
        mo, shape=shape)


def sharded_mixed_gemm(a: MixedOperand, b: MixedOperand, *, mesh,
                       row_axis=None, col_axis=None, contract_axis=None,
                       out_dtype=torch.bfloat16, backend: str = "auto"
                       ) -> torch.Tensor:
    """Mesh-sharded mixed-representation GEMM, C = A @ B^T: the body of
    the reference's ``shard_map`` and its ``psum``, on this rank.

    ``a`` and ``b`` are this rank's local operands, as
    ``sharding.rules.local_mixed`` / ``local_shards`` cut them (whole
    blocks with their tags and scales). Returns this rank's block of C:
    the rows of its ``row_axis`` shard and the columns of its
    ``col_axis`` shard, padded to whole blocks along a sharded dimension
    (the last shard holds the padding; the caller trims the assembled
    output once), logical along an unsharded one.

      row_axis       shards A's rows      -> C rows sharded, no traffic.
      col_axis       shards B's rows      -> C cols sharded, no traffic.
      contract_axis  shards K of both     -> per-shard f32 partials are
                     summed over the axis (``psum_over``, in rank order,
                     so every rank holds the same sum), then cast once.

    Without ``contract_axis`` each output sums all of K on one rank, in
    the order of the one-rank GEMM: on the card the launch is planned by
    the whole product's (M, N) (``mixed_gemm_blocks``' ``_plan``), since
    the stream path's split of K depends on N and its choice of path on
    M. The divisibility of the block grid by the mesh axes is checked
    where the global grid is known, in ``local_shards``.
    """
    from repro_torch.core.collectives import psum_over, use_mesh

    if a.block[1] != b.block[1] or a.padded_shape[1] != b.padded_shape[1]:
        raise ValueError(
            f"contraction blocks differ: {a.block}/{a.padded_shape} vs "
            f"{b.block}/{b.padded_shape}")
    sizes = mesh.axis_sizes
    for ax in (row_axis, col_axis, contract_axis):
        if ax is not None and ax not in sizes:
            raise ValueError(f"mesh axis {ax!r} is not one of "
                             f"{tuple(sizes)}")
    a = _local_mixed(a, row_axis is not None, contract_axis is not None)
    b = _local_mixed(b, col_axis is not None, contract_axis is not None)
    plan = None
    if contract_axis is None:
        plan = (a.shape[0] * (sizes[row_axis] if row_axis else 1),
                b.shape[0] * (sizes[col_axis] if col_axis else 1))
    inner = torch.float32 if contract_axis else out_dtype
    out = mixed_gemm(a, b, out_dtype=inner, backend=backend, _plan=plan)
    if contract_axis is None:
        return out
    with use_mesh(mesh):
        return psum_over(out, (contract_axis,)).to(out_dtype)


def fp8_gemm(a_q: torch.Tensor, b_q: torch.Tensor, a_scale: torch.Tensor,
             b_scale: torch.Tensor, *, block=(128, 128, 128),
             out_dtype=torch.bfloat16, backend: str = "auto"):
    """Per-block-scaled fp8 GEMM: a_q (M, K) and b_q (K, N) fp8 payloads
    (E4M3 or E5M2), a_scale (M/bm, K/bk) and b_scale (K/bk, N/bn) f32;
    returns the dequantized product (M, N) in ``out_dtype``."""
    block = tuple(block)
    if resolve_backend(backend, a_q) == "torch":
        check_fp8_gemm(a_q, b_q, a_scale, b_scale, block, out_dtype)
        return _ref.fp8_gemm_ref(a_q, b_q, a_scale, b_scale, block,
                                 out_dtype)
    return fp8_gemm_blocks(a_q, b_q, a_scale, b_scale, block=block,
                           out_dtype=out_dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset=None, block_q: int = 512,
                    block_k: int = 512, backend: str = "auto"):
    """Flash attention forward in the reference's two layouts.

    * 4-D GQA contract: q ``(B, S, Hq, dh)`` against k / v
      ``(B, T, Hkv, dh)`` with ``Hq % Hkv == 0``; query head ``h`` reads
      kv head ``h // (Hq // Hkv)``; returns ``(B, S, Hq, dh)``.
      ``q_offset`` is a scalar, per batch row ``(B,)`` (repeated over the
      heads) or per folded row ``(B*Hq,)``.
    * 3-D folded ``(BH, S|T, d)`` passthrough; ``q_offset`` scalar or
      ``(BH,)``.

    ``q_offset`` is the key position of query row 0 (default ``T - S``:
    the last query at the last key); ignored when not causal. The kernel
    reads the GQA layout in place; the plain version folds q and repeats
    the kv heads, as the reference does.
    """
    if q.ndim == 4:
        B, S, Hq, dh = q.shape
        if k.ndim != 4 or v.ndim != 4 or k.shape != v.shape:
            raise ValueError(f"4-D q needs matching 4-D k/v, got "
                             f"k{tuple(k.shape)} v{tuple(v.shape)}")
        flash_layout(q, k, v, block_q, block_k)
        off = q_offset
        if off is not None:
            off = torch.as_tensor(off, dtype=torch.int32).reshape(-1)
            if off.shape[0] == B and B != B * Hq:
                off = torch.repeat_interleave(off, Hq)
        if resolve_backend(backend, q) == "cuda":
            return flash_attention_fwd(q, k, v, causal=causal, q_offset=off,
                                       block_q=block_q, block_k=block_k)
        G = Hq // k.shape[2]

        def fold(x):  # (B, L, H, dh) -> (B*H, L, dh)
            return x.movedim(2, 1).reshape(B * x.shape[2], x.shape[1], dh)

        kf = fold(k.repeat_interleave(G, dim=2) if G > 1 else k)
        vf = fold(v.repeat_interleave(G, dim=2) if G > 1 else v)
        out = flash_attention(fold(q), kf, vf, causal=causal, q_offset=off,
                              block_q=block_q, block_k=block_k,
                              backend="torch")
        return out.reshape(B, Hq, S, dh).movedim(1, 2).contiguous()
    if resolve_backend(backend, q) == "cuda":
        return flash_attention_fwd(q, k, v, causal=causal, q_offset=q_offset,
                                   block_q=block_q, block_k=block_k)
    B, _, _, S, T, _, _, _ = flash_layout(q, k, v, block_q, block_k)
    off = flash_offsets(q_offset, S, T, B, q.device)
    return _ref.flash_attention_ref(q, k, v, causal, off)
