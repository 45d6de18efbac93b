"""mor_dot: the MoR-quantized GEMM primitive (port of
``repro.core.linear``).

For a linear layer ``y = x @ w`` each operand of the three GEMMs is one
quantization event under the policy:

  forward:   y  = Q(x) @ Q(w)          (act + weight events)
  backward:  dx = Q(dy) @ Q(w)^T       (grad + weight events)
             dw = Q(x^T) @ Q(dy^T)     (act^T + grad^T events)

Each event sees its operand as a 2-D view whose last axis is that GEMM's
contraction axis. The forward stats are an output; the backward stats
leave :class:`_MorDot`'s backward as the gradient of a zero ``token``
(:func:`new_token`, a (N_BWD_EVENTS, STATS_WIDTH) f32 tensor that
requires grad), the reference's functional stats channel.

GEMM lowerings (``MoRDotPolicy.fuse_gemm``):

  * fake-quant (default): each event writes its fake-quantized bf16
    values and the three GEMMs are plain products with bf16 operands,
    f32 accumulation and one rounding to the output dtype, as the
    reference's ``jnp.dot(..., preferred_element_type=f32)``. On a CUDA
    tensor they are cuBLAS bf16 GEMMs with
    ``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``
    set to False (cuBLAS may otherwise reduce split-K partials in bf16);
    :func:`_dot` sets it. On the CPU they multiply in f32.
  * fused: each event packs real payloads (``core.mor.quantize_for_gemm``)
    and all three GEMMs run through the mixed-representation kernel
    (``kernels.ops.mixed_gemm``).

A weight that is already real-quantized (``serve.quantized.QTensor``,
or a rank's ``ShardedQTensor``: anything with a ``serve_dot``) runs its
own serving product, the mixed kernel against a BF16-passthrough
activation pack: a backward through it raises, as the reference's
``_bwd`` does.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import ops as kops

from .device import ieee_f32_matmul, resolve_device
from .mor import STATS_WIDTH, mor_quantize, quantize_for_gemm
from .policy import MoRDotPolicy

__all__ = ["N_FWD_EVENTS", "N_BWD_EVENTS", "new_token", "mor_dot",
           "mor_dot_experts"]

N_FWD_EVENTS = 2  # x, w
N_BWD_EVENTS = 4  # dy(dgrad), w(dgrad), x^T(wgrad), dy^T(wgrad)


def new_token(device="cuda", requires_grad: bool = True) -> torch.Tensor:
    """Zero token whose gradient carries the N_BWD_EVENTS stats rows, on
    ``device`` (CUDA unless the caller asks for the CPU)."""
    return torch.zeros((N_BWD_EVENTS, STATS_WIDTH), dtype=torch.float32,
                       device=resolve_device(device),
                       requires_grad=requires_grad)


def _flat2d(x: torch.Tensor):
    return x.reshape(-1, x.shape[-1]), tuple(x.shape[:-1])


def _is_mixed_weight(w) -> bool:
    """A real-quantized serving weight: one with its own product
    (``serve.quantized.QTensor`` / ``ShardedQTensor.serve_dot``)."""
    return hasattr(w, "serve_dot")


def _dot(a: torch.Tensor, b_t: torch.Tensor, out_dtype) -> torch.Tensor:
    """a @ b_t^T (of each expert, for (E, ., .) stacks): exact products
    of the operands, f32 accumulation, one rounding to ``out_dtype``. On
    CUDA, cuBLAS runs with ``allow_bf16_reduced_precision_reduction`` off
    for this call only; the caller's setting is restored after it. The
    f32 product runs in full f32 whatever the caller's TF32 setting."""
    if a.ndim == 3 and a.shape[0] == 1:
        # One product (every mor_dot): the single-matrix GEMM, not the
        # batched one, whose kernel choice (and order of sums) may differ.
        return _dot(a[0], b_t[0], out_dtype)[None]
    if a.is_cuda and a.dtype == b_t.dtype == out_dtype == torch.bfloat16:
        flags = torch.backends.cuda.matmul
        user = flags.allow_bf16_reduced_precision_reduction
        flags.allow_bf16_reduced_precision_reduction = False
        try:
            return torch.matmul(a, b_t.mT)
        finally:
            flags.allow_bf16_reduced_precision_reduction = user
    with ieee_f32_matmul():
        return (a.to(torch.float32) @ b_t.to(torch.float32).mT).to(out_dtype)


def _zero_stats(n, device) -> torch.Tensor:
    lead = n if isinstance(n, tuple) else (n,)
    return torch.zeros((*lead, STATS_WIDTH), dtype=torch.float32,
                       device=device)


def _check_fusable(policy: MoRDotPolicy):
    """The mixed GEMM tiles all three products with one block grid:
    every enabled operand policy must be 'block'-partitioned with one
    shared block shape (disabled events pack as BF16 passthrough on the
    same grid, so theirs must agree too)."""
    ps = [("act", policy.act), ("weight", policy.weight)]
    if policy.quantize_bwd:
        ps.append(("grad", policy.grad))
    shapes = set()
    for name, p in ps:
        shapes.add(tuple(p.block_shape))
        if p.enabled and p.partition != "block":
            raise ValueError(
                f"fuse_gemm=True needs partition='block' for the {name} "
                f"policy (got {p.partition!r})")
    if len(shapes) > 1:
        raise ValueError(
            f"fuse_gemm=True needs one shared block_shape, got {shapes}")


def _transpose_invariant(p) -> bool:
    """Quantizing the transposed view == transposing the quantized view:
    true for per-tensor scaling and square per-block scaling, false for
    per-channel / sub-channel scaling and for sub4 (micro blocks and
    nibble pairing follow the contraction axis)."""
    if p.recipe == "sub4":
        return False
    if p.partition == "tensor":
        return True
    return p.partition == "block" and p.block_shape[0] == p.block_shape[1]


def _gemms(a_mo, b_mo, out_dtype, backend, transpose=False):
    """The mixed GEMM of each entry's pair of packs (one launch an
    entry), stacked."""
    ys = []
    for e in range(a_mo.tags.shape[0]):
        a, b = a_mo.stack_index(e), b_mo.stack_index(e)
        if transpose:
            a, b = a.transpose(), b.transpose()
        ys.append(kops.mixed_gemm(a, b, out_dtype=out_dtype,
                                  backend=backend))
    return ys[0][None] if len(ys) == 1 else torch.stack(ys)


def _fwd(x, w, policy: MoRDotPolicy):
    """y and the forward stats of a stack of E products: x (E, M, K), w
    (E, K, N). Each entry's events are its own (its own group amax and
    stats row); the quantizers' host work runs once for the stack."""
    E = x.shape[0]
    wt = w.transpose(1, 2)  # (E, N, K): contraction last
    if not policy.enabled:
        return _dot(x, wt, x.dtype), _zero_stats((E, N_FWD_EVENTS),
                                                 x.device)
    if policy.fuse_gemm:
        _check_fusable(policy)
        # Activation (M, K) and weight (N, K) events, both packed for
        # real with the contraction last.
        a_mo, x_stats = quantize_for_gemm(x, policy.act)
        b_mo, w_stats = quantize_for_gemm(wt, policy.weight)
        y = _gemms(a_mo, b_mo, x.dtype, policy.act.backend)
    else:
        xq, x_stats = mor_quantize(x, policy.act)
        # w is (K, N), contraction first: quantize the (N, K) view so
        # blocks align with the dot axis.
        wq_t, w_stats = mor_quantize(wt, policy.weight)
        y = _dot(xq, wq_t, x.dtype)
    return y, torch.stack([x_stats, w_stats], dim=1)


def _bwd(policy: MoRDotPolicy, x, w, dy):
    """dx, dw and the backward stats of a stack (dy (E, M, N)); fused,
    event for event as the fake-quant branch (same stats rows)."""
    E = x.shape[0]
    if not (policy.enabled and policy.quantize_bwd):
        dx = _dot(dy, w, x.dtype)
        dw = _dot(x.transpose(1, 2), dy.transpose(1, 2), w.dtype)
        return dx, dw, _zero_stats((E, N_BWD_EVENTS), x.device)
    # Q(x^T) == Q(x)^T bit for bit: quantize x once, reuse the dy event.
    inv = (_transpose_invariant(policy.act)
           and _transpose_invariant(policy.grad))
    if policy.fuse_gemm:
        _check_fusable(policy)
        be = policy.grad.backend
        # dgrad: dx[m, k] = sum_n dy[m, n] w[k, n].
        dy_mo, dy_stats = quantize_for_gemm(dy, policy.grad)  # (M, N)
        w_mo, w_stats = quantize_for_gemm(w, policy.weight)   # (K, N)
        dx = _gemms(dy_mo, w_mo, x.dtype, be)
        # wgrad: dw[k, n] = sum_m x[m, k] dy[m, n].
        if inv:
            x_mo, xT_stats = quantize_for_gemm(x, policy.act)
            dw = _gemms(x_mo, dy_mo, w.dtype, be, transpose=True)
            dyT_stats = dy_stats
        else:
            xT_mo, xT_stats = quantize_for_gemm(x.transpose(1, 2),
                                                policy.act)   # (K, M)
            dyT_mo, dyT_stats = quantize_for_gemm(dy.transpose(1, 2),
                                                  policy.grad)  # (N, M)
            dw = _gemms(xT_mo, dyT_mo, w.dtype, be)
    else:
        dyq, dy_stats = mor_quantize(dy, policy.grad)
        w_kn, w_stats = mor_quantize(w, policy.weight)
        dx = _dot(dyq, w_kn, x.dtype)
        if inv:
            xTq, xT_stats = mor_quantize(x, policy.act)
            dyT_stats = dy_stats
            dw = _dot(xTq.transpose(1, 2), dyq.transpose(1, 2), w.dtype)
        else:
            xTq, xT_stats = mor_quantize(x.transpose(1, 2), policy.act)
            dyTq, dyT_stats = mor_quantize(dy.transpose(1, 2), policy.grad)
            dw = _dot(xTq, dyTq, w.dtype)
    return dx, dw, torch.stack([dy_stats, w_stats, xT_stats, dyT_stats],
                               dim=1)


class _ServeDot(torch.autograd.Function):
    """``mor_dot`` against a real-quantized (QTensor) weight: the forward
    is the serving product, and a backward raises the reference's error
    (its ``_bwd``) instead of differentiating the plain version's ops (on
    the CPU) or dropping x's gradient (on CUDA)."""

    @staticmethod
    def forward(ctx, x, w, policy):
        x2, lead = _flat2d(x)
        y = w.serve_dot(x2, out_dtype=x.dtype,
                        backend=policy.weight.backend)
        fwd_stats = _zero_stats(N_FWD_EVENTS, x.device)
        ctx.mark_non_differentiable(fwd_stats)
        return y.reshape(*lead, w.shape[1]), fwd_stats

    @staticmethod
    def backward(ctx, dy, _dstats):
        raise NotImplementedError(
            "mor_dot cannot differentiate through a real-quantized "
            "(QTensor) serving weight")


class _MorDot(torch.autograd.Function):
    """The reference's ``custom_vjp`` over a stack of products (its
    ``vmap(mor_dot)``; ``mor_dot`` is the stack of one): forward stats as
    an output, backward stats as the tokens' gradient."""

    @staticmethod
    def forward(ctx, x, w, tokens, policy):
        y, fwd_stats = _fwd(x, w, policy)
        ctx.save_for_backward(x, w)
        ctx.policy = policy
        ctx.mark_non_differentiable(fwd_stats)
        return y, fwd_stats

    @staticmethod
    def backward(ctx, dy, _dstats):
        x, w = ctx.saved_tensors
        dx, dw, token_grad = _bwd(ctx.policy, x, w, dy)
        return dx, dw, token_grad, None


def mor_dot(x: torch.Tensor, w, token: Optional[torch.Tensor],
            policy: MoRDotPolicy) -> Tuple[torch.Tensor, torch.Tensor]:
    """y = MoR(x) @ MoR(w). x: (..., K), w: (K, N) or a QTensor, token:
    :func:`new_token` (or None where nothing differentiates, as in
    serving).

    Returns (y: (..., N) in x.dtype, fwd_stats (N_FWD_EVENTS,
    STATS_WIDTH)); the serving and disabled paths report zero stats.
    """
    if _is_mixed_weight(w):
        return _ServeDot.apply(x, w, policy)
    if token is None:
        token = new_token(x.device, requires_grad=False)
    x2, lead = _flat2d(x)
    y, fwd_stats = _MorDot.apply(x2[None], w[None], token[None], policy)
    return y[0].reshape(*lead, w.shape[1]), fwd_stats.squeeze(0)


def mor_dot_experts(x: torch.Tensor, w: torch.Tensor,
                    tokens: Optional[torch.Tensor], policy: MoRDotPolicy
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``mor_dot`` of each expert, the reference's ``jax.vmap(mor_dot)``
    over the MoE experts: x (E, M, K), w (E, K, N), tokens (E,
    N_BWD_EVENTS, STATS_WIDTH) or None. Returns (y (E, M, N), fwd_stats
    (E, N_FWD_EVENTS, STATS_WIDTH)); the backward stats reach ``tokens``
    as their gradient. Expert e's values and stats are those of
    ``mor_dot(x[e], w[e], tokens[e], policy)``: its events keep their
    own groups and the kernels launch once an expert, while the work
    around them (group amaxes, mantissas, stats, the fake-quant GEMMs)
    runs once for the stack."""
    if x.ndim != 3 or w.ndim != 3 or x.shape[0] != w.shape[0]:
        raise ValueError(f"mor_dot_experts wants x (E, M, K) and w (E, K, "
                         f"N), got {tuple(x.shape)} and {tuple(w.shape)}")
    if tokens is None:
        tokens = torch.zeros((x.shape[0], N_BWD_EVENTS, STATS_WIDTH),
                             dtype=torch.float32, device=x.device)
    return _MorDot.apply(x, w, tokens, policy)
