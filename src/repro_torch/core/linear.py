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

A weight that is already real-quantized (``serve.quantized.QTensor``;
anything exposing ``as_mixed_operand()``) is consumed directly by the
mixed kernel against a BF16-passthrough activation pack (serving): a
backward through it raises, as the reference's ``_bwd`` does.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import ops as kops

from .device import ieee_f32_matmul, resolve_device
from .mor import STATS_WIDTH, mor_quantize, quantize_for_gemm
from .policy import MoRDotPolicy

__all__ = ["N_FWD_EVENTS", "N_BWD_EVENTS", "new_token", "mor_dot"]

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
    return hasattr(w, "as_mixed_operand")


def _dot(a: torch.Tensor, b_t: torch.Tensor, out_dtype) -> torch.Tensor:
    """a @ b_t^T: exact products of the operands, f32 accumulation, one
    rounding to ``out_dtype``. On CUDA, cuBLAS runs with
    ``allow_bf16_reduced_precision_reduction`` off for this call only; the
    caller's setting is restored after it. The f32 product runs in full
    f32 whatever the caller's TF32 setting."""
    if a.is_cuda and a.dtype == b_t.dtype == out_dtype == torch.bfloat16:
        flags = torch.backends.cuda.matmul
        user = flags.allow_bf16_reduced_precision_reduction
        flags.allow_bf16_reduced_precision_reduction = False
        try:
            return torch.matmul(a, b_t.T)
        finally:
            flags.allow_bf16_reduced_precision_reduction = user
    with ieee_f32_matmul():
        return (a.to(torch.float32) @ b_t.to(torch.float32).T).to(out_dtype)


def _zero_stats(n: int, device) -> torch.Tensor:
    return torch.zeros((n, STATS_WIDTH), dtype=torch.float32, device=device)


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


def _fwd(x, w, policy: MoRDotPolicy):
    x2, lead = _flat2d(x)
    if _is_mixed_weight(w):
        y = kops.mixed_dot(x2, w.as_mixed_operand(), out_dtype=x.dtype,
                           backend=policy.weight.backend)
        return (y.reshape(*lead, w.shape[1]),
                _zero_stats(N_FWD_EVENTS, x.device))
    if not policy.enabled:
        return (_dot(x2, w.T, x.dtype).reshape(*lead, w.shape[1]),
                _zero_stats(N_FWD_EVENTS, x.device))
    if policy.fuse_gemm:
        _check_fusable(policy)
        # Activation (M, K) and weight (N, K) events, both packed for
        # real with the contraction last.
        a_mo, x_stats = quantize_for_gemm(x2, policy.act)
        b_mo, w_stats = quantize_for_gemm(w.T, policy.weight)
        y = kops.mixed_gemm(a_mo, b_mo, out_dtype=x.dtype,
                            backend=policy.act.backend)
    else:
        xq, x_stats = mor_quantize(x2, policy.act)
        # w is (K, N), contraction first: quantize the (N, K) view so
        # blocks align with the dot axis.
        wq_t, w_stats = mor_quantize(w.T, policy.weight)
        y = _dot(xq, wq_t, x.dtype)
    return y.reshape(*lead, w.shape[1]), torch.stack([x_stats, w_stats])


def _bwd_fused(policy: MoRDotPolicy, x2, dy2, lead, x, w):
    """dgrad + wgrad through the mixed kernel, event for event as the
    fake-quant branch (same stats rows)."""
    be = policy.grad.backend
    # dgrad: dx[m, k] = sum_n dy[m, n] w[k, n].
    dy_mo, dy_stats = quantize_for_gemm(dy2, policy.grad)   # (M, N)
    w_mo, w_stats = quantize_for_gemm(w, policy.weight)     # (K, N)
    dx = kops.mixed_gemm(dy_mo, w_mo, out_dtype=x.dtype,
                         backend=be).reshape(*lead, x.shape[-1])
    # wgrad: dw[k, n] = sum_m x[m, k] dy[m, n].
    if _transpose_invariant(policy.act) and _transpose_invariant(policy.grad):
        # Q(x^T) == Q(x)^T bit for bit: transpose the (M, K) pack and
        # reuse the dy pack outright.
        x_mo, xT_stats = quantize_for_gemm(x2, policy.act)
        dw = kops.mixed_gemm(x_mo.transpose(), dy_mo.transpose(),
                             out_dtype=w.dtype, backend=be)
        dyT_stats = dy_stats
    else:
        xT_mo, xT_stats = quantize_for_gemm(x2.T, policy.act)      # (K, M)
        dyT_mo, dyT_stats = quantize_for_gemm(dy2.T, policy.grad)  # (N, M)
        dw = kops.mixed_gemm(xT_mo, dyT_mo, out_dtype=w.dtype, backend=be)
    return dx, dw, torch.stack([dy_stats, w_stats, xT_stats, dyT_stats])


def _bwd(policy: MoRDotPolicy, x, w, dy):
    dy2, _ = _flat2d(dy)
    x2, lead = _flat2d(x)
    if not (policy.enabled and policy.quantize_bwd):
        dx = _dot(dy2, w, x.dtype).reshape(x.shape)
        dw = _dot(x2.T, dy2.T, w.dtype)
        return dx, dw, _zero_stats(N_BWD_EVENTS, x.device)
    if policy.fuse_gemm:
        _check_fusable(policy)
        return _bwd_fused(policy, x2, dy2, lead, x, w)
    # dgrad: dx[m, k] = sum_n dy[m, n] w[k, n].
    dyq, dy_stats = mor_quantize(dy2, policy.grad)    # (M, N)
    w_kn, w_stats = mor_quantize(w, policy.weight)    # (K, N)
    dx = _dot(dyq, w_kn, x.dtype).reshape(*lead, x.shape[-1])
    # wgrad: dw[k, n] = sum_m x[m, k] dy[m, n].
    if _transpose_invariant(policy.act) and _transpose_invariant(policy.grad):
        # Q(x^T) == Q(x)^T: re-use the dy event, quantize x once.
        xTq, xT_stats = mor_quantize(x2, policy.act)
        dyT_stats = dy_stats
        dw = _dot(xTq.T, dyq.T, w.dtype)
    else:
        xTq, xT_stats = mor_quantize(x2.T, policy.act)     # (K, M)
        dyTq, dyT_stats = mor_quantize(dy2.T, policy.grad)  # (N, M)
        dw = _dot(xTq, dyTq, w.dtype)
    return dx, dw, torch.stack([dy_stats, w_stats, xT_stats, dyT_stats])


class _ServeDot(torch.autograd.Function):
    """``mor_dot`` against a real-quantized (QTensor) weight: the forward
    is the serving product, and a backward raises the reference's error
    (its ``_bwd``) instead of differentiating the plain version's ops (on
    the CPU) or dropping x's gradient (on CUDA)."""

    @staticmethod
    def forward(ctx, x, w, policy):
        y, fwd_stats = _fwd(x, w, policy)
        ctx.mark_non_differentiable(fwd_stats)
        return y, fwd_stats

    @staticmethod
    def backward(ctx, dy, _dstats):
        raise NotImplementedError(
            "mor_dot cannot differentiate through a real-quantized "
            "(QTensor) serving weight")


class _MorDot(torch.autograd.Function):
    """The reference's ``custom_vjp``: forward stats as an output,
    backward stats as the token's gradient."""

    @staticmethod
    def forward(ctx, x, w, token, policy):
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
    return _MorDot.apply(x, w, token, policy)
