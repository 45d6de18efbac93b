"""Wrapper of the per-block-scaled fp8 GEMM kernels (``csrc/fp8_gemm.cu``),
the Hopper port of ``repro/kernels/fp8_gemm.py:fp8_gemm``.

Two routes, picked by :func:`fp8_gemm_route` from the shape and block
alone: ``wgmma`` (TMA ring, exact fp8 -> f16 conversion, f16 wgmma with
f32 accumulators) where each 64 x 128 slab of an output tile lies in one
scale block and each K block holds an even number of 64-deep K steps,
else ``cuda_core`` (an f32 outer product on CUDA cores, any block with
``bk % 32 == 0``).

The plain PyTorch version of the same function is
``kernels.ref.fp8_gemm_ref``; ``kernels.ops.fp8_gemm`` routes a CPU
tensor there and a CUDA tensor here.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import build

__all__ = ["fp8_gemm_blocks", "fp8_gemm_route", "FP8_DTYPES", "ROUTES",
           "check_fp8_gemm"]

FP8_DTYPES = (torch.float8_e4m3fn, torch.float8_e5m2)
ROUTES = ("wgmma", "cuda_core")
# The cuda_core kernel's K step: a scale block must hold whole steps.
K_STEP = 32

_P = ctypes.c_void_p
_I = ctypes.c_int


def fp8_gemm_route(M: int, N: int, K: int,
                   block: Tuple[int, int, int]) -> str:
    """The route that computes (M, N, K) under ``block``: "wgmma" where
    bm % 64 == 0, bn % 128 == 0 and bk % 128 == 0 (each MMA warpgroup's
    64 x 128 slab in one scale block, an even number of 64-deep stages in
    each K block), "cuda_core" otherwise. A pure function of its
    arguments; each launcher computes its own grid and refuses a block
    outside its route."""
    bm, bn, bk = block
    if bm % 64 == 0 and bn % 128 == 0 and bk % 128 == 0:
        return "wgmma"
    return "cuda_core"


def _fn(route: str):
    lib = build.load("fp8_gemm")
    f = lib.fp8_gemm_wgmma_launch if route == "wgmma" else lib.fp8_gemm_launch
    f.argtypes = [_P] * 5 + [_I] * 9 + [_P]
    f.restype = _I
    return f


def check_fp8_gemm(a_q, b_q, a_scale, b_scale, block, out_dtype):
    """The reference's contract, raised as errors: (M, K) x (K, N) fp8
    payloads, M, N, K divisible by the block, f32 scales of the block
    grid's shapes, bf16 or f32 out. Returns (M, N, K)."""
    if a_q.ndim != 2 or b_q.ndim != 2:
        raise ValueError(f"fp8_gemm wants 2-D operands, got "
                         f"a{tuple(a_q.shape)} b{tuple(b_q.shape)}")
    M, K = a_q.shape
    K2, N = b_q.shape
    if K != K2:
        raise ValueError(f"contraction sizes differ: a{tuple(a_q.shape)} "
                         f"b{tuple(b_q.shape)}")
    bm, bn, bk = block
    if M % bm or N % bn or K % bk:
        raise ValueError(f"(M, N, K)={(M, N, K)} is not divisible by the "
                         f"block {tuple(block)}")
    for name, t in (("a_q", a_q), ("b_q", b_q)):
        if t.dtype not in FP8_DTYPES:
            raise TypeError(f"{name} must be float8_e4m3fn or float8_e5m2, "
                            f"got {t.dtype}")
    for name, t, shape in (("a_scale", a_scale, (M // bm, K // bk)),
                           ("b_scale", b_scale, (K // bk, N // bn))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be f32 {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"out_dtype must be bf16 or f32, got {out_dtype}")
    return M, N, K


def fp8_gemm_blocks(a_q: torch.Tensor, b_q: torch.Tensor,
                    a_scale: torch.Tensor, b_scale: torch.Tensor, *,
                    block: Tuple[int, int, int] = (128, 128, 128),
                    out_dtype=torch.bfloat16) -> torch.Tensor:
    """Launch C = sum_kb (A_q B_q)_kb / sa / sb on the card: a_q (M, K)
    and b_q (K, N) fp8 (E4M3 or E5M2, each its own), f32 block scales;
    returns (M, N) in ``out_dtype``, on the route
    :func:`fp8_gemm_route` picks."""
    M, N, K = check_fp8_gemm(a_q, b_q, a_scale, b_scale, block, out_dtype)
    bm, bn, bk = block
    route = fp8_gemm_route(M, N, K, block)
    if bk % K_STEP:
        raise ValueError(f"the kernel steps K by {K_STEP}: block_k={bk} "
                         "must be a multiple of it")
    if N % 16:
        raise ValueError(f"the kernel loads 16 columns of B at once: N={N} "
                         "must be a multiple of 16")
    dev = a_q.device
    for name, t in (("a_q", a_q), ("b_q", b_q), ("a_scale", a_scale),
                    ("b_scale", b_scale)):
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name} must be a CUDA tensor on {dev}, got "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("a_q", a_q), ("b_q", b_q)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel "
                             "loads 16 bytes at once)")
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    fn = _fn(route)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(a_q.data_ptr(), b_q.data_ptr(), a_scale.data_ptr(),
                 b_scale.data_ptr(), out.data_ptr(), M, N, K, bm, bn, bk,
                 int(a_q.dtype == torch.float8_e5m2),
                 int(b_q.dtype == torch.float8_e5m2),
                 int(out_dtype == torch.float32), stream)
    if err != 0:
        raise RuntimeError(f"fp8_gemm ({route}) launch failed: CUDA error "
                           f"{err}")
    fp8_gemm_blocks.launches += 1
    fp8_gemm_blocks.launches_by_route[route] += 1
    return out


fp8_gemm_blocks.launches = 0
fp8_gemm_blocks.launches_by_route = {r: 0 for r in ROUTES}
