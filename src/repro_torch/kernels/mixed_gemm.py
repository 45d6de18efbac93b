"""Wrapper of the mixed-representation block GEMM kernel
(``csrc/mixed_gemm.cu``), the Hopper port of
``repro/kernels/mixed_gemm.py:mixed_gemm_blocks``.

The kernel has two paths, chosen by :func:`gemm_path` from M alone:
``'stream'`` (M <= 64: decode steps, prefill chunks, the f32 head; the
weight streamed once through per-block decode tables into bf16 tensor-core
products, K split as :func:`stream_plan` says) and ``'tc'`` (larger M:
the training GEMMs; bf16 tensor cores on operands decoded once to bf16).
Both compute the same function; there is no fallback from one to the
other. ``mixed_gemm_blocks.launches`` counts every launch and
``mixed_gemm_blocks.launches_by_path`` each path's.

The plain PyTorch version of the same function is
``kernels.ref.mixed_gemm_ref``; ``kernels.ops.mixed_gemm`` routes a CPU
tensor there and a CUDA tensor here.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.formats import NVFP4_MICRO

from . import build
from .ref import MixedOperand, compact_lane_shapes, nvfp4_block_capable

__all__ = ["mixed_gemm_blocks", "gemm_path", "stream_plan", "stream_rows",
           "stream_workspace_floats", "STREAM_MAX_M"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# Largest M the streaming path takes: decode (M = slots), prefill chunks
# and the head have a handful of rows and are bound by the weight's
# bytes; above it the tensor-core path's 128-row tiles are filled.
STREAM_MAX_M = 64
# The stream kernel's thread block: 128 weight rows, K in 64-deep chunks.
STREAM_ROWS, STREAM_KC = 128, 64
_OPERAND = [_P] * 6 + [_I] * 5
_ARGTYPES = {
    "mixed_gemm_launch": (_OPERAND * 2 + [_P, _P, ctypes.c_longlong, _P]
                          + [_I] * 4 + [_P]),
    "mixed_gemm_tc_launch": (_OPERAND * 2 + [_P, _P, ctypes.c_longlong]
                             + [_I] * 3 + [_P]),
}
_ENTRY = {"stream": "mixed_gemm_launch", "tc": "mixed_gemm_tc_launch"}
_SMS: Dict[int, int] = {}
_LIB = []
# The stream kernel's split-K tickets, one int per 128-row strip, zero
# between launches (each strip's last thread block resets its own), kept
# per device and stream so that no two launches in flight share them.
_TICKETS: Dict[Tuple[int, int], torch.Tensor] = {}


def gemm_path(m: int) -> str:
    """The kernel path of a product with ``m`` rows: ``'stream'`` for
    m <= STREAM_MAX_M, ``'tc'`` above."""
    return "stream" if m <= STREAM_MAX_M else "tc"


def stream_rows(m: int) -> int:
    """Rows of the stream kernel's activation tile: M padded to its
    n-tiles of 8 (8, 16, 32 or 64)."""
    return 8 if m <= 8 else 16 if m <= 16 else 32 if m <= 32 else 64


def stream_plan(m: int, n: int, kp: int, sms: int) -> Tuple[int, int]:
    """(splits, workspace floats) of a stream-path launch on a card with
    ``sms`` SMs. K is split while the 128-row strips alone would leave the
    card short of eight thread blocks an SM, with at least four and at
    most 64 chunks of 64 in a split, and with the f32 partials' traffic
    (8 B each, written and read) within a quarter of the weight's fp8
    bytes. The workspace holds the activation decoded to bf16
    (:func:`stream_rows` x Kp rounded up to 64) and, when K is split,
    splits x M x N f32 partials."""
    strips = -(-n // STREAM_ROWS)
    chunks = -(-kp // STREAM_KC)
    splits = max(1, min(-(-8 * sms // strips), chunks // 4, kp // (32 * m)))
    splits = max(splits, -(-chunks // 64))
    return splits, stream_workspace_floats(m, n, kp, splits)


def stream_workspace_floats(m: int, n: int, kp: int, splits: int) -> int:
    """f32 words of a stream-path launch's workspace: the activation
    decoded to bf16 (:func:`stream_rows` x Kp rounded up to 64) and, when
    K is split, splits x M x N f32 partials."""
    act = stream_rows(m) * (-(-kp // STREAM_KC)) * STREAM_KC // 2
    return act + (splits * m * n if splits > 1 else 0)


def _tc_workspace_floats(m: int, n: int, kp: int) -> int:
    """f32 words of the tensor-core path's scratch: its two decoded bf16
    operands (rows rounded up to its 128-row tile, Kp to its 64-deep
    chunk)."""
    kd = -(-kp // 64) * 64
    return (-(-m // 128) + -(-n // 128)) * 128 * kd // 2


def _lib():
    if not _LIB:
        lib = build.load("mixed_gemm")
        for entry, argtypes in _ARGTYPES.items():
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = _I
        _LIB.append(lib)
    return _LIB[0]


def _sm_count(dev: torch.device) -> int:
    """The card's SM count, read once per process and device; the stream
    kernels' shared-memory limits are raised at the same time."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _SMS:
        with torch.cuda.device(idx):
            err = _lib().mixed_gemm_stream_setup()
        if err != 0:
            raise RuntimeError(
                f"mixed_gemm stream setup failed: CUDA error {err}")
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def _tickets(dev: torch.device, stream: int, strips: int) -> torch.Tensor:
    key = (dev.index, stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < strips:
        t = torch.zeros(max(strips, 1024), dtype=torch.int32, device=dev)
        _TICKETS[key] = t
    return t


def _operand_args(mo: MixedOperand, name: str, device):
    """Validated lane pointers and flags of one operand. A lane is dense
    (full padded shape) or compact (one block); the kernel reads only
    dense lanes, and only where a tag names them."""
    if mo.tags.ndim != 2:
        raise ValueError(f"{name}: a stacked operand; pass one layer")
    Rp, Kp = mo.padded_shape
    br, bk = mo.block
    cq, cnib, cms = compact_lane_shapes(mo.block)
    want = {
        "payload_q": (torch.uint8, (Rp, Kp), cq),
        "payload_bf16": (torch.bfloat16, (Rp, Kp), cq),
        "payload_nib": (torch.uint8, (Rp // 2, Kp), cnib),
        "micro_scales": (torch.uint8, (Rp, Kp // NVFP4_MICRO), cms),
        "tags": (torch.int32, tuple(mo.tags.shape), None),
        "scales": (torch.float32, tuple(mo.tags.shape), None),
    }
    dense = {}
    for lane, (dtype, full, compact) in want.items():
        t = getattr(mo, lane)
        if t.device != device:
            raise ValueError(f"{name}.{lane} is on {t.device}, not {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}.{lane} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}.{lane} must be contiguous")
        shape = tuple(t.shape)
        if shape != full and shape != compact:
            raise ValueError(f"{name}.{lane} has shape {shape}, neither "
                             f"{full} nor compact {compact}")
        dense[lane] = shape == full
    nv = bool(mo.has_nvfp4) and nvfp4_block_capable(mo.block) and \
        dense["payload_nib"] and dense["micro_scales"]
    ptrs = [getattr(mo, lane).data_ptr() for lane in
            ("payload_q", "payload_bf16", "payload_nib", "micro_scales",
             "tags", "scales")]
    return ptrs + [br, mo.shape[0], int(dense["payload_q"]),
                   int(dense["payload_bf16"]), int(nv)]


def mixed_gemm_blocks(a: MixedOperand, b: MixedOperand, *,
                      out_dtype=torch.bfloat16,
                      _plan: Optional[Tuple[int, int]] = None
                      ) -> torch.Tensor:
    """Launch C = A @ B^T on two single-matrix MixedOperands on the card;
    returns the unpadded (M, N) product in ``out_dtype`` (bf16 or f32).

    ``_plan`` (internal: ``kernels.ops.sharded_mixed_gemm``): the (M, N)
    of the whole product of which this launch computes a block of rows
    or columns over all of K. The path and the stream path's split of K
    are then that product's, so each output sums its K chunks in the
    grouping of the one-rank launch, bit for bit. The tc path's order of
    K (128-deep promotions in chunk order per output tile) does not
    depend on M or N; only its choice by M does."""
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"out_dtype must be bf16 or f32, got {out_dtype}")
    if a.block[1] != b.block[1] or a.padded_shape[1] != b.padded_shape[1]:
        raise ValueError(
            f"contraction blocks differ: {a.block}/{a.padded_shape} vs "
            f"{b.block}/{b.padded_shape}"
        )
    dev = b.tags.device
    if not dev.type == "cuda":
        raise ValueError(f"mixed_gemm_blocks needs CUDA operands, got {dev}")
    args_a = _operand_args(a, "a", dev)
    args_b = _operand_args(b, "b", dev)
    M, N = a.shape[0], b.shape[0]
    Kp, bk = a.padded_shape[1], a.block[1]
    plan_m, plan_n = (M, N) if _plan is None else _plan
    path = gemm_path(plan_m)
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    f32 = int(out_dtype == torch.float32)
    launch = getattr(_lib(), _ENTRY[path])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if path == "stream":
            splits, _ = stream_plan(plan_m, plan_n, Kp, _sm_count(dev))
            ws = torch.empty(stream_workspace_floats(M, N, Kp, splits),
                             dtype=torch.float32, device=dev)
            tickets = _tickets(dev, stream, -(-N // STREAM_ROWS))
            tail = (ws.data_ptr(), ws.numel(), tickets.data_ptr(), splits,
                    f32, Kp, bk)
        else:
            ws = torch.empty(_tc_workspace_floats(M, N, Kp),
                             dtype=torch.float32, device=dev)
            tail = (ws.data_ptr(), ws.numel(), f32, Kp, bk)
        err = launch(*args_a, *args_b, out.data_ptr(), *tail, stream)
    if err != 0:
        raise RuntimeError(
            f"mixed_gemm ({path} path) launch failed: CUDA error {err}")
    mixed_gemm_blocks.launches += 1
    mixed_gemm_blocks.launches_by_path[path] += 1
    return out


mixed_gemm_blocks.launches = 0
mixed_gemm_blocks.launches_by_path = {"stream": 0, "tc": 0}
