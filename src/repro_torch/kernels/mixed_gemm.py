"""Wrapper of the mixed-representation block GEMM kernel
(``csrc/mixed_gemm.cu``), the Hopper port of
``repro/kernels/mixed_gemm.py:mixed_gemm_blocks``.

The kernel has two paths, chosen by :func:`gemm_path` from M alone:
``'stream'`` (M <= 64: decode steps, prefill chunks, the f32 head; CUDA
cores, split K) and ``'tc'`` (larger M: the training GEMMs; bf16 tensor
cores on operands decoded once to bf16). Both compute the same
function and take the same arguments; there is no fallback from one to
the other. ``mixed_gemm_blocks.launches`` counts every launch and
``mixed_gemm_blocks.launches_by_path`` each path's.

The plain PyTorch version of the same function is
``kernels.ref.mixed_gemm_ref``; ``kernels.ops.mixed_gemm`` routes a CPU
tensor there and a CUDA tensor here.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.formats import NVFP4_MICRO

from . import build
from .ref import MixedOperand, compact_lane_shapes, nvfp4_block_capable

__all__ = ["mixed_gemm_blocks", "gemm_path", "STREAM_MAX_M"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# f32 split-K partials the kernel may use: it splits K only while the
# output tiles cannot fill the card twice over, which on a 132-SM card
# needs at most ~2.2 M floats; fewer splits fit a smaller workspace.
WORKSPACE_FLOATS = 1 << 22
# Largest M the streaming path takes: decode (M = slots), prefill chunks
# and the head have a handful of rows and are bound by the weight's
# bytes; above it the tensor-core path's 128-row tiles are filled.
STREAM_MAX_M = 64
_ENTRY = {"stream": "mixed_gemm_launch", "tc": "mixed_gemm_tc_launch"}


def gemm_path(m: int) -> str:
    """The kernel path of a product with ``m`` rows: ``'stream'`` for
    m <= STREAM_MAX_M, ``'tc'`` above."""
    return "stream" if m <= STREAM_MAX_M else "tc"


def _workspace_floats(path: str, m: int, n: int, kp: int) -> int:
    """f32 words of scratch a launch takes: the streaming path's split-K
    partials, or the tensor-core path's two decoded bf16 operands (rows
    rounded up to its 128-row tile, Kp to its 64-deep chunk)."""
    if path == "stream":
        return WORKSPACE_FLOATS
    kd = -(-kp // 64) * 64
    return (-(-m // 128) + -(-n // 128)) * 128 * kd // 2


def _lib():
    lib = build.load("mixed_gemm")
    for entry in _ENTRY.values():
        fn = getattr(lib, entry)
        fn.argtypes = (
            [_P] * 6 + [_I] * 5 + [_P] * 6 + [_I] * 5
            + [_P, _P, ctypes.c_longlong] + [_I] * 3 + [_P])
        fn.restype = _I
    return lib


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
                      out_dtype=torch.bfloat16) -> torch.Tensor:
    """Launch C = A @ B^T on two single-matrix MixedOperands on the card;
    returns the unpadded (M, N) product in ``out_dtype`` (bf16 or f32)."""
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
    path = gemm_path(M)
    launch = getattr(_lib(), _ENTRY[path])
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    workspace = torch.empty(_workspace_floats(path, M, N, Kp),
                            dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(
            *args_a, *args_b, out.data_ptr(), workspace.data_ptr(),
            workspace.numel(),
            int(out_dtype == torch.float32), Kp, bk, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"mixed_gemm ({path} path) launch failed: CUDA error {err}")
    mixed_gemm_blocks.launches += 1
    mixed_gemm_blocks.launches_by_path[path] += 1
    return out


mixed_gemm_blocks.launches = 0
mixed_gemm_blocks.launches_by_path = {"stream": 0, "tc": 0}
