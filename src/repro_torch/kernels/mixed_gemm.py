"""Wrapper of the mixed-representation block GEMM kernel
(``csrc/mixed_gemm.cu``), the Hopper port of
``repro/kernels/mixed_gemm.py:mixed_gemm_blocks``.

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

__all__ = ["mixed_gemm_blocks"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# f32 split-K partials the kernel may use: it splits K only while the
# output tiles cannot fill the card twice over, which on a 132-SM card
# needs at most ~2.2 M floats; fewer splits fit a smaller workspace.
WORKSPACE_FLOATS = 1 << 22


def _lib():
    lib = build.load("mixed_gemm")
    lib.mixed_gemm_launch.argtypes = (
        [_P] * 6 + [_I] * 5 + [_P] * 6 + [_I] * 5 + [_P, _P, ctypes.c_longlong]
        + [_I] * 3 + [_P])
    lib.mixed_gemm_launch.restype = _I
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
    lib = _lib()
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    workspace = torch.empty(WORKSPACE_FLOATS, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mixed_gemm_launch(
            *args_a, *args_b, out.data_ptr(), workspace.data_ptr(),
            WORKSPACE_FLOATS, int(out_dtype == torch.float32), Kp, bk, stream,
        )
    if err != 0:
        raise RuntimeError(f"mixed_gemm launch failed: CUDA error {err}")
    mixed_gemm_blocks.launches += 1
    return out


mixed_gemm_blocks.launches = 0
