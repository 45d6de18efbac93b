"""Wrapper of the fused one-format quantize kernel (``csrc/gam_quant.cu``),
the Hopper port of ``repro/kernels/gam_quant.py:gam_quant_blocks``.

The plain PyTorch version of the same function is
``kernels.ref.gam_quant_ref``; ``kernels.ops.gam_quant`` and
``kernels.ops.quant_err`` route a CPU tensor there and a CUDA tensor
here.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import build
from .mor_select import _ALGOS, _check

__all__ = ["gam_quant_blocks"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _fn():
    f = build.load("gam_quant").gam_quant_launch
    f.argtypes = [_P] * 6 + [_I] * 5 + [_F, _I, _P]
    f.restype = _I
    return f


def gam_quant_blocks(xp: torch.Tensor, mg: torch.Tensor, *,
                     block: Tuple[int, int] = (128, 128),
                     q_amax: float = 448.0, fmt_dtype=torch.float8_e4m3fn,
                     algo: str = "gam"):
    """Launch the kernel on a padded (Mp, Kp) bf16 operand.

    ``mg``: (2,) f32 on the device -- the format's group mantissa m_g
    (1.0 for the ablation algos) and the guarded group amax. Returns
    (xq (Mp, Kp) bf16, block_exp (nm, nk) int32, err_sums (nm, nk) f32,
    counts (nm, nk) f32).
    """
    if algo not in _ALGOS:
        raise ValueError(f"unknown algo {algo!r}")
    if fmt_dtype not in (torch.float8_e4m3fn, torch.float8_e5m2):
        raise ValueError(f"gam_quant quantizes to E4M3 or E5M2, got "
                         f"{fmt_dtype}")
    Mp, Kp = xp.shape
    bm, bk = block
    if Mp % bm or Kp % bk:
        raise ValueError(f"operand {(Mp, Kp)} is not padded to {block}")
    _check(xp, "x", torch.bfloat16, (Mp, Kp))
    _check(mg, "mg", torch.float32, (2,))
    if mg.device != xp.device:
        raise ValueError("x and mg must share a device")
    nm, nk = Mp // bm, Kp // bk
    dev = xp.device
    xq = torch.empty((Mp, Kp), dtype=torch.bfloat16, device=dev)
    block_exp = torch.empty((nm, nk), dtype=torch.int32, device=dev)
    err_sums = torch.empty((nm, nk), dtype=torch.float32, device=dev)
    counts = torch.empty((nm, nk), dtype=torch.float32, device=dev)
    fn = _fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(xp.data_ptr(), mg.data_ptr(), xq.data_ptr(),
                 block_exp.data_ptr(), err_sums.data_ptr(),
                 counts.data_ptr(), Mp, Kp, bm, bk, _ALGOS[algo],
                 float(q_amax), int(fmt_dtype == torch.float8_e5m2), stream)
    if err != 0:
        raise RuntimeError(f"gam_quant launch failed: CUDA error {err}")
    gam_quant_blocks.launches += 1
    return xq, block_exp, err_sums, counts


gam_quant_blocks.launches = 0
