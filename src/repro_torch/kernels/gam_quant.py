"""Wrapper of the fused one-format quantize kernel (``csrc/gam_quant.cu``),
the Hopper port of ``repro/kernels/gam_quant.py:gam_quant_blocks``.

The plain PyTorch version of the same function is
``kernels.ref.gam_quant_ref``; ``kernels.ops.gam_quant`` and
``kernels.ops.quant_err`` route a CPU tensor there and a CUDA tensor
here.

Two routes, picked by :func:`gam_quant_route` from the block alone (a
caller cannot force one): ``tile`` for the 128 x 128 block of every main
path (a persistent grid over a TMA ring, the block in registers, a
per-warp table of stored values in place of a division by the scale per
element, 16-byte stores), ``generic`` for any other block (one CTA per
block, the block in shared memory). The wrapper counts its launches in
``launches`` and by route in ``launches_by_route``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import build
from .mor_select import _ALGOS, SMEM_OPTIN_BYTES, _check, slab_pointers

__all__ = ["gam_quant_blocks", "gam_quant_route", "gam_quant_smem_bytes",
           "ROUTES", "TILE_BLOCK", "GENERIC_STATIC_SMEM"]

ROUTES = ("tile", "generic")
TILE_BLOCK = (128, 128)
# The tile route leaves the clip to the saturating cast, so it takes only
# the format's own max as q_amax.
_FMT_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def gam_quant_route(block: Tuple[int, int]) -> str:
    """The route that quantizes ``block``: "tile" for 128 x 128, "generic"
    for any other positive block. A pure function of its argument."""
    bm, bk = block
    if bm < 1 or bk < 1:
        raise ValueError(f"block must be positive, got {block}")
    return "tile" if tuple(block) == TILE_BLOCK else "generic"


# A bound on the generic kernel's static scratch (csrc/gam_quant.cu:
# fscratch[32], iscratch[32], dscratch[32] doubles, bcast), each array
# rounded up to 16 bytes (the card reports 528 bytes, built by nvcc
# 12.8; gam_quant_generic_static_smem reads it).
GENERIC_STATIC_SMEM = 128 + 128 + 256 + 16


def gam_quant_smem_bytes(block: Tuple[int, int]):
    """(dynamic, static) shared bytes of one generic-route CTA over
    ``block``: the bf16 block, and the bound on the kernel's static
    scratch. The
    launcher opts in to the dynamic bytes; :func:`gam_quant_blocks`
    refuses a block whose total exceeds ``SMEM_OPTIN_BYTES``."""
    bm, bk = block
    return bm * bk * 2, GENERIC_STATIC_SMEM


_FNS = {}


def _fn(route: str):
    """The C launcher of ``route``: the tile launcher takes no block (two
    int arguments fewer)."""
    f = _FNS.get(route)
    if f is None:
        tile = route == "tile"
        f = getattr(build.load("gam_quant"),
                    "gam_quant_tile_launch" if tile else "gam_quant_launch")
        f.argtypes = [_P] * 6 + [_I] * (3 if tile else 5) + [_F, _I, _P]
        f.restype = _I
        _FNS[route] = f
    return f


def _launch(route, tensors, n, Mp, Kp, block, algo, q_amax, e5m2, dev):
    """``n`` launches on the current stream, one a slab of the stacked
    ``tensors``; raises on a CUDA error."""
    dims = (Mp, Kp) if route == "tile" else (Mp, Kp, *block)
    fn = _fn(route)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for ptrs in slab_pointers(tensors, n):
            err = fn(*ptrs, *dims, _ALGOS[algo], float(q_amax), int(e5m2),
                     stream)
            if err != 0:
                raise RuntimeError(f"gam_quant ({route}) launch failed: "
                                   f"CUDA error {err}")


def gam_quant_blocks(xp: torch.Tensor, mg: torch.Tensor, *,
                     block: Tuple[int, int] = (128, 128),
                     q_amax: float = 448.0, fmt_dtype=torch.float8_e4m3fn,
                     algo: str = "gam"):
    """Launch the kernel on a padded (Mp, Kp) bf16 operand.

    ``mg``: (2,) f32 on the device -- the format's group mantissa m_g
    (1.0 for the ablation algos) and the guarded group amax. Returns
    (xq (Mp, Kp) bf16, block_exp (nm, nk) int32, err_sums (nm, nk) f32,
    counts (nm, nk) f32). A stack of E operands (E, Mp, Kp) with (E, 2)
    ``mg`` is E launches, one an operand, every output stacked.
    """
    if algo not in _ALGOS:
        raise ValueError(f"unknown algo {algo!r}")
    if fmt_dtype not in _FMT_MAX:
        raise ValueError(f"gam_quant quantizes to E4M3 or E5M2, got "
                         f"{fmt_dtype}")
    if xp.ndim not in (2, 3):
        raise ValueError(f"x must be (Mp, Kp) or a stack (E, Mp, Kp), got "
                         f"{tuple(xp.shape)}")
    lead = tuple(xp.shape[:-2])
    n = lead[0] if lead else 1
    Mp, Kp = xp.shape[-2:]
    bm, bk = block
    route = gam_quant_route(block)
    if Mp % bm or Kp % bk:
        raise ValueError(f"operand {(Mp, Kp)} is not padded to {block}")
    if route == "generic":
        dyn, static = gam_quant_smem_bytes(block)
        if dyn + static > SMEM_OPTIN_BYTES:
            raise ValueError(
                f"gam_quant: a {tuple(block)} block needs {dyn} + {static} "
                f"= {dyn + static} bytes of shared memory per CTA, more than "
                f"the {SMEM_OPTIN_BYTES} an sm_90 CTA can opt in to; use a "
                "smaller block")
    _check(xp, "x", torch.bfloat16, (*lead, Mp, Kp))
    _check(mg, "mg", torch.float32, (*lead, 2))
    if mg.device != xp.device:
        raise ValueError("x and mg must share a device")
    if route == "tile":
        if xp.data_ptr() % 16:
            raise ValueError("x must be 16-byte aligned (the tile route reads "
                             "it through the TMA)")
        if float(q_amax) != _FMT_MAX[fmt_dtype]:
            raise ValueError(f"the tile route clips at the format's max "
                             f"{_FMT_MAX[fmt_dtype]}, got q_amax {q_amax}")
    nm, nk = Mp // bm, Kp // bk
    dev = xp.device
    xq = torch.empty((*lead, Mp, Kp), dtype=torch.bfloat16, device=dev)
    block_exp = torch.empty((*lead, nm, nk), dtype=torch.int32, device=dev)
    err_sums = torch.empty((*lead, nm, nk), dtype=torch.float32, device=dev)
    counts = torch.empty((*lead, nm, nk), dtype=torch.float32, device=dev)
    _launch(route, (xp, mg, xq, block_exp, err_sums, counts), n, Mp, Kp,
            block, algo, q_amax, fmt_dtype == torch.float8_e5m2, dev)
    gam_quant_blocks.launches += n
    gam_quant_blocks.launches_by_route[route] += n
    return xq, block_exp, err_sums, counts


gam_quant_blocks.launches = 0
gam_quant_blocks.launches_by_route = {r: 0 for r in ROUTES}
