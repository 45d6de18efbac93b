"""Wrappers of the MoR selection kernel (``csrc/mor_select.cu``), the
Hopper port of ``repro/kernels/mor_select.py:mor_select_blocks`` in both
of its emit modes: :func:`mor_select_pack` (emit='pack', the real mixed
layout) and :func:`mor_select_select` (emit='select', the fake-quant
winner ``y``).

The plain PyTorch versions are ``kernels.ref.quantize_pack_ref`` and
``kernels.ref.mor_select_ref``; ``kernels.ops.quantize_pack`` and
``kernels.ops.mor_select`` route a CPU tensor there and a CUDA tensor
here.

Two routes, picked by :func:`mor_select_route` from the block alone (a
caller cannot force one): ``tile`` for the 128 x 128 block of every main
path (a persistent grid over a TMA ring, the block in registers, a
per-warp table of stored values in place of a division by the scale per
element, 16-byte stores), ``generic`` for any other block (one CTA per
block, the block in shared memory). Each wrapper counts its launches in
``launches`` and by route in ``launches_by_route``.

The select variant also takes f32 operands, as the Pallas kernel does
(the gradient compression's f32 views): candidates stored as f32, y in
f32. Its f32 instance is the generic kernel's, for every block (a tile
kernel of its own measured slower), dispatched by x's dtype and counted
in ``mor_select_select.launches_by_dtype``; Eq. 1 keeps the IEEE
division there.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.core.formats import NVFP4_MICRO
from repro_torch.core.metrics import E5M2_RANGE_RATIO, NVFP4_RANGE_RATIO

from . import build

__all__ = ["mor_select_pack", "mor_select_select", "mor_select_route",
           "mor_select_smem_bytes", "ROUTES", "SELECT_DTYPES", "TILE_BLOCK",
           "GENERIC_STATIC_SMEM", "SMEM_OPTIN_BYTES"]

ROUTES = ("tile", "generic")
TILE_BLOCK = (128, 128)

_MODES = {"sub2": 2, "sub3": 3, "sub4": 4}
_ALGOS = {"gam": 0, "e8m0": 1, "fp32_amax": 2}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def mor_select_route(block: Tuple[int, int], mode: str,
                     dtype: torch.dtype = torch.bfloat16) -> str:
    """The route that selects over ``block`` under ``mode`` for an
    operand of ``dtype``: "tile" for 128 x 128 bf16, "generic" for any
    other block and for every f32 block. A pure function of its
    arguments; raises where no route takes the block (sub4 needs even
    rows and 16-divisible columns)."""
    if mode not in _MODES:
        raise ValueError(f"unknown mode {mode!r}")
    bm, bk = block
    if bm < 1 or bk < 1:
        raise ValueError(f"block must be positive, got {block}")
    if mode == "sub4" and (bm % 2 or bk % NVFP4_MICRO):
        raise ValueError(f"sub4 needs an even-row, 16-divisible block, "
                         f"got {block}")
    return ("tile" if tuple(block) == TILE_BLOCK and dtype == torch.bfloat16
            else "generic")


# Shared memory of the generic kernel (csrc/mor_select.cu): a bound on
# its static scratch, each array it declares (fscratch[32], iscratch[32],
# bcast[8], sel_sh) rounded up to 16 bytes -- the compiler lays them out
# (the card reports 272 bytes for every instance, built by nvcc 12.8;
# mor_select_generic_static_smem reads it) -- and the most a CTA may opt
# in to on sm_90 (cudaDevAttrMaxSharedMemoryPerBlockOptin, 227 KB).
GENERIC_STATIC_SMEM = 128 + 128 + 32 + 16
SMEM_OPTIN_BYTES = 227 * 1024


def mor_select_smem_bytes(block: Tuple[int, int], mode: str,
                          dtype: torch.dtype = torch.bfloat16):
    """(dynamic, static) shared bytes of one generic-route CTA over
    ``block``: the block in x's dtype, rounded up to 16 bytes, plus under
    sub4 one f32 micro amax per micro group; and the bound on the
    kernel's static scratch. The launcher opts in to the dynamic bytes;
    the wrappers refuse a block whose total exceeds
    ``SMEM_OPTIN_BYTES``."""
    bm, bk = block
    dyn = -(-bm * bk * torch.empty((), dtype=dtype).element_size() // 16) * 16
    if mode == "sub4":
        dyn += bm * (bk // NVFP4_MICRO) * 4
    return dyn, GENERIC_STATIC_SMEM


def _check_smem(variant, block, mode, dtype):
    dyn, static = mor_select_smem_bytes(block, mode, dtype)
    if dyn + static > SMEM_OPTIN_BYTES:
        raise ValueError(
            f"mor_select_{variant}: a {tuple(block)} {dtype} block under "
            f"{mode} needs {dyn} + {static} = {dyn + static} bytes of shared "
            f"memory per CTA, more than the {SMEM_OPTIN_BYTES} an sm_90 CTA "
            "can opt in to; use a smaller block")


# The select variant's operand dtypes, with the launchers' name infixes.
SELECT_DTYPES = {torch.bfloat16: "", torch.float32: "_f32"}

_FNS = {}


def _fn(variant: str, route: str, infix: str = ""):
    """The C launcher of ``variant`` ("pack" / "select") on ``route`` for
    the dtype of ``infix`` ("" bf16, "_f32"): the tile launchers take no
    block (two int arguments fewer)."""
    f = _FNS.get((variant, route, infix))
    if f is None:
        tile = route == "tile"
        f = getattr(build.load("mor_select"),
                    f"mor_select_{variant}{infix}"
                    f"{'_tile' if tile else ''}_launch")
        ptrs = 12 if variant == "pack" else 9
        f.argtypes = [_P] * ptrs + [_I] * (4 if tile else 6) + [_F, _F, _P]
        f.restype = _I
        _FNS[(variant, route, infix)] = f
    return f


def _launch(variant, route, tensors, n, Mp, Kp, block, mode, algo, dev,
            infix=""):
    """``n`` launches on the current stream, one a slab of the stacked
    ``tensors`` (a None stays a null pointer); raises on a CUDA error."""
    dims = (Mp, Kp) if route == "tile" else (Mp, Kp, *block)
    fn = _fn(variant, route, infix)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for ptrs in slab_pointers(tensors, n):
            err = fn(*ptrs, *dims, _MODES[mode], _ALGOS[algo],
                     E5M2_RANGE_RATIO, NVFP4_RANGE_RATIO, stream)
            if err != 0:
                raise RuntimeError(f"mor_select_{variant} ({route}) launch "
                                   f"failed: CUDA error {err}")


def _check(t: torch.Tensor, name: str, dtype, shape):
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _validate(xp, mg, block, mode, algo, variant, dtype=torch.bfloat16):
    if mode not in _MODES or algo not in _ALGOS:
        raise ValueError(f"unknown mode/algo {mode!r}/{algo!r}")
    if xp.ndim not in (2, 3):
        raise ValueError(f"x must be (Mp, Kp) or a stack (E, Mp, Kp), got "
                         f"{tuple(xp.shape)}")
    lead = tuple(xp.shape[:-2])
    Mp, Kp = xp.shape[-2:]
    bm, bk = block
    route = mor_select_route(block, mode, dtype)
    if route == "generic":
        _check_smem(variant, block, mode, dtype)
    if Mp % bm or Kp % bk:
        raise ValueError(f"operand {(Mp, Kp)} is not padded to {block}")
    _check(xp, "x", dtype, (*lead, Mp, Kp))
    _check(mg, "mg", torch.float32, (*lead, 4))
    if mg.device != xp.device:
        raise ValueError("x and mg must share a device")
    if route == "tile" and xp.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned (the tile route reads it "
                         "through the TMA)")
    return lead, Mp, Kp, Mp // bm, Kp // bk, route


def slab_pointers(tensors, n: int):
    """The device pointers of slab e = 0 .. n-1 of each contiguous
    tensor of ``tensors`` (stacked on a leading axis of n when n > 1; a
    None gives None)."""
    base = [(None, 0) if t is None else
            (t.data_ptr(), t.numel() // n * t.element_size())
            for t in tensors]
    return [tuple(None if p is None else p + e * step for p, step in base)
            for e in range(n)]


def mor_select_select(xp: torch.Tensor, mg: torch.Tensor, *,
                      block: Tuple[int, int], mode: str = "sub3",
                      algo: str = "gam") -> Dict[str, torch.Tensor]:
    """Launch the select variant on a padded (Mp, Kp) bf16 or f32
    operand (the instance of x's dtype).

    ``mg`` as for :func:`mor_select_pack`. Returns the padded (Mp, Kp)
    ``y`` in x's dtype (each block's winner as stored) and the (nm, nk)
    ``sel``, ``scales``, ``e4_sums``, ``e5_sums``, ``counts`` (and sub4
    ``nv_sums``) grids. A stack of E operands (E, Mp, Kp) with (E, 4)
    ``mg`` is E launches, one an operand, every output stacked.
    """
    if xp.dtype not in SELECT_DTYPES:
        raise TypeError(f"x must be one of {list(SELECT_DTYPES)}, got "
                        f"{xp.dtype}")
    lead, Mp, Kp, nm, nk, route = _validate(xp, mg, block, mode, algo,
                                             "select", xp.dtype)
    dev = xp.device
    n = lead[0] if lead else 1

    def empty(shape, dtype):
        return torch.empty((*lead, *shape), dtype=dtype, device=dev)

    out = {
        "y": empty((Mp, Kp), xp.dtype),
        "sel": empty((nm, nk), torch.int32),
        "scales": empty((nm, nk), torch.float32),
        "e4_sums": empty((nm, nk), torch.float32),
        "e5_sums": empty((nm, nk), torch.float32),
        "counts": empty((nm, nk), torch.float32),
    }
    if mode == "sub4":
        out["nv_sums"] = empty((nm, nk), torch.float32)
    _launch("select", route, (
        xp, mg, out["y"], out["sel"], out["scales"], out["e4_sums"],
        out["e5_sums"], out["counts"], out.get("nv_sums")), n,
        Mp, Kp, block, mode, algo, dev, SELECT_DTYPES[xp.dtype])
    mor_select_select.launches += n
    mor_select_select.launches_by_route[route] += n
    mor_select_select.launches_by_dtype[str(xp.dtype).split(".")[-1]] += n
    return out


mor_select_select.launches = 0
mor_select_select.launches_by_route = {r: 0 for r in ROUTES}
mor_select_select.launches_by_dtype = {
    str(d).split(".")[-1]: 0 for d in SELECT_DTYPES}


def mor_select_pack(xp: torch.Tensor, mg: torch.Tensor, *,
                    block: Tuple[int, int], mode: str = "sub3",
                    algo: str = "gam") -> Dict[str, torch.Tensor]:
    """Launch the kernel on a padded (Mp, Kp) bf16 operand.

    ``mg``: (4,) f32 on the device -- the E4M3, E5M2 and NVFP4 group
    mantissas and the guarded group amax. Returns the MixedOperand lanes
    (``payload_q``, ``payload_bf16``, ``payload_nib`` and
    ``micro_scales`` for sub4) and the (nm, nk) ``sel``, ``scales``,
    ``e4_sums``, ``e5_sums``, ``counts`` (and sub4 ``nv_sums``) grids.
    A stack of E operands is E launches, as in :func:`mor_select_select`.
    """
    lead, Mp, Kp, nm, nk, route = _validate(xp, mg, block, mode, algo,
                                             "pack")
    dev = xp.device
    n = lead[0] if lead else 1

    def empty(shape, dtype):
        return torch.empty((*lead, *shape), dtype=dtype, device=dev)

    out = {
        "payload_q": empty((Mp, Kp), torch.uint8),
        "payload_bf16": empty((Mp, Kp), torch.bfloat16),
        "sel": empty((nm, nk), torch.int32),
        "scales": empty((nm, nk), torch.float32),
        "e4_sums": empty((nm, nk), torch.float32),
        "e5_sums": empty((nm, nk), torch.float32),
        "counts": empty((nm, nk), torch.float32),
    }
    if mode == "sub4":
        out["nv_sums"] = empty((nm, nk), torch.float32)
        out["payload_nib"] = empty((Mp // 2, Kp), torch.uint8)
        out["micro_scales"] = empty((Mp, Kp // NVFP4_MICRO), torch.uint8)

    t = {"x": xp, "mg": mg, **out}
    _launch("pack", route, tuple(t.get(k) for k in (
        "x", "mg", "payload_q", "payload_bf16", "sel", "scales", "e4_sums",
        "e5_sums", "counts", "nv_sums", "payload_nib", "micro_scales")), n,
        Mp, Kp, block, mode, algo, dev)
    mor_select_pack.launches += n
    mor_select_pack.launches_by_route[route] += n
    return out


mor_select_pack.launches = 0
mor_select_pack.launches_by_route = {r: 0 for r in ROUTES}
