"""Wrapper of the flash attention forward kernel
(``csrc/flash_attention.cu``), the Hopper port of
``repro/kernels/flash_attention.py:flash_attention_fwd``.

The plain PyTorch version of the same function is
``kernels.ref.flash_attention_ref``; ``kernels.ops.flash_attention``
routes a CPU tensor there and a CUDA tensor here.

Two layouts, both read in place (no fold or repeat copies):

* folded ``q (BH, S, d)`` against ``k, v (BH, T, d)``, the reference
  kernel's own layout;
* the GQA layout ``q (B, S, Hq, dh)`` against ``k, v (B, T, Hkv, dh)``
  with ``Hq % Hkv == 0``: query head ``h`` reads kv head
  ``h // (Hq // Hkv)`` directly, which is the reference's repeat of the
  kv heads without the copy. The output keeps q's layout.

``q_offset`` (the key position of query row 0) is normalized as the
reference kernel does: ``None`` gives ``T - S``; a scalar or one entry
per folded row ``b * Hq + h`` becomes a (BH,) int32 vector on the
device; any other length raises. ``block_q`` / ``block_k`` are the TPU
kernel's VMEM tiling: they are accepted for the signature and checked,
but not emulated -- each route tiles queries and keys its own way.

Two routes, picked by :func:`flash_route` from the dtype and head dim
alone (a caller cannot force one): ``wgmma`` for bf16 with d 64 or 128
(TMA ring of 128-key tiles, both products on the tensor cores, p split
into two bf16 terms for p v), ``cuda_core`` for the rest (f32, whose
products must not meet TF32 or bf16, and d = 32: both products in f32
on CUDA cores).
"""
from __future__ import annotations

import ctypes

import torch

from . import build

__all__ = ["flash_attention_fwd", "flash_layout", "flash_offsets",
           "flash_route", "HEAD_DIMS", "ROUTES", "WGMMA_HEAD_DIMS"]

# Head dims the kernels are compiled for (a template instance each).
HEAD_DIMS = (32, 64, 128)
ROUTES = ("wgmma", "cuda_core")
# Head dims of the wgmma route: one or two 64-column (128-byte) boxes.
WGMMA_HEAD_DIMS = (64, 128)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float


def flash_route(dtype: torch.dtype, d: int) -> str:
    """The route that computes attention over ``dtype`` operands of head
    dim ``d``: "wgmma" for bf16 with d in (64, 128), "cuda_core" for
    everything else. A pure function of its arguments."""
    if dtype == torch.bfloat16 and d in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "cuda_core"


def _fn(route: str):
    lib = build.load("flash_attention")
    f = (lib.flash_attention_wgmma_launch if route == "wgmma"
         else lib.flash_attention_launch)
    f.argtypes = [_P] * 5 + [_I] * 6 + [_L] * 6 + [_I, _F, _I, _P]
    f.restype = _I
    return f


def flash_offsets(q_offset, S: int, T: int, BH: int, device) -> torch.Tensor:
    """(BH,) int32 query offsets on ``device``: ``None`` gives T - S, a
    scalar is shared, a (BH,) vector is taken as is; other lengths raise."""
    off = torch.as_tensor(T - S if q_offset is None else q_offset,
                          dtype=torch.int32).reshape(-1)
    if off.shape[0] not in (1, BH):
        raise ValueError(f"q_offset must be a scalar or one entry per "
                         f"BH={BH} row, got shape {tuple(off.shape)}")
    return off.to(device).expand(BH).contiguous()


def flash_layout(q, k, v, block_q: int = 512, block_k: int = 512):
    """The reference launcher's shape checks, raised as ValueErrors, for
    both layouts. Returns (B, H, G, S, T, d, q_strides, k_strides): the
    batch, query heads per batch (1 when folded), the GQA group, the
    extents, and element strides per batch, head and row."""
    if block_q < 1 or block_k < 1:
        raise ValueError(f"block sizes must be positive, got block_q="
                         f"{block_q} block_k={block_k}")
    if q.ndim == 3 and k.ndim == 3 and v.ndim == 3:
        BH, S, d = q.shape
        T = k.shape[1]
        if k.shape != (BH, T, d) or v.shape != (BH, T, d):
            raise ValueError(f"k/v must be (BH={BH}, T, d={d}) and match: "
                             f"got k{tuple(k.shape)} v{tuple(v.shape)}")
        return BH, 1, 1, S, T, d, (S * d, 0, d), (T * d, 0, d)
    if q.ndim == 4 and k.ndim == 4 and v.ndim == 4:
        B, S, H, d = q.shape
        T, Hkv = k.shape[1], k.shape[2]
        if k.shape != (B, T, Hkv, d) or v.shape != k.shape or H % Hkv:
            raise ValueError(f"GQA contract wants k/v (B={B}, T, Hkv, dh={d}) "
                             f"with Hq={H} divisible by Hkv, got "
                             f"k{tuple(k.shape)} v{tuple(v.shape)}")
        return (B, H, H // Hkv, S, T, d, (S * H * d, d, H * d),
                (T * Hkv * d, d, Hkv * d))
    raise ValueError(f"flash attention wants folded (BH, S|T, d) or GQA "
                     f"(B, S|T, H, dh) operands, got q{tuple(q.shape)} "
                     f"k{tuple(k.shape)} v{tuple(v.shape)}")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, q_offset=None,
                        block_q: int = 512, block_k: int = 512
                        ) -> torch.Tensor:
    """Launch the kernel of :func:`flash_route`'s route; returns the
    attention output in q's layout and dtype (f32 or bf16, the same for
    q, k and v)."""
    B, H, G, S, T, d, q_strides, k_strides = flash_layout(
        q, k, v, block_q, block_k)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"q, k and v must share a dtype: {name} is "
                            f"{t.dtype}, q {q.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             f"aligned (the kernel loads 16 bytes at once)")
        if t.device != q.device:
            raise ValueError("q, k and v must share a device")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash attention takes f32 or bf16, got {q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"the kernel is built for head dims {HEAD_DIMS}, "
                         f"got {d}")
    if S == 0 or T == 0:
        raise ValueError(f"empty attention: S={S}, T={T}")
    route = flash_route(q.dtype, d)
    off = flash_offsets(q_offset, S, T, B * H, q.device)
    out = torch.empty_like(q)
    fn = _fn(route)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), off.data_ptr(),
                 out.data_ptr(), B, H, G, S, T, d, *q_strides, *k_strides,
                 int(causal), float(d ** -0.5),
                 int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention ({route}) launch failed: CUDA "
                           f"error {err}")
    flash_attention_fwd.launches += 1
    flash_attention_fwd.launches_by_route[route] += 1
    return out


flash_attention_fwd.launches = 0
flash_attention_fwd.launches_by_route = {r: 0 for r in ROUTES}
