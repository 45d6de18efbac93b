"""Decode attention against a KV cache (port of the bf16-cache branch of
``repro.models.attention.decode_attention``). The fp8 and MoR cache
tiers and the chunked training attention are not ported yet."""
from __future__ import annotations

import torch

__all__ = ["decode_attention"]

_NEG = -1e30


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cur_index, *,
                     window: int = 0) -> torch.Tensor:
    """q: (B, S, Hq, dh), caches: (B, T, Hkv, dh) bf16. ``cur_index``
    (scalar or (B,)) is the position of the last query token per row;
    query s of row b sits at cur_index[b] - (S - 1) + s and sees only
    cache entries at positions <= its own. Softmax in f32."""
    B, S, Hq, dh = q.shape
    T, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    qg = (q.to(torch.float32) * dh**-0.5).reshape(B, S, Hkv, G, dh)
    s = torch.einsum("bshgd,bkhd->bhgsk", qg, k_cache.to(torch.float32))
    cur = torch.as_tensor(cur_index, dtype=torch.int64,
                          device=q.device).reshape(-1).expand(B)
    q_pos = cur[:, None] - (S - 1) + torch.arange(S, device=q.device)
    k_pos = torch.arange(T, device=q.device)
    valid = k_pos[None, None, :] <= q_pos[:, :, None]  # (B, S, T)
    if window:
        valid &= k_pos[None, None, :] > q_pos[:, :, None] - window
    s = torch.where(valid[:, None, None], s, _NEG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgsk,bkhd->bshgd", p, v_cache.to(torch.float32))
    return out.reshape(B, S, Hq, dh).to(q.dtype)
