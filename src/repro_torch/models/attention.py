"""Attention (port of ``repro.models.attention``): the chunked
flash-style attention of training, and decode attention against a bf16
KV cache. The fp8 and MoR cache tiers are not ported yet.

Training attention is plain PyTorch, as in the reference, where it is
pure JAX (the Pallas ``flash_attention_fwd`` kernel is not on the model
path): queries in chunks of ``q_chunk``, keys and values streamed in
chunks of ``k_chunk`` with an online softmax, in the reference's order.
Its backward is autograd through the same operations; the reference
recomputes each key chunk in its backward (``jax.checkpoint``), which
changes memory, not values. The f32 einsums run in full f32 whatever
the caller's TF32 setting (``core.device.ieee_f32_matmul``).
"""
from __future__ import annotations

import torch

from repro_torch.core.device import ieee_f32_matmul

from .common import pick_chunk

__all__ = ["flash_attention", "decode_attention"]

_NEG = -1e30


def _mask(kind: str, q_pos, k_pos, prefix_len: int, window: int):
    """(qc, kc) bool mask for query positions q_pos and key positions
    k_pos."""
    qp, kp = q_pos[:, None], k_pos[None, :]
    if kind == "full":
        return torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                          device=q_pos.device)
    if kind == "causal":
        return kp <= qp
    if kind == "prefix":
        return (kp <= qp) | (kp < prefix_len)
    if kind == "sliding":
        return (kp <= qp) & (qp - kp < window)
    raise ValueError(kind)


@ieee_f32_matmul()
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    kind: str = "causal", prefix_len: int = 0,
                    window: int = 0, q_chunk: int = 512,
                    k_chunk: int = 1024) -> torch.Tensor:
    """q: (B, S, Hq, dh); k, v: (B, T, Hkv, dh) with Hq % Hkv == 0.
    Returns (B, S, Hq, dh) in q.dtype; softmax in f32.

    Every key chunk is visited (the reference skips chunks outside a
    sliding window; a fully masked chunk leaves the running max, sum
    and accumulator unchanged once a query has seen a key, so the
    values are the same)."""
    B, S, Hq, dh = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qc, kc = pick_chunk(S, q_chunk), pick_chunk(T, k_chunk)
    nq, nk = S // qc, T // kc
    qg = (q.to(torch.float32) * dh**-0.5).reshape(B, nq, qc, Hkv, G, dh)
    kcs = k.reshape(B, nk, kc, Hkv, dh)
    vcs = v.reshape(B, nk, kc, Hkv, dh)
    dev = q.device
    outs = []
    for qi in range(nq):
        q_i = qg[:, qi]  # (B, qc, Hkv, G, dh)
        q_pos = qi * qc + torch.arange(qc, device=dev)
        m = torch.full((B, Hkv, G, qc), _NEG, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, Hkv, G, qc), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, Hkv, G, qc, dh), dtype=torch.float32,
                          device=dev)
        for kj in range(nk):
            k_pos = kj * kc + torch.arange(kc, device=dev)
            s = torch.einsum("bqhgd,bkhd->bhgqk", q_i,
                             kcs[:, kj].to(torch.float32))
            msk = _mask(kind, q_pos, k_pos, prefix_len, window)
            s = torch.where(msk[None, None, None], s, _NEG)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + torch.sum(p, dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p, vcs[:, kj].to(torch.float32))
            m = m_new
        out = acc / torch.clamp_min(l, 1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4))  # (B, qc, Hkv, G, dh)
    out = torch.stack(outs, dim=1).reshape(B, S, Hq, dh)
    return out.to(q.dtype)


@ieee_f32_matmul()
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
