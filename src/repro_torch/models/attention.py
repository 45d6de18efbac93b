"""Attention (port of ``repro.models.attention``): the chunked
flash-style attention of training and full-sequence prefill, decode
attention against a bf16, fp8 or MoR KV cache, and the cache tiers'
quantizers (``quantize_kv``, ``quantize_kv_mor``, ``recompress_kv_nvfp4``)
with their byte and stats accounting.

Training attention is plain PyTorch, as in the reference, where it is
pure JAX (the Pallas ``flash_attention_fwd`` kernel is not on the model
path): queries in chunks of ``q_chunk``, keys and values streamed in
chunks of ``k_chunk`` with an online softmax, in the reference's order.
Its backward is autograd through the same operations; the reference
recomputes each key chunk in its backward (``jax.checkpoint``), which
changes memory, not values. The f32 einsums run in full f32 whatever
the caller's TF32 setting (``core.device.ieee_f32_matmul``).

The KV tiers are plain JAX in the reference (no Pallas kernel) and plain
PyTorch here. Every division the reference makes by or of a number goes
through ``core.formats.true_divide``: PyTorch turns ``number / tensor``
(and, on CUDA, ``tensor / number``) into a reciprocal multiply, which
would write other scales and NVFP4 bytes than the reference's. fp8 values
are clipped before every cast, and payload bytes are bitcast with
``Tensor.view``.
"""
from __future__ import annotations

import torch

from repro_torch.core.device import ieee_f32_matmul
from repro_torch.core.formats import (E2M1_AMAX, E4M3, E5M2, NVFP4,
                                      NVFP4_MICRO, cast_to_format,
                                      decode_e2m1, encode_e2m1,
                                      round_to_e2m1, true_divide)
from repro_torch.core.gam import scales_from_bmax
from repro_torch.kernels.ref import (TAG_BF16, TAG_E4M3, TAG_E5M2,
                                     TAG_NVFP4, pack_mixed)

from .common import pick_chunk

__all__ = ["flash_attention", "decode_attention", "quantize_kv",
           "quantize_kv_mor", "recompress_kv_nvfp4", "kv_bytes_per_element",
           "kv_stats_row"]

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


def _mor_kv_values(payload: torch.Tensor, tags: torch.Tensor) -> torch.Tensor:
    """Tag-select decode of a MoR KV payload into scaled-space f32.

    ``payload``: (..., dh) uint8; ``tags``: (...) per-(position, head)
    tags. E4M3 / E5M2 bytes bitcast per tag; TAG_NVFP4 rows (cold pages)
    hold packed E2M1 nibbles in bytes [0, dh/2) and E4M3 micro-scale
    bytes (one per NVFP4_MICRO elements) at [dh/2, dh/2 + dh/16), decoded
    with the micro scales folded in. The per-block scale stays out: the
    caller divides scores (or probabilities) by it."""
    e4 = payload.view(torch.float8_e4m3fn).to(torch.float32)
    e5 = payload.view(torch.float8_e5m2).to(torch.float32)
    t = tags[..., None]
    vals = torch.where(t == TAG_E5M2, e5, e4)
    dh = payload.shape[-1]
    if dh % NVFP4_MICRO == 0:
        nh = dh // 2
        codes = payload[..., :nh]
        lo = decode_e2m1(codes & 0xF)
        hi = decode_e2m1(codes >> 4)
        pairs = torch.stack([lo, hi], dim=-1).reshape(payload.shape)
        ms = payload[..., nh:nh + dh // NVFP4_MICRO].view(
            torch.float8_e4m3fn).to(torch.float32)
        micro = torch.repeat_interleave(
            torch.where(ms > 0, ms, 1.0), NVFP4_MICRO, dim=-1)
        vals = torch.where(t == TAG_NVFP4, pairs * micro, vals)
    return vals


@ieee_f32_matmul()
def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cur_index, *, window: int = 0,
                     k_scale: torch.Tensor = None,
                     v_scale: torch.Tensor = None,
                     k_tags: torch.Tensor = None,
                     v_tags: torch.Tensor = None) -> torch.Tensor:
    """q: (B, S, Hq, dh), caches: (B, T, Hkv, dh). ``cur_index`` (scalar
    or (B,)) is the position of the last query token per row; query s of
    row b sits at cur_index[b] - (S - 1) + s and sees only cache entries
    at positions <= its own. Softmax in f32.

    fp8 caches: float8_e4m3fn payloads with per-(position, head) scales
    (B, T, Hkv), folded out of both einsums (scores divide by k_scale,
    probabilities by v_scale). MoR caches: uint8 payloads with
    ``k_tags`` / ``v_tags`` choosing E4M3 / E5M2 / NVFP4 per row.

    Garbage hygiene (quantized caches), as the reference: the score
    divide sits inside the validity mask (trash-page scales never reach a
    kept score), and value rows past each row's position are zeroed
    before the P V einsum (0 * NaN would poison the row). A bf16 cache
    keeps the guard-free graph."""
    B, S, Hq, dh = q.shape
    T, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    qg = (q.to(torch.float32) * dh**-0.5).reshape(B, S, Hkv, G, dh)
    kv = (_mor_kv_values(k_cache, k_tags) if k_tags is not None
          else k_cache.to(torch.float32))
    s = torch.einsum("bshgd,bkhd->bhgsk", qg, kv)
    cur = torch.as_tensor(cur_index, dtype=torch.int64,
                          device=q.device).reshape(-1).expand(B)
    q_pos = cur[:, None] - (S - 1) + torch.arange(S, device=q.device)
    k_pos = torch.arange(T, device=q.device)
    valid = k_pos[None, None, :] <= q_pos[:, :, None]  # (B, S, T)
    if window:
        valid &= k_pos[None, None, :] > q_pos[:, :, None] - window
    vmask = valid[:, None, None]  # (B, 1, 1, S, T)
    if k_scale is not None:
        ks = torch.where(k_scale > 0, k_scale, 1.0)  # empty rows: scale 0
        s = torch.where(
            vmask, s / ks.permute(0, 2, 1)[:, :, None, None, :], _NEG)
    else:
        s = torch.where(vmask, s, _NEG)
    p = torch.softmax(s, dim=-1)
    if v_scale is not None:
        vs = torch.where(v_scale > 0, v_scale, 1.0)
        p = torch.where(
            vmask, p / vs.permute(0, 2, 1)[:, :, None, None, :], 0.0)
    vv = (_mor_kv_values(v_cache, v_tags) if v_tags is not None
          else v_cache.to(torch.float32))
    if v_tags is not None or v_scale is not None:
        k_any = k_pos[None, :] <= cur[:, None]  # (B, T)
        vv = torch.where(k_any[:, :, None, None], vv, 0.0)
    out = torch.einsum("bhgsk,bkhd->bshgd", p, vv)
    return out.reshape(B, S, Hq, dh).to(q.dtype)


def quantize_kv(x: torch.Tensor):
    """(B, S, H, dh) -> (float8_e4m3fn payload, (B, S, H) f32 scales)."""
    xf = x.to(torch.float32)
    amax = torch.amax(xf.abs(), dim=-1)
    s = torch.where(amax > 0, true_divide(448.0, amax), 1.0)
    payload = torch.clamp(xf * s[..., None], -448.0, 448.0).to(
        torch.float8_e4m3fn)
    return payload, s


# The MoR cache tier's block is one (position, head) row, so a block
# scale is constant along dh, the contraction axis of both attention
# einsums, and folds into score space. The hot mixture is the two fp8
# arms of the cascade (Eq. 3 per row); TAG_NVFP4 marks cold pages.


def quantize_kv_mor(x: torch.Tensor, with_stats: bool = False):
    """MoR-quantize KV rows: (B, S, H, dh) -> (payload (B, S, H, dh)
    uint8, tags (B, S, H) uint8, scales (B, S, H) f32).

    Per (position, head) row: both GAM fp8 candidates (one group over
    every row of the call), the Eq. 3 relative-error comparison, and the
    winner's payload bytes through ``pack_mixed`` (the GEMM-side packer's
    bytes for the same tags). Written rows have scales > 0; unwritten
    cache rows keep their zero scale, the emptiness marker decode keys
    on. With ``with_stats`` also returns :func:`kv_stats_row`."""
    B, S, H, dh = x.shape
    x2 = x.to(torch.float32).reshape(B * S * H, dh)
    bmax = torch.amax(x2.abs(), dim=-1, keepdim=True)  # (R, 1)
    s4 = scales_from_bmax(bmax, E4M3, "gam").scale
    s5 = scales_from_bmax(bmax, E5M2, "gam").scale
    nz = x2 != 0
    safe = torch.where(nz, x2, 1.0)

    def err(s, fmt):
        dq = cast_to_format(torch.clamp(x2 * s, -fmt.amax, fmt.amax),
                            fmt) / s
        return torch.sum(torch.where(nz, ((x2 - dq) / safe).abs(), 0.0),
                         dim=-1)

    sel = torch.where(err(s4, E4M3) < err(s5, E5M2), TAG_E4M3,
                      TAG_E5M2)  # Eq. 3, two fp8 arms
    mo = pack_mixed(x2, sel.reshape(-1, 1), (1, dh))
    payload = mo.payload_q.reshape(B, S, H, dh)
    tags = sel.to(torch.uint8).reshape(B, S, H)
    scales = mo.scales.to(torch.float32).reshape(B, S, H)
    if with_stats:
        return payload, tags, scales, kv_stats_row(tags)
    return payload, tags, scales


def recompress_kv_nvfp4(payload: torch.Tensor, tags: torch.Tensor,
                        scales: torch.Tensor):
    """Sub4-recompress cold KV rows in place of their fp8 payloads.

    ``payload`` (..., H, dh) uint8, ``tags`` / ``scales`` (..., H), any
    leading shape (the pool passes whole page slabs; one GAM group over
    all of it). Each row re-encodes from its stored hot-tier values to
    two-level NVFP4: packed E2M1 nibble pairs in bytes [0, dh/2), E4M3
    micro-scale bytes at [dh/2, dh/2 + dh/16), the rest zero (0.5625
    logical bytes an element). Requires ``dh % NVFP4_MICRO == 0``."""
    dh = payload.shape[-1]
    if dh % NVFP4_MICRO:
        raise ValueError(
            f"sub4 KV recompression needs head_dim divisible by "
            f"{NVFP4_MICRO}, got {dh}")
    ss = torch.where(scales > 0, scales, 1.0)[..., None]
    vals = _mor_kv_values(payload, tags) / ss  # stored true values
    bmax = torch.amax(vals.abs(), dim=-1, keepdim=True)
    s_nv = scales_from_bmax(bmax, NVFP4, "gam").scale
    xs = vals * s_nv
    g = xs.reshape(*xs.shape[:-1], dh // NVFP4_MICRO, NVFP4_MICRO)
    d = true_divide(torch.amax(g.abs(), dim=-1), E2M1_AMAX)
    d_q = cast_to_format(d, E4M3)
    safe_d = torch.where(d_q > 0, d_q, 1.0)
    codes = encode_e2m1(round_to_e2m1(g / safe_d[..., None])).reshape(
        xs.shape).to(torch.uint8)
    nib = codes[..., 0::2] | (codes[..., 1::2] << 4)
    ms = safe_d.to(torch.float8_e4m3fn).view(torch.uint8)
    pad = torch.zeros((*payload.shape[:-1],
                       dh - dh // 2 - dh // NVFP4_MICRO),
                      dtype=torch.uint8, device=payload.device)
    new_payload = torch.cat([nib, ms, pad], dim=-1)
    new_tags = torch.full_like(tags, TAG_NVFP4)
    return new_payload, new_tags, s_nv[..., 0].to(torch.float32)


# Logical payload bytes per cache element by tag (fp8 byte, BF16 pair,
# NVFP4 nibble + its amortized micro-scale byte).
_TAG_BPE = {
    TAG_E4M3: 1.0,
    TAG_E5M2: 1.0,
    TAG_BF16: 2.0,
    TAG_NVFP4: 0.5 + 1.0 / NVFP4_MICRO,
}


def _mean(v: torch.Tensor) -> torch.Tensor:
    """jnp.mean of an f32 vector as XLA computes it: the sum times the
    f32 reciprocal of the count."""
    return torch.sum(v) * true_divide(1.0, v.new_full((), v.numel()))


def kv_bytes_per_element(tags: torch.Tensor) -> torch.Tensor:
    """Mean logical payload bytes per element implied by ``tags``."""
    t = torch.as_tensor(tags).reshape(-1).to(torch.int32)
    bpe = torch.zeros(t.shape, dtype=torch.float32, device=t.device)
    for tag, b in _TAG_BPE.items():
        bpe = torch.where(t == tag, b, bpe)
    return _mean(bpe)


def kv_stats_row(tags: torch.Tensor) -> torch.Tensor:
    """One STATS_WIDTH stats row for a KV-cache quantization event, the
    GEMM events' layout (core.mor): decision 1.0, the tag fractions, the
    block count, m_g slot 1.0, frac_nvfp4, micro-scale and payload bytes
    per element; rel_err, amax and event_kind stay 0."""
    from repro_torch.core.mor import (STAT_DECISION, STAT_FRAC_BF16,
                                      STAT_FRAC_E4M3, STAT_FRAC_E5M2,
                                      STAT_FRAC_NVFP4, STAT_GROUP_MANTISSA,
                                      STAT_MICRO_SCALE_BPE,
                                      STAT_NONZERO_FRAC, STAT_PAYLOAD_BPE,
                                      STATS_WIDTH)

    t = torch.as_tensor(tags).reshape(-1).to(torch.int32)
    frac = {tag: _mean((t == tag).to(torch.float32))
            for tag in (TAG_E4M3, TAG_E5M2, TAG_BF16, TAG_NVFP4)}
    f_nv = frac[TAG_NVFP4]
    row = torch.zeros((STATS_WIDTH,), dtype=torch.float32, device=t.device)
    row[STAT_DECISION] = 1.0
    row[STAT_FRAC_E4M3] = frac[TAG_E4M3]
    row[STAT_FRAC_E5M2] = frac[TAG_E5M2]
    row[STAT_FRAC_BF16] = frac[TAG_BF16]
    row[STAT_NONZERO_FRAC] = float(t.numel())
    row[STAT_GROUP_MANTISSA] = 1.0
    row[STAT_FRAC_NVFP4] = f_nv
    row[STAT_MICRO_SCALE_BPE] = f_nv / NVFP4_MICRO
    row[STAT_PAYLOAD_BPE] = (frac[TAG_E4M3] + frac[TAG_E5M2]
                             + 2.0 * frac[TAG_BF16]
                             + (0.5 + 1.0 / NVFP4_MICRO) * f_nv)
    return row
