"""Transformer sublayers with MoR-quantized linears (port of
``repro.models.blocks``: the attention, MLP and MoE sublayers and the
dense and MoE blocks).

Block functions share the reference's signature
    f(p, x, tok, policy, cfg, mode, cache, cur_index) -> (x, cache, stats)
where ``p``, ``tok`` and ``cache`` are this layer's slices. ``tok`` holds
one :func:`~repro_torch.core.linear.new_token` per GEMM ('qkv', 'proj',
'fc1', 'fc2'; an MoE layer's 'w1' / 'w2' stack one per expert; None
where nothing differentiates, as in serving). Train
mode runs causal attention over the whole sequence and keeps no cache;
prefill mode does the same and emits the layer's bf16 K/V; decode mode
writes the incoming tokens' K/V into ``cache`` in place (the engine hands
each step a freshly gathered cache) and returns it. A cache with
``k_tags`` is the MoR tier, one with only ``k_scale`` the fp8 tier.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import ieee_f32_matmul
from repro_torch.core.formats import true_divide
from repro_torch.core.linear import mor_dot, mor_dot_experts
from repro_torch.core.policy import MoRDotPolicy

from .attention import (decode_attention, flash_attention, quantize_kv,
                        quantize_kv_mor)
from .common import (activation, apply_rope, glu_split, layer_norm,
                     pick_chunk, rms_norm)

__all__ = ["norm", "attn_sublayer", "mlp_sublayer", "moe_sublayer",
           "dense_block", "moe_block"]


def norm(p_norm, x, cfg: ArchConfig):
    if cfg.norm == "ln":
        return layer_norm(x, p_norm["scale"], p_norm["bias"])
    return rms_norm(x, p_norm["scale"])


def _split_qkv(qkv, cfg: ArchConfig):
    B, S = qkv.shape[:2]
    hq, hkv, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    q, k, v = torch.split(qkv, [hq * hd, hkv * hd, hkv * hd], dim=-1)
    return (q.reshape(B, S, hq, hd), k.reshape(B, S, hkv, hd),
            v.reshape(B, S, hkv, hd))


def _tok(tok, name):
    return None if tok is None else tok[name]


def attn_sublayer(p, xn, tok, policy: MoRDotPolicy, cfg: ArchConfig,
                  mode: str, cache: Optional[Dict[str, torch.Tensor]],
                  cur_index, *, kind: str = "causal", prefix_len: int = 0,
                  window: int = 0, use_rope: bool = True):
    """GQA self-attention with RoPE. Train and prefill modes: the whole
    sequence, chunked flash attention, no cache input (prefill returns
    the bf16 K/V). Decode mode: against the KV cache (S == 1 for a decode
    step, S > 1 for a prefill chunk), quantizing the new K/V into the
    cache's tier first."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"attention mode {mode!r}")
    B, S, _ = xn.shape
    qkv, st_qkv = mor_dot(xn, p["wqkv"], _tok(tok, "qkv"), policy)
    q, k, v = _split_qkv(qkv, cfg)
    if mode != "decode":
        pos = torch.arange(S, device=xn.device)[None]
        if use_rope:
            q = apply_rope(q, pos, cfg.rope_theta)
            k = apply_rope(k, pos, cfg.rope_theta)
        out = flash_attention(q, k, v, kind=kind, prefix_len=prefix_len,
                              window=window)
        new_cache = ({"k": k.to(torch.bfloat16), "v": v.to(torch.bfloat16)}
                     if mode == "prefill" else None)
        out = out.reshape(B, S, cfg.n_heads * cfg.head_dim)
        y, st_proj = mor_dot(out, p["wo"], _tok(tok, "proj"), policy)
        return y, new_cache, {"qkv": st_qkv, "proj": st_proj}
    cur = torch.as_tensor(cur_index, dtype=torch.int64,
                          device=xn.device).reshape(-1).expand(B)
    pos = cur[:, None] - (S - 1) + torch.arange(S, device=xn.device)[None]
    if use_rope:
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    rows = torch.arange(B, device=xn.device)[:, None]

    def upd(name, val):
        cache[name][rows, pos] = val.to(cache[name].dtype)

    if "k_tags" in cache:
        # MoR tier: per-(position, head) tag-select between the fp8 arms
        # with GAM scales; decode folds the scales into score space.
        for name, x in (("k", k), ("v", v)):
            pay, tags, sc = quantize_kv_mor(x)
            upd(name, pay)
            upd(name + "_tags", tags)
            upd(name + "_scale", sc)
        extra = {n: cache[n] for n in ("k_scale", "v_scale", "k_tags",
                                       "v_tags")}
    elif "k_scale" in cache:
        for name, x in (("k", k), ("v", v)):
            pay, sc = quantize_kv(x)
            upd(name, pay)
            upd(name + "_scale", sc)
        extra = {n: cache[n] for n in ("k_scale", "v_scale")}
    else:
        upd("k", k)
        upd("v", v)
        extra = {}
    out = decode_attention(q, cache["k"], cache["v"], cur, window=window,
                           **extra)
    out = out.reshape(B, S, cfg.n_heads * cfg.head_dim)
    y, st_proj = mor_dot(out, p["wo"], _tok(tok, "proj"), policy)
    return y, cache, {"qkv": st_qkv, "proj": st_proj}


def mlp_sublayer(p, xn, tok, policy: MoRDotPolicy, cfg: ArchConfig,
                 d_ff: Optional[int] = None):
    gated = cfg.act in ("swiglu", "geglu")
    h, st1 = mor_dot(xn, p["wi"], _tok(tok, "fc1"), policy)
    h = glu_split(h, gated, activation(cfg.act))
    y, st2 = mor_dot(h, p["wo"], _tok(tok, "fc2"), policy)
    return y, {"fc1": st1, "fc2": st2}


def _mean_rows(rows):
    """jnp.mean over a leading axis as XLA computes it: the rows summed
    left to right, times the f32 reciprocal of their count."""
    acc = rows[0] + 0.0
    for r in rows[1:]:
        acc = acc + r
    return acc * true_divide(1.0, acc.new_full((), len(rows)))


def _mean_tokens(v: torch.Tensor) -> torch.Tensor:
    """jnp.mean over the (batch, token) axes of a (B, t, ...) tensor: the
    sum times the f32 reciprocal of B * t."""
    n = v.shape[0] * v.shape[1]
    return torch.sum(v, dim=(0, 1)) * true_divide(1.0, v.new_full((), n))


def _dropped(keep: torch.Tensor) -> torch.Tensor:
    """1 - jnp.mean(keep) as XLA's CPU compiler computes it: the sum
    times the f32 reciprocal of the count, contracted with the
    subtraction into one fused multiply-add. In f64 the product of the
    integer sum and the reciprocal and the difference from 1 are exact,
    so one rounding to f32 gives the fused result."""
    r = true_divide(1.0, keep.new_full((), keep.numel()))
    return (1.0 - torch.sum(keep).double() * r.double()).to(torch.float32)


def _slots(ids: torch.Tensor, E: int, C: int):
    """(expert one-hot (B, tK, E), slot one-hot (B, tK, C), keep (B, tK))
    of the token-major copies ``ids``: a copy's slot is the number of
    earlier copies of its example sent to its expert; copies at slot C
    or beyond are dropped (their slot row is zero)."""
    oh = torch.nn.functional.one_hot(ids, E).to(torch.float32)
    slot = torch.sum((torch.cumsum(oh, dim=1) - oh) * oh, dim=-1)
    keep = (slot < C).to(torch.float32)
    slot_oh = torch.nn.functional.one_hot(
        torch.clamp_max(slot, C - 1).to(torch.int64), C).to(
            torch.float32) * keep[..., None]
    return oh, slot_oh, keep


def _aux_loss(oh: torch.Tensor, probs: torch.Tensor, K: int):
    """Switch-style load balance of one chunk: E * sum(me * ce), with me
    the mean over tokens of each expert's share of the K copies and ce
    its mean router probability."""
    B, tK, E = oh.shape
    me = _mean_tokens(oh.reshape(B, tK // K, K, E).sum(2))
    return torch.sum(me * _mean_tokens(probs)) * E


def _route(x_c, router, K: int):
    """Router probabilities (f32 softmax of the f32 product) and the
    top-K experts of each token, renormalised gates first."""
    with ieee_f32_matmul():
        # bf16 activations against an f32 (or, after an AdamW step, a
        # bf16) router: both promoted to f32, as the reference's einsum.
        logits = x_c.to(torch.float32) @ router.to(torch.float32)
    e = torch.exp(logits - logits.amax(-1, keepdim=True).detach())
    probs = true_divide(e, torch.sum(e, -1, keepdim=True))
    # jax.lax.top_k: largest first, the lower index first on ties (a
    # stable descending sort).
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :K], idx[..., :K]
    vals = true_divide(vals, torch.clamp_min(
        torch.sum(vals, -1, keepdim=True), 1e-9))
    return probs, vals, idx


def moe_sublayer(p, xn, tok, policy: MoRDotPolicy, cfg: ArchConfig):
    """Capacity-limited top-K MoE with per-(example, chunk) grouping.

    The sequence is cut into ``pick_chunk(S, 256)``-token chunks; in each
    one every example dispatches its tokens' K copies (token-major) into
    an (E, C) slot buffer, C = max(1, int(K * t / E * capacity_factor)),
    copies past an expert's C-th dropped. Dispatch and combine are the
    reference's one-hot contractions as f32 matmuls of the masks: every
    output is one product, exact in any summation order, and a NaN in
    any slot reaches every token of its example (0 * NaN), as in the
    reference. The experts' FFNs are ``mor_dot_experts`` (the
    reference's ``vmap(mor_dot)``: each expert's events its own, each
    with its own token) under the layer's policy. Returns (y, stats):
    'w1' / 'w2' (E, N_FWD_EVENTS, STATS_WIDTH) and the scalars
    'aux_loss' (Switch-style load balance) and 'dropped', each averaged
    over chunks."""
    B, S, d = xn.shape
    E, K = cfg.n_experts, cfg.top_k
    gated = cfg.act in ("swiglu", "geglu")
    act_fn = activation(cfg.act)
    s_sub = pick_chunk(S, 256)
    C = max(1, int(K * s_sub / E * cfg.capacity_factor))
    tok_w1, tok_w2 = _tok(tok, "w1"), _tok(tok, "w2")
    ys, st1s, st2s, auxs, drops = [], [], [], [], []
    for c0 in range(0, S, s_sub):
        x_c = xn[:, c0:c0 + s_sub]
        t = x_c.shape[1]
        probs, vals, idx = _route(x_c, p["router"], K)
        ids = idx.reshape(B, t * K)
        gate = vals.reshape(B, t * K)
        oh, slot_oh, keep = _slots(ids, E, C)
        x_rep = torch.repeat_interleave(x_c.to(torch.float32), K, dim=1)
        # (B, tK, E * C): copy s of example b sits in slot (e, c).
        mask = (oh[..., :, None] * slot_oh[..., None, :]).reshape(
            B, t * K, E * C)
        with ieee_f32_matmul():
            # "bse,bsc,bsd->ebcd"
            xbuf = (mask.transpose(1, 2) @ x_rep).reshape(
                B, E, C, d).transpose(0, 1).to(xn.dtype)
        h, st1 = mor_dot_experts(xbuf.reshape(E, B * C, d), p["w1"],
                                 tok_w1, policy)
        h = glu_split(h, gated, act_fn)
        ybuf, st2 = mor_dot_experts(h, p["w2"], tok_w2, policy)
        ybuf = ybuf.reshape(E, B, C, d).to(torch.float32)
        with ieee_f32_matmul():
            # "bse,bsc,bs,ebcd->bsd"
            y = (mask * gate[..., None]) @ ybuf.transpose(0, 1).reshape(
                B, E * C, d)
        # The sum over the K copies, left to right.
        y = y.reshape(B, t, K, d)
        acc = y[:, :, 0] + 0.0
        for k in range(1, K):
            acc = acc + y[:, :, k]
        ys.append(acc.to(xn.dtype))
        st1s.append(st1)
        st2s.append(st2)
        auxs.append(_aux_loss(oh, probs, K))
        drops.append(_dropped(keep))
    return torch.cat(ys, dim=1), {
        "w1": _mean_rows(st1s), "w2": _mean_rows(st2s),
        "aux_loss": _mean_rows(auxs), "dropped": _mean_rows(drops)}


def dense_block(p, x, tok, policy, cfg, mode, cache, cur_index, **attn_kw):
    xn = norm(p["ln1"], x, cfg)
    a, new_cache, st_a = attn_sublayer(p, xn, tok, policy, cfg, mode, cache,
                                       cur_index, **attn_kw)
    x = x + a
    xn2 = norm(p["ln2"], x, cfg)
    m, st_m = mlp_sublayer(p["mlp"], xn2, tok, policy, cfg)
    x = x + m
    return x, new_cache, {**st_a, **st_m}


def moe_block(p, x, tok, policy, cfg, mode, cache, cur_index, **attn_kw):
    xn = norm(p["ln1"], x, cfg)
    a, new_cache, st_a = attn_sublayer(p, xn, tok, policy, cfg, mode, cache,
                                       cur_index, **attn_kw)
    x = x + a
    xn2 = norm(p["ln2"], x, cfg)
    m, st_m = moe_sublayer(p["moe"], xn2, tok, policy, cfg)
    x = x + m
    return x, new_cache, {**st_a, **st_m}
