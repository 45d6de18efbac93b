"""Transformer sublayers with MoR-quantized linears (port of the dense
path of ``repro.models.blocks``).

Block functions share the reference's signature
    f(p, x, tok, policy, cfg, mode, cache, cur_index) -> (x, cache, stats)
where ``p``, ``tok`` and ``cache`` are this layer's slices. ``tok`` holds
one :func:`~repro_torch.core.linear.new_token` per GEMM ('qkv', 'proj',
'fc1', 'fc2'; None where nothing differentiates, as in serving). Train
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
from repro_torch.core.linear import mor_dot
from repro_torch.core.policy import MoRDotPolicy

from .attention import (decode_attention, flash_attention, quantize_kv,
                        quantize_kv_mor)
from .common import activation, apply_rope, glu_split, layer_norm, rms_norm

__all__ = ["norm", "attn_sublayer", "mlp_sublayer", "dense_block"]


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


def mlp_sublayer(p, xn, tok, policy: MoRDotPolicy, cfg: ArchConfig):
    gated = cfg.act in ("swiglu", "geglu")
    h, st1 = mor_dot(xn, p["wi"], _tok(tok, "fc1"), policy)
    h = glu_split(h, gated, activation(cfg.act))
    y, st2 = mor_dot(h, p["wo"], _tok(tok, "fc2"), policy)
    return y, {"fc1": st1, "fc2": st2}


def dense_block(p, x, tok, policy, cfg, mode, cache, cur_index, **attn_kw):
    xn = norm(p["ln1"], x, cfg)
    a, new_cache, st_a = attn_sublayer(p, xn, tok, policy, cfg, mode, cache,
                                       cur_index, **attn_kw)
    x = x + a
    xn2 = norm(p["ln2"], x, cfg)
    m, st_m = mlp_sublayer(p["mlp"], xn2, tok, policy, cfg)
    x = x + m
    return x, new_cache, {**st_a, **st_m}
