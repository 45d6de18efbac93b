"""Model assembly for every family of the reference: dense, MoE, vlm,
audio, hybrid (hymba) and ssm (xLSTM) (port of the train, prefill and
decode paths of ``repro.models.transformer``).

Parameters are nested dicts with the reference's key paths
(``blocks/dense/wqkv``, ``blocks/dense/mlp/wi``, ``blocks/moe/moe/w1``,
``blocks/moe/moe/router``, ``blocks/wdec/xwkv``, ``enc/blocks/wqkv``,
``lm_head``, ``embed``, ``blocks/dense/ln1/scale``,
``blocks/hymba/ssm/w_in``, ``blocks/mlstm/w_qkv``, ...) keyed by the
unit's layer types; per-layer leaves are stacked on a leading layer axis
(an MoE layer's experts on the next one). Embeddings are padded to a
multiple of 128 rows and the padded logit columns are masked to -1e30.
The decode cache has the reference's three tiers: bf16 K/V, fp8
(``kv_fp8``) and MoR (``kv_mor``); an MoE layer's KV lanes are a dense
layer's.

The vlm family (paligemma) puts ``batch['patches']`` (stub patch
embeddings) before the token embeddings in train and prefill modes and
attends with the ``prefix`` mask there; decode stays causal over the
cache, whose positions count the image tokens. The audio family
(whisper) adds sinusoidal positions, runs the encoder stack
(``params['enc']``: dense layers, bidirectional, no rope) on
``batch['frames']`` and decodes with ``wdec`` layers: causal
self-attention and cross-attention on the encoder output, whose K/V
(``xk`` / ``xv``) the prefill cache holds. It serves on the bf16 KV tier
only (:func:`cache_specs`).

The recurrent families (``models.recurrent``): a ``hymba`` layer runs
sliding-window attention (``cfg.window``, in every mode) and the mamba
mixer in parallel on the same normed input; its cache holds the K/V
lanes and the mixer's state under ``ssm`` (``hymba/ssm/h``,
``hymba/ssm/conv``), and it serves on the bf16 KV tier only. xLSTM's
unit is an ``mlstm`` and an ``slstm`` layer, whose caches are their
recurrent state alone (no K/V lanes, so the KV tiers change nothing).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import ieee_f32_matmul, resolve_device
from repro_torch.core.linear import N_BWD_EVENTS, mor_dot
from repro_torch.core.mor import STATS_WIDTH
from repro_torch.core.policy import MoRDotPolicy

from . import blocks as B
from . import recurrent as R
from .attention import flash_attention
from .common import sinusoidal_at, sinusoidal_positions

__all__ = ["init_params", "make_tokens", "cache_specs", "init_cache",
           "forward", "padded_vocab", "resolve_device"]

_DENSE_NAMES = ("qkv", "proj", "fc1", "fc2")
_WDEC_NAMES = ("qkv", "proj", "xq", "xkv", "xproj", "fc1", "fc2")
# The GEMMs of each layer type (its tokens and stats rows).
_GEMM_NAMES = {"dense": _DENSE_NAMES, "wdec": _WDEC_NAMES,
               "hymba": ("qkv", "proj", "ssm_in", "ssm_out", "fc1", "fc2"),
               "mlstm": ("up", "qkv", "down"), "slstm": ("wx", "ff1", "ff2")}


def padded_vocab(cfg: ArchConfig) -> int:
    return -(-cfg.vocab // 128) * 128


def _unit_types(cfg: ArchConfig) -> Tuple[str, ...]:
    """The layer types of one unit (the audio family's decoder layers are
    ``wdec``); an unknown type raises, as in the reference."""
    if cfg.family == "audio":
        return ("wdec",)
    for t in cfg.unit:
        if t not in _BLOCK_FN:
            raise ValueError(t)
    return tuple(cfg.unit)


def _ffin(cfg: ArchConfig, f: int) -> int:
    return 2 * f if cfg.act in ("swiglu", "geglu") else f


def init_params(cfg: ArchConfig, seed: int = 0,
                device="cuda") -> Dict[str, Any]:
    """Random parameters from a seeded ``torch.Generator`` on ``device``
    (the reference's structure, scales and dtypes; torch cannot replay
    ``jax.random``, so the values differ -- tests carry the JAX draw
    across with ``repro_torch.convert``)."""
    types = _unit_types(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    d, f = cfg.d_model, cfg.d_ff
    hq, hkv, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    Vp = padded_vocab(cfg)
    depth_std = 0.02 / max(1.0, (2 * cfg.n_layers) ** 0.5)

    def normal(shape, std, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device=dev,
                            dtype=torch.float32) * std).to(dtype)

    def stacked(L, shape, std, dtype=torch.bfloat16):
        # One layer at a time: the f32 draw of a whole stack would not
        # fit beside the model at full width.
        out = torch.empty((L, *shape), dtype=dtype, device=dev)
        for l in range(L):
            out[l] = normal(shape, std, dtype)
        return out

    def norm_p(*lead):
        # Zero scales (and, under layer norm, zero biases), as the
        # reference's _norm_p.
        p = {"scale": torch.zeros((*lead, d), device=dev)}
        if cfg.norm == "ln":
            p["bias"] = torch.zeros((*lead, d), device=dev)
        return p

    def f32_of_bf16(L, shape, std):
        # The reference's _lin(...).astype(f32): bf16 values, f32 dtype.
        return stacked(L, shape, std).to(torch.float32)

    def mamba(L):
        di, N, cw = cfg.mamba_d_inner, cfg.ssm_state, cfg.conv_width
        r = max(1, d // 16)
        a_log = torch.log(torch.arange(1, N + 1, dtype=torch.float32,
                                       device=dev))
        return {"w_in": stacked(L, (d, 2 * di), 0.02),
                "conv_w": stacked(L, (cw, di), 0.02, torch.float32),
                "w_bc": f32_of_bf16(L, (di, 2 * N), 0.02),
                "w_dt_down": f32_of_bf16(L, (di, r), 0.02),
                "w_dt_up": f32_of_bf16(L, (r, di), 0.02),
                # softplus^-1(0.01)
                "dt_bias": torch.full((L, di), -4.6, device=dev),
                "A_log": a_log.expand(L, di, N).contiguous(),
                "D": torch.ones((L, di), device=dev),
                "w_out": stacked(L, (di, d), depth_std)}

    def mlstm(L):
        di, H = 2 * d, cfg.n_heads
        bias = torch.cat([torch.zeros(H, device=dev),
                          torch.full((H,), 3.0, device=dev)])
        return {"ln1": norm_p(L), "w_up": stacked(L, (d, 2 * di), 0.02),
                "w_qkv": stacked(L, (di, 3 * di), 0.02),
                "w_gate": stacked(L, (di, 2 * H), 0.02),
                "gate_bias": bias.expand(L, 2 * H).contiguous(),
                "out_norm": torch.zeros((L, di), device=dev),
                "w_down": stacked(L, (di, d), depth_std)}

    def slstm(L):
        H = cfg.n_heads
        dh, ff = d // H, -(-int(d * 4 / 3) // 64) * 64
        return {"ln1": norm_p(L), "w_x": stacked(L, (d, 4 * d), 0.02),
                "r": stacked(L, (H, dh, 4 * dh), 0.02),
                "out_norm": torch.zeros((L, d), device=dev),
                "w_ff1": stacked(L, (d, 2 * ff), 0.02),
                "w_ff2": stacked(L, (ff, d), depth_std)}

    def layer(t, L):
        if t == "mlstm":
            return mlstm(L)
        if t == "slstm":
            return slstm(L)
        p = {"wqkv": stacked(L, (d, (hq + 2 * hkv) * hd), 0.02),
             "wo": stacked(L, (hq * hd, d), depth_std)}
        if t == "wdec":
            p["xwq"] = stacked(L, (d, hq * hd), 0.02)
            p["xwkv"] = stacked(L, (d, 2 * hkv * hd), 0.02)
            p["xwo"] = stacked(L, (hq * hd, d), depth_std)
            p["lnx"] = norm_p(L)
        if t == "moe":
            E = cfg.n_experts
            p["moe"] = {"router": stacked(L, (d, E), 0.02, torch.float32),
                        "w1": stacked(L, (E, d, _ffin(cfg, f)), 0.02),
                        "w2": stacked(L, (E, f, d), depth_std)}
        else:
            p["mlp"] = {"wi": stacked(L, (d, _ffin(cfg, f)), 0.02),
                        "wo": stacked(L, (f, d), depth_std)}
        if t == "hymba":
            p["ssm"] = mamba(L)
        p["ln1"] = norm_p(L)
        p["ln2"] = norm_p(L)
        return p

    embed = normal((Vp, d), 0.02)
    embed[cfg.vocab:] = 0
    params: Dict[str, Any] = {"embed": embed, "final_norm": norm_p()}
    if not cfg.tie_embed:
        params["lm_head"] = normal((d, Vp), 0.02)
    params["blocks"] = {t: layer(t, cfg.n_units) for t in types}
    if cfg.family == "audio":  # the whisper encoder stack
        params["enc"] = {"blocks": layer("dense", cfg.enc_layers),
                         "final_norm": norm_p()}
    return params


def _layer_tokens(t: str, cfg: ArchConfig):
    """{GEMM name: token shape} of one layer of type ``t``."""
    one = (N_BWD_EVENTS, STATS_WIDTH)
    if t == "moe":
        per_expert = (cfg.n_experts, *one)
        return {"qkv": one, "proj": one, "w1": per_expert, "w2": per_expert}
    return {n: one for n in _GEMM_NAMES[t]}


def make_tokens(cfg: ArchConfig, device="cuda"):
    """Zero bwd-stat tokens, stacked over layers: one (N_BWD_EVENTS,
    STATS_WIDTH) token per GEMM of a layer, one per expert for an MoE
    layer's 'w1' / 'w2'; the audio family's encoder layers under 'enc'
    (stacked over ``enc_layers``). Each requires grad, and its gradient
    carries the backward quantization stats out of the train step."""
    types = _unit_types(cfg)
    dev = resolve_device(device)

    def stack(t, L):
        return {n: torch.zeros((L, *shape), dtype=torch.float32,
                               device=dev, requires_grad=True)
                for n, shape in _layer_tokens(t, cfg).items()}

    toks = {"blocks": {t: stack(t, cfg.n_units) for t in types}}
    if cfg.family == "audio":
        toks["enc"] = stack("dense", cfg.enc_layers)
    return toks


def cache_specs(cfg: ArchConfig, batch: int, seq: int,
                kv_fp8: bool = False, kv_mor: bool = False):
    """{unit type: {leaf: (shape, dtype)}} of the decode cache, stacked
    over layers: bf16 K/V; with ``kv_fp8`` float8_e4m3fn K/V payloads and
    per-(position, head) f32 scales; with ``kv_mor`` uint8 K/V payloads,
    uint8 tags and f32 GAM scales (the reference's lanes and dtypes). The
    dense and MoE layer types hold the same lanes; a ``wdec`` layer adds
    the cross-attention's bf16 ``xk`` / ``xv`` (L, batch, enc_seq, hkv,
    hd) and takes the bf16 tier only (:func:`_refuse_kv_tier`), as does a
    ``hymba`` layer, whose ``ssm`` holds the mamba state (``h`` (L, batch,
    di, N) f32, ``conv`` (L, batch, cw - 1, di) bf16). The ``mlstm`` and
    ``slstm`` layers hold their f32 state alone (``C`` / ``n`` / ``m``;
    ``h`` / ``c`` / ``n`` / ``m``), on every tier."""
    types = _unit_types(cfg)
    if kv_fp8 and kv_mor:
        raise ValueError("kv_fp8 and kv_mor are mutually exclusive")
    if kv_fp8 or kv_mor:
        _refuse_kv_tier(cfg, "kv_fp8" if kv_fp8 else "kv_mor")
    L, hkv, hd = cfg.n_units, cfg.n_kv, cfg.head_dim
    kv = (L, batch, seq, hkv, hd)
    row = (L, batch, seq, hkv)
    if kv_mor:
        leaves = {"k": (kv, torch.uint8), "v": (kv, torch.uint8),
                  "k_tags": (row, torch.uint8), "v_tags": (row, torch.uint8),
                  "k_scale": (row, torch.float32),
                  "v_scale": (row, torch.float32)}
    elif kv_fp8:
        leaves = {"k": (kv, torch.float8_e4m3fn),
                  "v": (kv, torch.float8_e4m3fn),
                  "k_scale": (row, torch.float32),
                  "v_scale": (row, torch.float32)}
    else:
        leaves = {"k": (kv, torch.bfloat16), "v": (kv, torch.bfloat16)}
    f32 = torch.float32
    out = {}
    for t in types:
        if t == "mlstm":
            H, dh = cfg.n_heads, 2 * cfg.d_model // cfg.n_heads
            out[t] = {"C": ((L, batch, H, dh, dh), f32),
                      "n": ((L, batch, H, dh), f32),
                      "m": ((L, batch, H), f32)}
        elif t == "slstm":
            out[t] = {n: ((L, batch, cfg.d_model), f32)
                      for n in ("h", "c", "n", "m")}
        else:
            out[t] = dict(leaves)
    if "wdec" in out:
        x = ((L, batch, cfg.enc_seq, hkv, hd), torch.bfloat16)
        out["wdec"].update(xk=x, xv=x)
    if "hymba" in out:
        di, cw = cfg.mamba_d_inner, cfg.conv_width
        out["hymba"]["ssm"] = {
            "h": ((L, batch, di, cfg.ssm_state), f32),
            "conv": ((L, batch, cw - 1, di), torch.bfloat16)}
    return out


_KV_BF16_ONLY = {"audio": "_wdec_block", "hybrid": "_hymba_block"}


def _refuse_kv_tier(cfg: ArchConfig, tier: str):
    """The audio and hybrid families serve on the bf16 KV tier only. The
    reference's ``_wdec_block`` and ``_hymba_block`` hand
    ``attn_sublayer`` only the cache's ``k`` / ``v`` lanes, so under
    ``kv_fp8`` / ``kv_mor`` its fp8 and MoR branches never run: K/V are
    cast into the payload buffers with no scale and the scale and tag
    lanes are dropped from the returned cache."""
    block = _KV_BF16_ONLY.get(cfg.family)
    if block is not None:
        raise ValueError(
            f"{tier} is not supported for family {cfg.family!r} "
            f"({cfg.name}): repro.models.transformer.{block} passes only "
            "the k / v lanes to the self-attention, so the reference "
            "drops the scale and tag lanes of a quantized KV tier; serve "
            "it on the bf16 tier")


def init_cache(cfg: ArchConfig, batch: int, seq: int, kv_fp8: bool = False,
               kv_mor: bool = False, device="cuda"):
    dev = resolve_device(device)

    def zeros(spec):
        if isinstance(spec, dict):
            return {k: zeros(v) for k, v in spec.items()}
        shape, dt = spec
        return torch.zeros(shape, dtype=dt, device=dev)
    return zeros(cache_specs(cfg, batch, seq, kv_fp8, kv_mor))


def _is_quantized(w) -> bool:
    """A serving weight with its own product (``serve.quantized.QTensor``,
    ``ShardedQTensor``, a vocab-sharded embedding's tied head)."""
    return hasattr(w, "serve_dot")


def _layer(tree, l: int):
    """Layer ``l`` of a stacked params or cache tree (views; QTensors
    slice their lanes)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _layer(v, l)
        elif _is_quantized(v):
            out[k] = v.layer(l)
        else:
            out[k] = v[l]
    return out


def _wdec_block(p, x, tok, policy, cfg, mode, cache, cur_index,
                enc_out=None, **attn_kw):
    """Whisper decoder layer: causal self-attention without rope,
    cross-attention on the encoder output (in decode mode on the cached
    ``xk`` / ``xv``, with a zero stats row for 'xkv'), then the MLP."""
    xn = B.norm(p["ln1"], x, cfg)
    kv_cache = (None if cache is None else
                {"k": cache["k"], "v": cache["v"]})
    a, new_kv, st_a = B.attn_sublayer(p, xn, tok, policy, cfg, mode,
                                      kv_cache, cur_index, kind="causal",
                                      use_rope=False)
    x = x + a
    xq = B.norm(p["lnx"], x, cfg)
    bsz, S, _ = xq.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    q, st_xq = mor_dot(xq, p["xwq"], B._tok(tok, "xq"), policy)
    q = q.reshape(bsz, S, hq, hd)
    if mode == "decode":
        xk, xv = cache["xk"], cache["xv"]
        st_xkv = torch.zeros_like(st_xq)
    else:
        kvx, st_xkv = mor_dot(enc_out, p["xwkv"], B._tok(tok, "xkv"),
                              policy)
        xk, xv = torch.chunk(kvx, 2, dim=-1)
        xk = xk.reshape(bsz, -1, hkv, hd)
        xv = xv.reshape(bsz, -1, hkv, hd)
    xo = flash_attention(q, xk, xv, kind="full")
    xo = xo.reshape(bsz, S, hq * hd)
    xa, st_xo = mor_dot(xo, p["xwo"], B._tok(tok, "xproj"), policy)
    x = x + xa
    xn2 = B.norm(p["ln2"], x, cfg)
    m, st_m = B.mlp_sublayer(p["mlp"], xn2, tok, policy, cfg)
    x = x + m
    new_cache = None
    if new_kv is not None:
        new_cache = {**new_kv, "xk": xk.to(torch.bfloat16),
                     "xv": xv.to(torch.bfloat16)}
    return x, new_cache, {**st_a, "xq": st_xq, "xkv": st_xkv,
                          "xproj": st_xo, **st_m}


def _hymba_block(p, x, tok, policy, cfg, mode, cache, cur_index,
                 **attn_kw):
    """Hymba layer: sliding-window attention and the mamba mixer in
    parallel on the same normed input, both added to the residual, then
    the MLP. The cache's K/V lanes go to the attention, its ``ssm``
    state to the mixer."""
    xn = B.norm(p["ln1"], x, cfg)
    kv_cache = (None if cache is None else
                {"k": cache["k"], "v": cache["v"]})
    a, new_kv, st_a = B.attn_sublayer(p, xn, tok, policy, cfg, mode,
                                      kv_cache, cur_index, **attn_kw)
    s, new_ssm, st_s = R.mamba_mix(p["ssm"], xn, tok, policy, cfg, mode,
                                   None if cache is None else cache["ssm"])
    x = x + a + s
    xn2 = B.norm(p["ln2"], x, cfg)
    m, st_m = B.mlp_sublayer(p["mlp"], xn2, tok, policy, cfg)
    x = x + m
    new_cache = None if new_kv is None else {**new_kv, "ssm": new_ssm}
    return x, new_cache, {**st_a, **st_s, **st_m}


def _mlstm_block(p, x, tok, policy, cfg, mode, cache, cur_index,
                 **attn_kw):
    xn = B.norm(p["ln1"], x, cfg)
    y, new_cache, st = R.mlstm_mix(p, xn, tok, policy, cfg, mode, cache)
    return x + y, new_cache, st


def _slstm_block(p, x, tok, policy, cfg, mode, cache, cur_index,
                 **attn_kw):
    xn = B.norm(p["ln1"], x, cfg)
    y, new_cache, st = R.slstm_mix(p, xn, tok, policy, cfg, mode, cache)
    return x + y, new_cache, st


_BLOCK_FN = {"dense": B.dense_block, "moe": B.moe_block,
             "wdec": _wdec_block, "hymba": _hymba_block,
             "mlstm": _mlstm_block, "slstm": _slstm_block}


def _block_kw(t, attn_kw, enc_out):
    return dict(attn_kw, enc_out=enc_out) if t == "wdec" else attn_kw


def _layer_fn(t, p_l, x, tok_l, policy, cfg, attn_kw, enc_out):
    x, _, st = _BLOCK_FN[t](p_l, x, tok_l, policy, cfg, "train", None,
                            None, **_block_kw(t, attn_kw, enc_out))
    return x, st


def _train_layer(remat, *args):
    """One layer in train mode, under ``torch.utils.checkpoint``
    (non-reentrant) with ``remat``: (x, stats)."""
    if remat:
        return checkpoint(_layer_fn, *args, use_reentrant=False)
    return _layer_fn(*args)


def _stack_tree(trees):
    """Per-layer trees (cache lanes, stats rows) stacked over layers,
    leaf by leaf (an MoE layer's scalar aux_loss / dropped become
    (n_units,))."""
    if isinstance(trees[0], dict):
        return {k: _stack_tree([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _encode(cfg, policy, params, tokens, frames, dtype, remat):
    """The audio encoder: frames (cast to the embeddings' dtype) plus
    their sinusoidal positions through the dense encoder layers (train
    mode: bidirectional, no rope; remat per layer when asked, as the
    reference), then its final norm. Returns (enc_out, stats {'dense':
    per-layer rows})."""
    e = frames.to(dtype)
    e = e + sinusoidal_positions(e.shape[1], cfg.d_model,
                                 device=e.device)[None].to(e.dtype)
    kw = {"kind": "full", "use_rope": False}
    rows = []
    for l in range(cfg.enc_layers):
        p_l = _layer(params["enc"]["blocks"], l)
        tok_l = (None if tokens is None else
                 {k: v[l] for k, v in tokens["enc"].items()})
        e, st = _train_layer(remat, "dense", p_l, e, tok_l, policy, cfg, kw,
                             None)
        rows.append(st)
    return (B.norm(params["enc"]["final_norm"], e, cfg),
            {"dense": _stack_tree(rows)})


class HeadMatmul(torch.autograd.Function):
    """logits = x @ head with an f32 result: the reference's ``einsum(...,
    preferred_element_type=f32)`` of the unquantized head.

    Forward: on CUDA with bf16 operands, one bf16 tensor-core GEMM with
    an f32 output (``aten::mm.dtype``; each product of two bf16 values is
    exact in f32, so only the f32 summation order differs from an f32
    GEMM); otherwise (the CPU, which registers no ``mm.dtype`` kernel, or
    other dtypes) the f32 product of the operands cast to f32. Backward:
    the f32 GEMMs autograd runs through ``x.to(f32) @ head.to(f32)``
    (``dlogits`` is f32), cast back to the operands' dtypes; only the bf16
    operands are saved."""

    @staticmethod
    def forward(ctx, x, head):
        ctx.save_for_backward(x, head)
        x2 = x.reshape(-1, x.shape[-1])
        if x.is_cuda and x.dtype == head.dtype == torch.bfloat16:
            flags = torch.backends.cuda.matmul
            user = flags.allow_bf16_reduced_precision_reduction
            flags.allow_bf16_reduced_precision_reduction = False
            try:
                y = torch.mm(x2, head, out_dtype=torch.float32)
            finally:
                flags.allow_bf16_reduced_precision_reduction = user
        else:
            with ieee_f32_matmul():
                y = x2.to(torch.float32).mm(head.to(torch.float32))
        return y.reshape(*x.shape[:-1], head.shape[1])

    @staticmethod
    def backward(ctx, g):
        x, head = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        gx = gh = None
        with ieee_f32_matmul():
            hf = head.to(torch.float32)
            if ctx.needs_input_grad[0]:
                gx = g2.mm(hf.t()).reshape(x.shape).to(x.dtype)
            if ctx.needs_input_grad[1]:
                xf = x.reshape(-1, x.shape[-1]).to(torch.float32)
                # mm's backward for its second operand: a column-major
                # operand (a tied head, embed.T) gets a column-major grad.
                if hf.stride(0) == 1 and hf.stride(1) == hf.shape[0]:
                    gh = g2.t().mm(xf).t()
                else:
                    gh = xf.t().mm(g2)
                gh = gh.to(head.dtype)
        return gx, gh


def forward(cfg: ArchConfig, policy: MoRDotPolicy, params, batch, *,
            mode: str = "decode", cache=None, cur_index=None, tokens=None,
            remat: bool = True):
    """Returns (logits f32 (B, S, Vp), cache, stats).

    Train mode: ``batch['tokens']`` (B, S), causal over the whole
    sequence, with ``tokens`` from :func:`make_tokens` (None when no
    backward stats are wanted). With ``remat`` each layer runs under
    ``torch.utils.checkpoint`` (non-reentrant), as the reference's
    ``jax.checkpoint`` of the layer body: the backward recomputes the
    layer's forward, so its quantization events run twice per step, and
    the forward stats returned are those of the first run.

    Prefill mode: ``batch['tokens']`` (B, S), causal over the whole
    sequence (hymba: sliding-window) with no cache input; the returned
    cache is every layer's bf16 K/V, ``{type: {"k", "v": (n_units, B, P,
    Hkv, dh)}}`` (a ``wdec`` layer's also ``xk`` / ``xv``), and a
    recurrent layer's final state (hymba's under ``ssm``).

    Decode mode: ``batch['token']`` (B, S) against ``cache`` -- S == 1
    for a decode step, S > 1 for a prefill chunk -- with ``cur_index``
    (scalar or (B,)) the position of each row's last incoming token.
    The cache is updated in place and returned: the K/V lanes at the
    incoming positions, a recurrent layer's state wholesale (the
    recurrent mixers take S == 1).

    Frontends (train and prefill): the vlm family takes
    ``batch['patches']`` (B, img_tokens, d) before the tokens (P = B's
    img_tokens + S positions, the logits too; the prefix attends
    bidirectionally), the audio family ``batch['frames']`` (B, enc_seq,
    d) for the encoder. Stats: ``{"blocks": {type: ...}}``, and for the
    audio family ``"enc": {"dense": ...}`` (a decode call runs no
    encoder and reports none).
    """
    types = _unit_types(cfg)
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode {mode!r}")
    if mode == "decode":
        for t in ("wdec", "hymba"):
            if "k_scale" in cache.get(t, {}):
                _refuse_kv_tier(cfg, "kv_mor" if "k_tags" in cache[t]
                                else "kv_fp8")
    ids = batch["token"] if mode == "decode" else batch["tokens"]
    embed = params["embed"]
    # A rank's vocab-sharded embedding (serve.quantized.ShardedEmbed)
    # looks its rows up across the ranks.
    x = embed.lookup(ids) if hasattr(embed, "lookup") else embed[ids]
    if cfg.family in ("dense", "vlm") and cfg.tie_embed:
        x = x * torch.tensor(cfg.d_model**0.5, dtype=x.dtype)  # gemma

    attn_kw: Dict[str, Any] = {"kind": "causal"}
    enc_out = None
    stats: Dict[str, Any] = {}
    if cfg.family == "vlm" and mode != "decode":
        x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
        attn_kw = {"kind": "prefix", "prefix_len": cfg.img_tokens}
    if cfg.family == "hybrid" and cfg.window:
        # Hymba: sliding-window attention beside the global SSM state.
        attn_kw = {"kind": "sliding", "window": cfg.window}
    if cfg.family == "audio":
        if mode == "decode":
            # The S incoming tokens sit at cur - (S-1) .. cur of each row.
            S = x.shape[1]
            cur = torch.as_tensor(cur_index, dtype=torch.int64,
                                  device=x.device).reshape(-1)
            posn = cur[:, None] - (S - 1) + torch.arange(S, device=x.device)
            pos = sinusoidal_at(posn, cfg.d_model)  # (b, S, d)
        else:
            pos = sinusoidal_positions(x.shape[1], cfg.d_model,
                                       device=x.device)[None]
        x = x + pos.to(x.dtype)
        if mode != "decode":
            enc_out, stats["enc"] = _encode(cfg, policy, params, tokens,
                                            batch["frames"], x.dtype, remat)

    rows = {t: [] for t in types}
    kvs = {t: [] for t in types}
    for l in range(cfg.n_units):
        for t in types:
            p_l = _layer(params["blocks"][t], l)
            tok_l = (None if tokens is None else
                     {k: v[l] for k, v in tokens["blocks"][t].items()})
            if mode == "train":
                x, st = _train_layer(remat, t, p_l, x, tok_l, policy, cfg,
                                     attn_kw, enc_out)
            else:
                c_l = None if mode == "prefill" else _layer(cache[t], l)
                x, kv, st = _BLOCK_FN[t](p_l, x, tok_l, policy, cfg, mode,
                                         c_l, cur_index,
                                         **_block_kw(t, attn_kw, enc_out))
                kvs[t].append(kv)
            rows[t].append(st)
    if mode == "prefill":
        cache = {t: _stack_tree(kvs[t]) for t in types}
    stats["blocks"] = {t: _stack_tree(rows[t]) for t in types}

    x = B.norm(params["final_norm"], x, cfg)
    if not cfg.tie_embed:
        head = params["lm_head"]
    else:
        head = embed.tied_head() if hasattr(embed, "lookup") else embed.T
    bsz, seq = x.shape[0], x.shape[1]
    if _is_quantized(head):
        logits = head.serve_dot(
            x.reshape(-1, x.shape[-1]), out_dtype=torch.float32,
            backend=policy.weight.backend,
        ).reshape(bsz, seq, head.shape[1])
    else:
        logits = HeadMatmul.apply(x, head)
    Vp = logits.shape[-1]
    col = torch.arange(Vp, device=logits.device)
    logits = torch.where(col < cfg.vocab, logits, -1e30)
    return logits, (None if mode == "train" else cache), stats
