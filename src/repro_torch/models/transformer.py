"""Model assembly for the dense and MoE decoder families (port of the
train, prefill and decode paths of ``repro.models.transformer``).

Parameters are nested dicts with the reference's key paths
(``blocks/dense/wqkv``, ``blocks/dense/mlp/wi``, ``blocks/moe/moe/w1``,
``blocks/moe/moe/router``, ``lm_head``, ``embed``,
``blocks/dense/ln1/scale``, ...) keyed by the unit's layer types;
per-layer leaves are stacked on a leading layer axis (an MoE layer's
experts on the next one). Embeddings are padded to a multiple of 128
rows and the padded logit columns are masked to -1e30. The decode cache
has the reference's three tiers: bf16 K/V, fp8 (``kv_fp8``) and MoR
(``kv_mor``); an MoE layer's KV lanes are a dense layer's.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import ieee_f32_matmul, resolve_device
from repro_torch.core.linear import N_BWD_EVENTS
from repro_torch.core.mor import STATS_WIDTH
from repro_torch.core.policy import MoRDotPolicy
from repro_torch.kernels import ops as kops

from . import blocks as B

__all__ = ["init_params", "make_tokens", "cache_specs", "init_cache",
           "forward", "padded_vocab", "resolve_device"]

# The reference modules the families not ported yet wait for.
_UNPORTED = {
    "audio": "the whisper encoder and decoder blocks of "
             "repro.models.transformer (frames frontend, cross-attention)",
    "vlm": "the patch-prefix frontend of repro.models.transformer "
           "(prefix attention)",
    "ssm": "repro.models.recurrent (mlstm / slstm)",
    "hybrid": "repro.models.recurrent (the hymba mamba mixer)",
}
_BLOCK_FN = {"dense": B.dense_block, "moe": B.moe_block}


def padded_vocab(cfg: ArchConfig) -> int:
    return -(-cfg.vocab // 128) * 128


def _unit_types(cfg: ArchConfig) -> Tuple[str, ...]:
    """The layer types of one unit; a family that is not ported raises,
    naming the reference code it waits for."""
    if cfg.family in _UNPORTED:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: it needs "
            f"{_UNPORTED[cfg.family]}")
    for t in cfg.unit:
        if t not in _BLOCK_FN:
            raise NotImplementedError(
                f"layer type {t!r} is not ported yet (repro.models."
                "recurrent)")
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
    L, d, f = cfg.n_units, cfg.d_model, cfg.d_ff
    hq, hkv, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    Vp = padded_vocab(cfg)
    depth_std = 0.02 / max(1.0, (2 * cfg.n_layers) ** 0.5)

    def normal(shape, std, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device=dev,
                            dtype=torch.float32) * std).to(dtype)

    def stacked(shape, std, dtype=torch.bfloat16):
        # One layer at a time: the f32 draw of a whole stack would not
        # fit beside the model at full width.
        out = torch.empty((L, *shape), dtype=dtype, device=dev)
        for l in range(L):
            out[l] = normal(shape, std, dtype)
        return out

    def layer(t):
        p = {"wqkv": stacked((d, (hq + 2 * hkv) * hd), 0.02),
             "wo": stacked((hq * hd, d), depth_std)}
        if t == "moe":
            E = cfg.n_experts
            p["moe"] = {"router": stacked((d, E), 0.02, torch.float32),
                        "w1": stacked((E, d, _ffin(cfg, f)), 0.02),
                        "w2": stacked((E, f, d), depth_std)}
        else:
            p["mlp"] = {"wi": stacked((d, _ffin(cfg, f)), 0.02),
                        "wo": stacked((f, d), depth_std)}
        p["ln1"] = {"scale": torch.zeros((L, d), device=dev)}
        p["ln2"] = {"scale": torch.zeros((L, d), device=dev)}
        return p

    embed = normal((Vp, d), 0.02)
    embed[cfg.vocab:] = 0
    params: Dict[str, Any] = {
        "embed": embed,
        "final_norm": {"scale": torch.zeros(d, device=dev)},
    }
    if not cfg.tie_embed:
        params["lm_head"] = normal((d, Vp), 0.02)
    params["blocks"] = {t: layer(t) for t in types}
    return params


def _layer_tokens(t: str, cfg: ArchConfig):
    """{GEMM name: token shape} of one layer of type ``t``."""
    one = (N_BWD_EVENTS, STATS_WIDTH)
    if t == "moe":
        per_expert = (cfg.n_experts, *one)
        return {"qkv": one, "proj": one, "w1": per_expert, "w2": per_expert}
    return {n: one for n in ("qkv", "proj", "fc1", "fc2")}


def make_tokens(cfg: ArchConfig, device="cuda"):
    """Zero bwd-stat tokens, stacked over layers: one (N_BWD_EVENTS,
    STATS_WIDTH) token per GEMM of a layer, one per expert for an MoE
    layer's 'w1' / 'w2'; each requires grad, and its gradient carries the
    backward quantization stats out of the train step."""
    types = _unit_types(cfg)
    dev = resolve_device(device)
    return {"blocks": {t: {
        n: torch.zeros((cfg.n_units, *shape), dtype=torch.float32,
                       device=dev, requires_grad=True)
        for n, shape in _layer_tokens(t, cfg).items()} for t in types}}


def cache_specs(cfg: ArchConfig, batch: int, seq: int,
                kv_fp8: bool = False, kv_mor: bool = False):
    """{unit type: {leaf: (shape, dtype)}} of the decode cache, stacked
    over layers: bf16 K/V; with ``kv_fp8`` float8_e4m3fn K/V payloads and
    per-(position, head) f32 scales; with ``kv_mor`` uint8 K/V payloads,
    uint8 tags and f32 GAM scales (the reference's lanes and dtypes). The
    dense and MoE layer types hold the same lanes."""
    types = _unit_types(cfg)
    if kv_fp8 and kv_mor:
        raise ValueError("kv_fp8 and kv_mor are mutually exclusive")
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
    return {t: dict(leaves) for t in types}


def init_cache(cfg: ArchConfig, batch: int, seq: int, kv_fp8: bool = False,
               kv_mor: bool = False, device="cuda"):
    dev = resolve_device(device)
    return {t: {k: torch.zeros(s, dtype=dt, device=dev)
                for k, (s, dt) in leaves.items()}
            for t, leaves in cache_specs(cfg, batch, seq, kv_fp8,
                                         kv_mor).items()}


def _is_quantized(w) -> bool:
    """A real-quantized weight (``serve.quantized.QTensor``)."""
    return hasattr(w, "as_mixed_operand")


def _layer(tree, l: int):
    """Layer ``l`` of a stacked params tree (QTensors slice their lanes)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _layer(v, l)
        elif _is_quantized(v):
            out[k] = v.layer(l)
        else:
            out[k] = v[l]
    return out


def _train_layer(t, p_l, x, tok_l, policy, cfg):
    x, _, st = _BLOCK_FN[t](p_l, x, tok_l, policy, cfg, "train", None,
                            None, kind="causal")
    return x, st


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
    sequence with no cache input; the returned cache is every layer's
    bf16 K/V, ``{type: {"k", "v": (n_units, B, S, Hkv, dh)}}``.

    Decode mode: ``batch['token']`` (B, S) against ``cache`` -- S == 1
    for a decode step, S > 1 for a prefill chunk -- with ``cur_index``
    (scalar or (B,)) the position of each row's last incoming token.
    The cache is updated in place and returned.
    """
    types = _unit_types(cfg)
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode {mode!r}")
    ids = batch["token"] if mode == "decode" else batch["tokens"]
    x = params["embed"][ids]
    if cfg.family in ("dense", "vlm") and cfg.tie_embed:
        x = x * torch.tensor(cfg.d_model**0.5, dtype=x.dtype)  # gemma

    rows = {t: [] for t in types}
    kvs = {t: [] for t in types}
    for l in range(cfg.n_units):
        for t in types:
            p_l = _layer(params["blocks"][t], l)
            tok_l = (None if tokens is None else
                     {k: v[l] for k, v in tokens["blocks"][t].items()})
            if mode == "train":
                if remat:
                    x, st = checkpoint(_train_layer, t, p_l, x, tok_l,
                                       policy, cfg, use_reentrant=False)
                else:
                    x, st = _train_layer(t, p_l, x, tok_l, policy, cfg)
            elif mode == "prefill":
                x, kv, st = _BLOCK_FN[t](p_l, x, tok_l, policy, cfg, mode,
                                         None, None, kind="causal")
                kvs[t].append(kv)
            else:
                c_l = {k: v[l] for k, v in cache[t].items()}
                x, _, st = _BLOCK_FN[t](p_l, x, tok_l, policy, cfg, mode,
                                        c_l, cur_index, kind="causal")
            rows[t].append(st)
    if mode == "prefill":
        cache = {t: {k: torch.stack([kv[k] for kv in kvs[t]])
                     for k in ("k", "v")} for t in types}
    # Every stats leaf stacked over layers (an MoE layer's scalar
    # aux_loss / dropped become (n_units,)).
    stats = {"blocks": {t: {k: torch.stack([r[k] for r in rows[t]])
                            for k in rows[t][0]} for t in types}}

    x = B.norm(params["final_norm"], x, cfg)
    head = params["embed"].T if cfg.tie_embed else params["lm_head"]
    bsz, seq = x.shape[0], x.shape[1]
    if _is_quantized(head):
        logits = kops.mixed_dot(
            x.reshape(-1, x.shape[-1]), head.as_mixed_operand(),
            out_dtype=torch.float32, backend=policy.weight.backend,
        ).reshape(bsz, seq, head.shape[1])
    else:
        logits = HeadMatmul.apply(x, head)
    Vp = logits.shape[-1]
    col = torch.arange(Vp, device=logits.device)
    logits = torch.where(col < cfg.vocab, logits, -1e30)
    return logits, (None if mode == "train" else cache), stats
