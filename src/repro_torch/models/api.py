"""Public model API (port of ``repro.models.api``): the loss of the train
step and the prefill and decode functions of the serving engine. MoR
statistics leave the loss as ``aux['mor_fwd']`` (the forward stats
tree); the backward stats are the gradients of the tokens from
:func:`make_tokens`.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.policy import MoRDotPolicy

from . import transformer as T

__all__ = ["cross_entropy", "make_loss_fn", "make_prefill_fn",
           "make_decode_fn", "init_params", "make_tokens", "cache_specs",
           "init_cache"]

init_params = T.init_params
make_tokens = T.make_tokens
cache_specs = T.cache_specs
init_cache = T.init_cache


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token cross-entropy; logits (B, S, V) f32, labels (B, S)."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].to(torch.int64))[..., 0]
    nll = lse - gold
    if mask is not None:
        mask = mask.to(torch.float32)
        return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return torch.mean(nll)


def _aux_leaves(tree, path: str = ""):
    for k in sorted(tree):
        v, name = tree[k], f"{path}/{k}"
        if isinstance(v, dict):
            yield from _aux_leaves(v, name)
        elif "aux_loss" in name:
            yield v


def _collect_aux_losses(stats, device) -> torch.Tensor:
    """The sum of every stats leaf whose key path holds ``aux_loss`` (the
    MoE load-balance terms), in the reference's sorted key order; 0 for
    a tree with none (the dense family)."""
    total = torch.zeros((), dtype=torch.float32, device=device)
    for leaf in _aux_leaves(stats):
        total = total + torch.sum(leaf)
    return total


def make_loss_fn(cfg: ArchConfig, policy: MoRDotPolicy, *,
                 remat: bool = True, aux_coef: float = 0.01):
    """loss_fn(params, tokens, batch) -> (total loss, aux). ``tokens``
    are the zero bwd-stat tokens from :func:`make_tokens`; differentiate
    with respect to them to read the backward quantization stats. The
    total is ``loss + aux_coef * aux_loss`` as in the reference, where
    ``aux_loss`` sums the MoE layers' load-balance terms (0 for the dense
    family). The vlm family's labels cover the text positions only: the
    first ``img_tokens`` logits (the patch prefix) are dropped."""

    def loss_fn(params, tokens, batch):
        logits, _, stats = T.forward(cfg, policy, params, batch,
                                     mode="train", tokens=tokens,
                                     remat=remat)
        if cfg.family == "vlm":
            logits = logits[:, cfg.img_tokens:]
        loss = cross_entropy(logits, batch["labels"])
        aux_loss = _collect_aux_losses(stats, loss.device)
        return loss + aux_coef * aux_loss, {
            "loss": loss, "aux_loss": aux_loss, "mor_fwd": stats}

    return loss_fn


def make_prefill_fn(cfg: ArchConfig, policy: MoRDotPolicy):
    """prefill_fn(params, batch) -> (logits[:, -1:], cache, stats): one
    causal pass over ``batch['tokens']`` (B, S) with no cache input (and
    the frontend's ``patches`` / ``frames``). The logits are computed in
    full, as in the reference, and the last position's returned;
    ``cache`` is every layer's bf16 K/V (``{type: {"k", "v": (n_units,
    B, P, Hkv, dh)}}``, P = S, or img_tokens + S for the vlm family;
    whisper's ``wdec`` layers add the cross-attention's ``xk`` / ``xv``
    (n_units, B, enc_seq, Hkv, dh); a recurrent layer its final state,
    hymba's under ``ssm``), ready for ``PagedKVPool.splice``
    or a decode cache. The reference's stats-token argument has no
    counterpart (no backward in serving)."""

    def prefill_fn(params, batch):
        logits, cache, stats = T.forward(cfg, policy, params, batch,
                                         mode="prefill", remat=False)
        return logits[:, -1:], cache, stats

    return prefill_fn


def make_decode_fn(cfg: ArchConfig, policy: MoRDotPolicy):
    """decode_fn(params, cache, token, cur_index) -> (logits, cache,
    stats). ``token`` is (B, S): S == 1 for a decode step, S > 1 for a
    prefill chunk written into the cache; ``cur_index`` is the position
    of the last incoming token, scalar or per row (B,). The reference's
    stats-token argument has no counterpart (no backward in serving)."""

    def decode_fn(params, cache, token, cur_index):
        return T.forward(cfg, policy, params, {"token": token},
                         mode="decode", cache=cache, cur_index=cur_index)

    return decode_fn
