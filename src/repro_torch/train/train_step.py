"""The training step: loss -> grads (with optional microbatching) ->
gradient compression -> AdamW update, with the MoR stats as metrics (port
of ``repro.train.train_step``).

Gradient compression (``optim.compress``), packed Adam moments
(``optim.moments``) and the skip-step guard (``robust.guard``) are
ported, and so is the chaos harness's gradient hook (``grad_fault``).
The step updates the optimizer state in place (``optim.adamw``).

``TrainConfig.mor_mesh_axes``: the step as each rank of a data-parallel
mesh runs it on its own shard of the batch (the reference's step inside
``shard_map``): every MoR statistic, the gradient compression's too, is
reduced over those axes (``core.collectives``, bound by ``use_mesh``),
while the loss, the gradients and the update stay the rank's own. Like
the reference's step, it reduces no gradient.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import ieee_f32_matmul
from repro_torch.core.formats import true_divide
from repro_torch.core.mor import (STAT_DECISION, STAT_FALLBACK_COUNT,
                                  STAT_FRAC_BF16, STAT_GUARD_FLAGS,
                                  STAT_PAYLOAD_BPE, STAT_REL_ERR,
                                  STATS_WIDTH)
from repro_torch.core.policy import MoRDotPolicy, MoRPolicy, with_mesh_axes
from repro_torch.models.api import make_loss_fn, make_tokens
from repro_torch.optim.adamw import (AdamWConfig, OptState, adamw_update,
                                     global_norm, tree_leaves, tree_map)
from repro_torch.optim.compress import DEFAULT_GRAD_POLICY, compress_grads
from repro_torch.optim.moments import MomentPolicy
from repro_torch.robust.guard import GuardPolicy, tree_select

__all__ = ["TrainConfig", "make_train_step", "summarize_mor_stats"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = AdamWConfig()
    # Microbatching: split the global batch into n accumulation steps.
    grad_accum: int = 1
    remat: bool = True
    # Gradient compression (optim.compress): per-tensor E4M3 ('fp8' /
    # 'fp8_ef') or per-block MoR selection ('mor' / 'mor_ef') under
    # ``grad_policy``. The '*_ef' modes keep an error-feedback residual in
    # OptState.ef: make the state with ``init_opt_state(params,
    # ef=True)``.
    compress_grads: str = "none"  # 'none'|'fp8'|'fp8_ef'|'mor'|'mor_ef'
    grad_policy: MoRPolicy = DEFAULT_GRAD_POLICY
    # Adam moments stored as packed MoR payloads (optim.moments); None
    # keeps them dense f32. Must match the MomentPolicy the state was
    # made with.
    moments: Optional[MomentPolicy] = None
    # Weight of the MoE load-balance loss (models.api.make_loss_fn; the
    # dense family's aux loss is 0).
    aux_coef: float = 0.01
    # ZeRO-2 gradient sharding for GSPMD: accepted and ignored (one card).
    zero2_grads: bool = True
    # The batch-sharded mesh axes of a data-parallel trainer whose ranks
    # each run the step on their shard (core.collectives.use_mesh).
    mor_mesh_axes: Tuple[str, ...] = ()
    # Numerics guard rails (robust.guard): with a GuardPolicy a nonfinite
    # global grad norm drops the update, and the step keeps the EF
    # residuals of the dropped step.
    guard: Optional[GuardPolicy] = None

    def __post_init__(self):
        object.__setattr__(self, "mor_mesh_axes", tuple(self.mor_mesh_axes))
        if self.grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got "
                             f"{self.grad_accum}")


def _stats_rows(tree):
    """Every STATS_WIDTH row of a stats tree, concatenated (None when it
    has none)."""
    leaves = [l.reshape(-1, l.shape[-1]) for l in tree_leaves(tree)
              if isinstance(l, torch.Tensor) and l.ndim >= 1
              and l.shape[-1] == STATS_WIDTH]
    return torch.cat(leaves) if leaves else None


def summarize_mor_stats(fwd_stats, bwd_stats,
                        opt_stats=None) -> Dict[str, torch.Tensor]:
    """Reduce the per-layer / per-event stats trees to scalar metrics.

    Disabled events (decision == -1) are left out of the fractions and
    errors (with no enabled event every metric is 0). ``opt_stats``
    holds the optimizer-event rows (gradient compression and packed
    moment encodes), summarized as ``opt_frac_bf16`` / ``opt_rel_err``
    and ``opt_payload_bpe`` (the mean of stats lane [11]). The guard
    counters count every row: ``guard_flag_events`` rows with a guard
    flag set, ``guard_fallback_blocks`` the nonfinite-block fallbacks."""

    def frac(cat, idx):
        if cat is None:
            return torch.zeros((), dtype=torch.float32)
        enabled = cat[:, STAT_DECISION] >= 0.0
        n = torch.clamp_min(enabled.to(torch.float32).sum(), 1.0)
        return torch.where(enabled, cat[:, idx], 0.0).sum() / n

    out = {}
    guard_events = torch.zeros((), dtype=torch.float32)
    fallback_blocks = torch.zeros((), dtype=torch.float32)
    for name, tree in (("fwd", fwd_stats), ("bwd", bwd_stats),
                       ("opt", opt_stats)):
        if tree is None:
            continue
        cat = _stats_rows(tree)
        out[f"{name}_frac_bf16"] = frac(cat, STAT_FRAC_BF16)
        out[f"{name}_rel_err"] = frac(cat, STAT_REL_ERR)
        if name == "opt":
            out["opt_payload_bpe"] = frac(cat, STAT_PAYLOAD_BPE)
        if cat is not None:
            guard_events = guard_events.to(cat.device) + (
                cat[:, STAT_GUARD_FLAGS] > 0.0).to(torch.float32).sum()
            fallback_blocks = fallback_blocks.to(cat.device) + \
                cat[:, STAT_FALLBACK_COUNT].sum()
    out["guard_flag_events"] = guard_events
    out["guard_fallback_blocks"] = fallback_blocks
    return out


def _split(batch, n: int, i: int):
    return {k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]
            for k, v in batch.items()}


def _tree_mean(trees):
    if isinstance(trees[0], dict):
        return {k: _tree_mean([t[k] for t in trees]) for k in trees[0]}
    return torch.mean(torch.stack(trees), dim=0)


def make_train_step(cfg: ArchConfig, policy: MoRDotPolicy,
                    tcfg: TrainConfig, grad_fault=None):
    """Returns train_step(params, opt_state, batch) -> (params,
    opt_state, metrics). ``batch`` holds 'tokens' and 'labels' (B, S)
    integer tensors on the parameters' device; the step leaves params
    and batch untouched, returns new parameters and updates the
    optimizer state in place (``optim.adamw``).

    ``grad_fault``: an optional ``hook(grads, batch) -> grads`` applied
    to the (accumulated) parameter gradients before compression and the
    update -- the chaos harness's injection point
    (``robust.faults.make_grad_fault`` builds hooks gated on a
    ``batch['inject']`` flag, so one step function serves clean and
    injected steps). It must be the identity on clean batches."""
    grad_policy = tcfg.grad_policy
    if tcfg.mor_mesh_axes:
        policy = with_mesh_axes(policy, tcfg.mor_mesh_axes)
        # Gradient compression quantizes global gradients: its
        # statistics are reduced like every other event's.
        grad_policy = grad_policy.replace(mesh_axes=tcfg.mor_mesh_axes)
    loss_fn = make_loss_fn(cfg, policy, remat=tcfg.remat,
                           aux_coef=tcfg.aux_coef)

    def single_micro(params, batch):
        leaves = tree_leaves(params)
        dev = leaves[0].device
        p = tree_map(lambda t: t.detach().requires_grad_(True), params)
        tokens = make_tokens(cfg, device=dev)
        total, aux = loss_fn(p, tokens, batch)
        p_leaves, t_leaves = tree_leaves(p), tree_leaves(tokens)
        # The backward's f32 matmuls (attention, head) in full f32 too.
        with ieee_f32_matmul():
            grads = torch.autograd.grad(total, p_leaves + t_leaves)
        g_params = _unflatten(p, grads[:len(p_leaves)])
        g_tokens = _unflatten(tokens, grads[len(p_leaves):])
        aux = {k: (v.detach() if isinstance(v, torch.Tensor) else
                   tree_map(lambda t: t.detach(), v))
               for k, v in aux.items()}
        return total.detach(), aux, g_params, g_tokens

    def train_step(params, opt_state: OptState, batch):
        n = tcfg.grad_accum
        if n > 1:
            g_acc = tree_map(lambda t: torch.zeros(
                t.shape, dtype=torch.float32, device=t.device), params)
            total = torch.zeros((), dtype=torch.float32,
                                device=tree_leaves(params)[0].device)
            auxs, toks = [], []
            for i in range(n):
                t_i, aux, g_params, g_tokens = single_micro(
                    params, _split(batch, n, i))
                g_acc = tree_map(
                    lambda a, g: a + true_divide(g.to(torch.float32), n),
                    g_acc, g_params)
                total = total + true_divide(t_i, n)
                auxs.append(aux)
                toks.append(g_tokens)
            # Stats and aux are per-microbatch means: the reported
            # metrics do not depend on the grad_accum split.
            aux, g_tokens, g_params = _tree_mean(auxs), _tree_mean(toks), \
                g_acc
        else:
            total, aux, g_params, g_tokens = single_micro(params, batch)
        if grad_fault is not None:
            g_params = grad_fault(g_params, batch)

        grad_stats, new_ef = None, opt_state.ef
        if tcfg.compress_grads != "none":
            new_ef, grad_stats = _compress_leafwise(
                g_params, opt_state.ef, tcfg.compress_grads, grad_policy)
        new_params, new_opt, opt_metrics = adamw_update(
            tcfg.optimizer, g_params, opt_state, moments=tcfg.moments,
            guard=tcfg.guard)
        del g_params
        if "guard_skip" in opt_metrics and new_ef is not None:
            # A dropped update keeps the old residuals: keeping the new
            # ones would make the next step absorb this step's
            # quantization error twice.
            new_ef = tree_select(opt_metrics["guard_skip"] < 0.5, new_ef,
                                 opt_state.ef)
        new_opt = new_opt._replace(ef=new_ef)
        # Optimizer-event rows: the gradient compression's and the packed
        # moment encodes' that adamw_update reports.
        opt_rows = {"grad": grad_stats,
                    "m": opt_metrics.pop("moment_stats_m", None),
                    "v": opt_metrics.pop("moment_stats_v", None)}
        opt_rows = {k: r for k, r in opt_rows.items() if r is not None}
        metrics = {"loss": aux["loss"], "total_loss": total,
                   "aux_loss": aux["aux_loss"], **opt_metrics,
                   **summarize_mor_stats(aux.get("mor_fwd"), g_tokens,
                                         opt_rows or None)}
        if new_ef is not None:
            metrics["ef_norm"] = global_norm(new_ef)
        return new_params, new_opt, metrics

    return train_step


def _compress_leafwise(grads, ef, mode, policy):
    """``compress_grads`` one leaf at a time, each raw gradient replaced
    in ``grads`` (the step's own tree) by its round trip as soon as it is
    made, so the raw and the compressed tree never coexist. Returns (the
    new residual tree, or ``ef`` itself for the modes without one; the
    stats tree, or None for the legacy modes)."""
    new_ef, stats = {}, {}
    for k in sorted(grads):
        e = None if ef is None else {k: ef[k]}
        if isinstance(grads[k], dict):
            new_ef[k], stats[k] = _compress_leafwise(
                grads[k], None if ef is None else ef[k], mode, policy)
            continue
        g, e, st = compress_grads({k: grads[k]}, mode, e, policy)
        grads[k] = g[k]
        new_ef[k] = None if e is None else e[k]
        stats[k] = None if st is None else st[k]
    return (new_ef if mode.endswith("_ef") else ef,
            stats if mode.startswith("mor") else None)


def _unflatten(tree, leaves):
    """The tree of ``tree``'s structure holding ``leaves`` (in
    tree_leaves order)."""
    it = iter(leaves)

    def rec(t):
        if isinstance(t, dict):
            return {k: rec(t[k]) for k in sorted(t)}
        return next(it)

    return rec(tree)
