"""AdamW with f32 master weights and moments (port of the dense path of
``repro.optim.adamw``).

Model parameters live in bf16; the optimizer state holds an f32 master
copy and the two Adam moments. The update runs on the master weights,
with global-norm clipping and a cosine schedule, and re-casts every
parameter to bf16, as the reference does. It is functional like the
reference (new tensors, the old state untouched) but walks the tree one
leaf at a time, so its f32 temporaries are one leaf's size.

Packed moments (``moments=``), the skip-step guard (``guard=``) and the
gradient-compression residual (``OptState.ef``) are not ported yet; the
first two raise.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.core.formats import true_divide

__all__ = ["AdamWConfig", "OptState", "init_opt_state", "adamw_update",
           "cosine_lr", "global_norm", "tree_leaves", "tree_map"]


def tree_leaves(tree):
    """Leaves of a nested dict in sorted key order (``jax.tree.leaves``
    order, which the global norm's sum follows)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    final_lr: float = 3e-5
    warmup_steps: int = 100
    total_steps: int = 10000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class OptState(NamedTuple):
    master: Any  # f32 master weights (a tree like the params)
    m: Any  # f32 first moments
    v: Any  # f32 second moments
    step: torch.Tensor  # () int32


def init_opt_state(params) -> OptState:
    """Fresh optimizer state: f32 master copies, zero moments, step 0."""
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else "cpu"

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return OptState(
        master=tree_map(lambda p: p.detach().to(torch.float32).clone(),
                        params),
        m=tree_map(zeros, params),
        v=tree_map(zeros, params),
        step=torch.zeros((), dtype=torch.int32, device=dev),
    )


def cosine_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up to ``peak_lr``, then cosine decay to ``final_lr``."""
    step = step.to(torch.float32)
    warm = true_divide(cfg.peak_lr * step, float(max(cfg.warmup_steps, 1)))
    prog = torch.clamp(
        true_divide(step - cfg.warmup_steps,
                    float(max(cfg.total_steps - cfg.warmup_steps, 1))),
        0.0, 1.0)
    cos = cfg.final_lr + 0.5 * (cfg.peak_lr - cfg.final_lr) * (
        1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in key order) of each leaf's f32 sum
    of squares."""
    sums = [torch.sum(torch.square(x.to(torch.float32)))
            for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def adamw_update(cfg: AdamWConfig, grads, opt_state: OptState, *,
                 decay_mask=None, moments=None,
                 guard=None) -> Tuple[Any, OptState, dict]:
    """Returns (new bf16 params, new opt state, metrics {'lr',
    'grad_norm'}). ``decay_mask`` is a tree like the params whose leaves
    (0/1 floats, or tensors that broadcast against the leaf) multiply
    each leaf's weight decay; by default every leaf of two or more
    dimensions decays (the reference's default mask: the layer-stacked
    norm scales decay too)."""
    if moments is not None:
        raise NotImplementedError(
            "packed Adam moments are not ported yet (ROADMAP Queue 1)")
    if guard is not None:
        raise NotImplementedError(
            "the skip-step guard is not ported yet (ROADMAP Queue 1)")
    step = opt_state.step + 1
    lr = cosine_lr(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp_max(
        true_divide(cfg.clip_norm, torch.clamp_min(gnorm, 1e-9)), 1.0)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    c1 = 1.0 - torch.pow(b1, stepf)
    c2 = 1.0 - torch.pow(b2, stepf)
    if decay_mask is None:
        decay_mask = tree_map(lambda p: 1.0 if p.ndim >= 2 else 0.0,
                              opt_state.master)

    def upd(master, m, v, g, wd):
        g = g.to(torch.float32) * scale
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        delta = (m / c1) / (torch.sqrt(v / c2) + cfg.eps) \
            + cfg.weight_decay * wd * master
        return master - lr * delta, m, v

    def walk(master, m, v, g, wd):
        """(new master, m, v) trees, one leaf at a time."""
        if not isinstance(master, dict):
            return upd(master, m, v, g, wd)
        out = {k: walk(master[k], m[k], v[k], g[k], wd[k]) for k in master}
        return tuple({k: o[i] for k, o in out.items()} for i in range(3))

    new_master, new_m, new_v = walk(opt_state.master, opt_state.m,
                                    opt_state.v, grads, decay_mask)
    new_params = tree_map(lambda p: p.to(torch.bfloat16), new_master)
    state = OptState(new_master, new_m, new_v, step)
    return new_params, state, {"lr": lr, "grad_norm": gnorm}
