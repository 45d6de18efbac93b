"""AdamW with f32 master weights (port of ``repro.optim.adamw``).

Model parameters live in bf16; the optimizer state holds an f32 master
copy and the two Adam moments. The update runs on the master weights,
with global-norm clipping and a cosine schedule, and re-casts every
parameter to bf16, as the reference does.

With a :class:`~repro_torch.optim.moments.MomentPolicy` the moments are
stored as packed MoR payloads (``PackedMoment`` leaves): each is decoded
to f32, updated and re-encoded within the walk of its leaf. With a
:class:`~repro_torch.robust.GuardPolicy` a nonfinite global grad norm
drops the whole update. ``OptState.ef`` carries the gradient
compression's error-feedback residual (``optim.compress``).

Memory: the reference is functional (a new state beside the old). The
port walks the tree one leaf at a time and updates the state in place:
each leaf's master weights and dense moments are written where they
were, and its new packed moments replace the old ones in the state's
dicts, so the temporaries stay one leaf's size (a second copy of the
state would not fit the card at nemotron3-8b's 256k vocabulary). The
``opt_state`` passed in is therefore changed; the returned state shares
its dicts and holds the new step. Whether the update is kept is decided
from the grad norm before the walk, and a dropped update touches
nothing. A leaf's old packed moments stay in the state until both of its
new ones are encoded: if an encode raises (out of memory, say), the
state holds no empty leaf, and the error says how far the update went.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.formats import true_divide
from repro_torch.core.mor import EVENT_MOMENT_M, EVENT_MOMENT_V

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
    m: Any  # f32 moments, or PackedMoment leaves under a MomentPolicy
    v: Any
    step: torch.Tensor  # () int32
    # Gradient-compression error-feedback residual (f32, params-shaped)
    # for the '*_ef' compress modes; None otherwise.
    ef: Any = None


def init_opt_state(params, moments=None, ef: bool = False) -> OptState:
    """Fresh optimizer state: f32 master copies, zero moments (packed
    under ``moments``, a MomentPolicy), step 0, and with ``ef=True`` the
    zero residual tree of the '*_ef' gradient-compression modes."""
    from .moments import maybe_encode_moment

    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else "cpu"

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return OptState(
        master=tree_map(lambda p: p.detach().to(torch.float32).clone(),
                        params),
        m=tree_map(lambda p: maybe_encode_moment(zeros(p), moments,
                                                 EVENT_MOMENT_M), params),
        v=tree_map(lambda p: maybe_encode_moment(zeros(p), moments,
                                                 EVENT_MOMENT_V), params),
        step=torch.zeros((), dtype=torch.int32, device=dev),
        ef=tree_map(zeros, params) if ef else None,
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
    """Returns (new bf16 params, the updated opt state, metrics {'lr',
    'grad_norm'}). The state is updated in place (module docstring).

    ``decay_mask`` is a tree like the params whose leaves (0/1 floats, or
    tensors that broadcast against the leaf) multiply each leaf's weight
    decay; by default every leaf of two or more dimensions decays (the
    reference's default mask: the layer-stacked norm scales decay too).

    With ``moments`` (a MomentPolicy), packed leaves of ``opt_state.m`` /
    ``.v`` are decoded for the update and the new moments re-encoded
    under it; metrics then carry the encode events' stats rows
    (``moment_stats_m/v``) and the parameter-weighted logical bytes a
    parameter of each moment tree (``moment_bpe_m/v``).
    ``opt_state.ef`` rides through untouched.

    With a ``guard`` whose ``skip_nonfinite_updates`` is set, a
    nonfinite global grad norm drops the update: master weights, both
    moments and the step counter keep their values (the new values are
    computed, as the reference computes them, for the metrics, and
    dropped), the params are the old master re-cast, and metrics carry
    ``guard_skip`` (1.0 on a dropped step)."""
    from .moments import (PackedMoment, decode_rows, maybe_encode_moment,
                          mean_logical_bpe, moment_stats_rows, packs,
                          row_stripes, without_lanes)

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
    packed = moments is not None and moments.enabled
    guarded = guard is not None and guard.skip_nonfinite_updates
    keep = not guarded or bool(torch.isfinite(gnorm))
    # The new packs, for the metrics (lanes dropped when the update is).
    new_packs = {"m": [], "v": []}

    def rows2d(x):
        return x.reshape(-1, x.shape[-1]) if x.ndim >= 2 else x.reshape(1, -1)

    def new_moment(x, kind, like):
        """(where a moment's new values go, whether they get packed): a
        bf16 buffer when the encode will pack them (it reads their bf16
        view), else the dense leaf itself when the update is kept, else
        a new f32 buffer."""
        if packs(moments if packed else None, kind, like.numel()):
            return torch.empty(like.shape, dtype=torch.bfloat16,
                               device=like.device), True
        if keep and not isinstance(x, PackedMoment):
            return rows2d(x), False
        return torch.empty(like.shape, dtype=torch.float32,
                           device=like.device), False

    def old_rows(x, out, r0, r1):
        """Rows [r0, r1) of a moment's old values as f32 rows to update
        in place: ``out``'s own rows where they are the f32 leaf, else a
        fresh tensor."""
        if isinstance(x, PackedMoment):
            return decode_rows(x, r0, r1)
        rows = rows2d(x)[r0:r1]
        if out.dtype == torch.float32:
            o = out[r0:r1]
            if o.data_ptr() != rows.data_ptr():
                o.copy_(rows)
            return o
        return rows.clone()

    def upd(master, mdict, vdict, k, g, wd):
        """Leaf ``k``'s new (m, v), its master updated in place when the
        update is kept. The reference's expressions, op for op, over
        row stripes of the leaf's 2-D view, so the temporaries are a
        stripe's size; in-place steps act on the stripe's temporaries
        and on the leaf's own new values. A moment to be packed is kept
        in the bf16 its encode reads; the old packed moments stay in the
        state's dicts until both encodes are done (walk writes the new
        ones), so a failed encode leaves them there."""
        m, v = mdict[k], vdict[k]
        mst, g2 = rows2d(master), rows2d(g)
        wd2 = rows2d(torch.broadcast_to(torch.as_tensor(
            wd, dtype=torch.float32, device=master.device), master.shape))
        (m_out, m_pack), (v_out, v_pack) = \
            new_moment(m, EVENT_MOMENT_M, mst), \
            new_moment(v, EVENT_MOMENT_V, mst)
        for r0, r1 in row_stripes(*mst.shape):
            gs = g2[r0:r1].to(torch.float32) * scale
            ms = old_rows(m, m_out, r0, r1)
            ms.mul_(b1)
            ms += (1 - b1) * gs
            vs = old_rows(v, v_out, r0, r1)
            vs.mul_(b2)
            t = (1 - b2) * gs
            t *= gs
            vs += t
            torch.div(vs, c2, out=t)
            t.sqrt_()
            t += cfg.eps
            delta = ms / c1
            delta /= t
            delta += cfg.weight_decay * wd2[r0:r1] * mst[r0:r1]
            delta *= lr
            if keep:
                mst[r0:r1] -= delta
            for out, rows in ((m_out, ms), (v_out, vs)):
                if out.dtype == torch.bfloat16:
                    out[r0:r1] = rows
        m_new, v_new = m_out.reshape(master.shape), \
            v_out.reshape(master.shape)
        del m_out, v_out, m, v
        try:
            if m_pack:
                m_new = maybe_encode_moment(m_new, moments, EVENT_MOMENT_M)
            if v_pack:
                v_new = maybe_encode_moment(v_new, moments, EVENT_MOMENT_V)
        except Exception as e:
            if not keep:
                raise
            raise RuntimeError(
                f"adamw_update: re-encoding the moments of leaf {k!r} "
                "failed; the state is partly updated: the leaves before it "
                "and this leaf's master weights and dense moments hold the "
                "new values, its packed moments and the later leaves the "
                "old ones, and the step counter has not moved") from e
        return m_new, v_new

    def walk(master, m, v, g, wd):
        """Each leaf's update, its new moments written into the state's
        dicts when the update is kept."""
        for k in sorted(master):
            if isinstance(master[k], dict):
                walk(master[k], m[k], v[k], g[k], wd[k])
                continue
            new = upd(master[k], m, v, k, g[k], wd[k])
            for name, x in zip(("m", "v"), new):
                if isinstance(x, PackedMoment):
                    new_packs[name].append(x if keep else without_lanes(x))
            if keep:
                m[k], v[k] = new

    walk(opt_state.master, opt_state.m, opt_state.v, grads, decay_mask)
    metrics = {"lr": lr, "grad_norm": gnorm}
    if packed:
        for name, leaves in new_packs.items():
            rows = moment_stats_rows(leaves)
            if rows is not None:
                metrics[f"moment_stats_{name}"] = rows
            metrics[f"moment_bpe_{name}"] = mean_logical_bpe(leaves)
    if guarded:
        metrics["guard_skip"] = torch.as_tensor(
            0.0 if keep else 1.0, dtype=torch.float32, device=gnorm.device)
    state = opt_state._replace(step=step if keep else opt_state.step)
    new_params = tree_map(lambda p: p.to(torch.bfloat16), state.master)
    return new_params, state, metrics
