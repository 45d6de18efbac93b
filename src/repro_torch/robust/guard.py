"""Nonfinite containment: the guard policy and its escalation ladder
(port of ``repro.robust.guard``).

Rungs 1-2 (block and tensor BF16 fallback) are properties of the
selection arithmetic (``core.mor``) and always on. Rung 3, the
skip-step (``GuardPolicy.skip_nonfinite_updates``): a nonfinite global
grad norm makes ``optim.adamw.adamw_update`` keep the master weights,
both Adam moments (packed lanes bit for bit) and the step counter, and
the train step keep the error-feedback residuals. Rung 4,
:func:`requantize_with_backoff`: an encode under a stale amax widened
through at most ``max_requant_retries`` doublings, else BF16 and
``GUARD_STALE_SCALE``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core.formats import E4M3, FormatSpec, cast_to_format, \
    true_divide
from repro_torch.core.gam import exp2i
from repro_torch.core.mor import (EVENT_GEMM, GUARD_NONFINITE_AMAX,
                                  GUARD_STALE_SCALE, STAT_AMAX,
                                  STAT_DECISION, STAT_EVENT_KIND,
                                  STAT_FRAC_BF16, STAT_FRAC_E4M3,
                                  STAT_GROUP_MANTISSA, STAT_GUARD_FLAGS,
                                  STAT_PAYLOAD_BPE, STATS_WIDTH)

__all__ = ["GuardPolicy", "guard_flag_set", "tree_select",
           "requantize_with_backoff"]


@dataclasses.dataclass(frozen=True)
class GuardPolicy:
    """The optimizer-level rungs of the ladder."""

    # Rung 3: drop a whole update when the global grad norm is nonfinite.
    skip_nonfinite_updates: bool = True
    # Rung 4: amax doublings before a stale scale falls back to BF16.
    max_requant_retries: int = 2


def guard_flag_set(guard_flags, flag) -> torch.Tensor:
    """True where the power-of-two ``flag`` is set in a guard_flags lane
    value (flags are sums of distinct powers of two, stored f32)."""
    f = torch.as_tensor(guard_flags, dtype=torch.float32)
    return torch.remainder(torch.floor_divide(f, float(flag)), 2.0) >= 1.0


def tree_select(ok, new_tree, old_tree):
    """Per-leaf ``where(ok, new, old)`` over two trees of one structure,
    ``ok`` a scalar bool. The port runs eagerly, so ``ok`` is read once
    on the host and a leaf is taken whole: a dropped update returns the
    old leaves themselves (cast to the new leaf's dtype, as the
    reference casts), packed moments with every lane bit for bit."""
    take_new = bool(ok)

    def pick(n, o):
        if isinstance(n, dict):
            return {k: pick(n[k], o[k]) for k in n}
        if take_new:
            return n
        if isinstance(n, torch.Tensor) and isinstance(o, torch.Tensor):
            return o.to(n.dtype)
        return o

    return pick(new_tree, old_tree)


def requantize_with_backoff(x2d: torch.Tensor, stale_amax, *,
                            fmt: FormatSpec = E4M3,
                            max_retries: int = 2
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Rung 4: encode under a delayed (possibly stale) amax. The ladder
    ``stale_amax * 2**[0..max_retries]`` is checked against the true
    amax with scalar arithmetic and the one encode runs at the smallest
    covering rung; if none covers (or the operand or the stale amax is
    nonfinite), the event passes through as is and flags
    ``GUARD_STALE_SCALE``. Returns ``(y, stats, attempts)``: the
    fake-quantized (or passthrough) f32 tensor, a stats row, and the
    doublings spent (``max_retries`` on fallback)."""
    xf = x2d.to(torch.float32)
    dev = xf.device
    true_amax = torch.amax(xf.abs())
    stale = torch.as_tensor(stale_amax, dtype=torch.float32, device=dev)
    ladder = stale * exp2i(torch.arange(max_retries + 1, dtype=torch.int32,
                                        device=dev))
    covered = ladder >= true_amax
    recoverable = (torch.any(covered) & torch.isfinite(true_amax)
                   & torch.isfinite(stale) & (stale > 0))
    # The first covering rung (argmax of the monotone mask), the top rung
    # when nothing covers.
    attempts = torch.where(
        recoverable, torch.argmax(covered.to(torch.int32)).to(torch.int32),
        torch.tensor(max_retries, dtype=torch.int32, device=dev))
    eff_amax = torch.where(recoverable, ladder[attempts],
                           torch.ones((), dtype=torch.float32, device=dev))
    s = true_divide(fmt.amax, eff_amax)
    y = torch.where(recoverable, torch.div(cast_to_format(xf * s, fmt), s),
                    xf)
    # A nonfinite stale amax is a corrupted scale buffer: flagged like
    # nonfinite data.
    amax_ok = torch.isfinite(true_amax) & torch.isfinite(stale)
    flags = (torch.where(amax_ok, 0.0, GUARD_NONFINITE_AMAX)
             + torch.where(recoverable, 0.0, GUARD_STALE_SCALE))
    okf = recoverable.to(torch.float32)
    stats = torch.zeros((STATS_WIDTH,), dtype=torch.float32, device=dev)
    stats[STAT_DECISION] = okf
    stats[STAT_AMAX] = true_amax
    stats[STAT_FRAC_E4M3] = okf
    stats[STAT_FRAC_BF16] = 1.0 - okf
    stats[STAT_GROUP_MANTISSA] = 1.0
    stats[STAT_EVENT_KIND] = EVENT_GEMM
    stats[STAT_PAYLOAD_BPE] = okf + 2.0 * (1.0 - okf)
    stats[STAT_GUARD_FLAGS] = flags
    return y, stats, attempts
