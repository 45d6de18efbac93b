"""Host-side MoR statistics aggregation (paper §4.1.3, Figs. 10-11; the
port's copy of ``repro.core.stats``).

The train step emits, per layer and per quantization event, the
STATS_WIDTH vector from :mod:`repro.core.mor`. This module accumulates those
on the host into:

  * BF16-fallback percentages over training (Fig. 10), and
  * relative-error histograms with 0.5%-wide bins, reset every
    ``reset_every`` steps (the Fig. 11 heatmap machinery).

Rendering is plain text (the container has no display); `render_heatmap`
emits an ASCII heat row per tensor, densest bin darkest.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from repro_torch.core.mor import STAT_DECISION, STAT_FRAC_BF16, STAT_REL_ERR

__all__ = ["RelErrHistogram", "MoRStatsTracker"]

# Bins: [0, .5%), [.5, 1%), ..., [5.5%, inf). Matches the paper's Fig. 11.
BIN_EDGES = np.arange(0.0, 0.06, 0.005)
N_BINS = len(BIN_EDGES)  # last bin is open-ended
SHADES = " .:-=+*#%@"


@dataclasses.dataclass
class RelErrHistogram:
    counts: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(N_BINS, dtype=np.int64)
    )

    def add(self, rel_err: float) -> None:
        idx = int(np.searchsorted(BIN_EDGES, rel_err, side="right")) - 1
        self.counts[min(max(idx, 0), N_BINS - 1)] += 1

    def normalized(self) -> np.ndarray:
        total = self.counts.sum()
        return self.counts / total if total else self.counts.astype(float)

    def render(self) -> str:
        norm = self.normalized()
        return "".join(SHADES[min(int(v * (len(SHADES) - 1) * 3), len(SHADES) - 1)]
                       for v in norm)


class MoRStatsTracker:
    """Accumulates per-tensor MoR stats streamed out of train steps."""

    def __init__(self, threshold: float = 0.045, reset_every: int = 6000):
        self.threshold = threshold
        self.reset_every = reset_every
        self.hists: Dict[str, RelErrHistogram] = {}
        self.fallback_events = 0
        self.total_events = 0
        self.step = 0

    def update(self, named_stats: Dict[str, np.ndarray], step: int) -> None:
        """named_stats: tensor-name -> STATS_WIDTH vector (or (L, W) stack)."""
        if self.reset_every and step // self.reset_every != self.step // max(
            self.reset_every, 1
        ):
            self.hists.clear()
        self.step = step
        for name, vec in named_stats.items():
            arr = np.asarray(vec, dtype=np.float64)
            rows = arr.reshape(-1, arr.shape[-1])
            for i, row in enumerate(rows):
                if row[STAT_DECISION] < 0:
                    # decision == -1: disabled-policy (recipe 'off')
                    # event -- its frac_bf16 = 1.0 is definitional, not
                    # a fallback decision; counting it would drag the
                    # fallback percentage toward 100% on partially
                    # quantized models.
                    continue
                key = f"{name}[{i}]" if rows.shape[0] > 1 else name
                self.hists.setdefault(key, RelErrHistogram()).add(
                    float(row[STAT_REL_ERR])
                )
                self.total_events += 1
                # decision==0 and recipe active => BF16 fallback; the
                # frac_bf16 lane covers both tensor- and sub-tensor
                # recipes.
                self.fallback_events += float(row[STAT_FRAC_BF16])

    @property
    def bf16_fallback_pct(self) -> float:
        if not self.total_events:
            return 0.0
        return 100.0 * self.fallback_events / self.total_events

    def render_heatmap(self, limit: int = 48) -> str:
        lines: List[str] = []
        header = "tensor".ljust(44) + "|" + "0.5% bins -> 5.5%+"
        lines.append(header)
        for name in sorted(self.hists)[:limit]:
            lines.append(name.ljust(44)[:44] + "|" + self.hists[name].render())
        lines.append(
            f"bf16 fallback: {self.bf16_fallback_pct:.2f}% of "
            f"{self.total_events} events (th={self.threshold*100:.1f}%)"
        )
        return "\n".join(lines)
