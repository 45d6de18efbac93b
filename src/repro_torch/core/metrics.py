"""Range-gate constants of the MoR metrics (port of the two constants of
``repro.core.metrics`` this slice needs)."""
from __future__ import annotations

__all__ = ["E5M2_RANGE_RATIO", "NVFP4_RANGE_RATIO"]

# Eq. 4: max-representable(E5M2) / min-normal(E5M2).
E5M2_RANGE_RATIO = 57344.0 / 2.0**-14

# Eq. 4 analog for the NVFP4 candidate: block amax over the smallest
# non-zero micro-group amax must fit E2M1's (6 / 0.5) span on top of
# the E4M3 micro scales' finite span (448 / 2^-9).
NVFP4_RANGE_RATIO = (6.0 / 0.5) * (448.0 / 2.0**-9)
