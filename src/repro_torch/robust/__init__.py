"""Numerics guard rails and fault injection (port of ``repro.robust``).

- :mod:`.guard`, the containment side: ``GuardPolicy`` and its
  escalation ladder (block BF16 fallback, tensor BF16 fallback,
  optimizer skip-step, bounded re-encode retry).
- :mod:`.faults`, the adversary side: the deterministic, seed-keyed
  fault-injection registry (NaN / Inf gradients, payload bit flips,
  scale corruption, stale amaxes, trashed KV pages).
"""
from .faults import (FaultSpec, fault_names, fault_specs, get_fault,
                     make_grad_fault, poison_tree)
from .guard import (GuardPolicy, guard_flag_set, requantize_with_backoff,
                    tree_select)

__all__ = ["GuardPolicy", "guard_flag_set", "requantize_with_backoff",
           "tree_select", "FaultSpec", "fault_names", "fault_specs",
           "get_fault", "make_grad_fault", "poison_tree"]
