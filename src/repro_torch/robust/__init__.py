"""Numerics guard rails (port of ``repro.robust``): the containment side,
``GuardPolicy`` and its escalation ladder. The fault-injection registry
(``repro.robust.faults``) is not ported yet."""
from .guard import (GuardPolicy, guard_flag_set, requantize_with_backoff,
                    tree_select)

__all__ = ["GuardPolicy", "guard_flag_set", "requantize_with_backoff",
           "tree_select"]
