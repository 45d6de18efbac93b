"""Key paths over the port's state trees, spelled and ordered as
``jax.tree_util`` spells and orders the reference's.

A tree is built of dicts (children in sorted key order, key ``['k']``),
tuples and lists (``[i]``), NamedTuples such as ``OptState`` (``.field``,
in field order), :class:`~repro_torch.optim.moments.PackedMoment`
(``.mo``, ``.stats``) and :class:`~repro_torch.kernels.ref.MixedOperand`
(its six lanes, in the reference's ``tree_flatten`` order). ``None`` is
an empty subtree; anything else is a leaf. The static fields (a
PackedMoment's ``shape``, a MixedOperand's ``block``, ``shape`` and
``has_nvfp4``) are not leaves, as in the reference. The checkpoint keys
(``repro_torch.checkpoint``) and the fault injectors' leaf choice
(``repro_torch.robust.faults``) both follow this order.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Tuple

__all__ = ["MO_LANES", "flatten_with_path", "map_with_path"]

# MixedOperand's children in the reference's tree_flatten order.
MO_LANES = ("payload_q", "payload_bf16", "tags", "scales", "payload_nib",
            "micro_scales")


def _children(node):
    """(key, child) pairs of an inner node in jax's order, or None for a
    leaf."""
    from repro_torch.kernels.ref import MixedOperand
    from repro_torch.optim.moments import PackedMoment

    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if isinstance(node, MixedOperand):
        return [(f".{n}", getattr(node, n)) for n in MO_LANES]
    if isinstance(node, PackedMoment):
        return [(".mo", node.mo), (".stats", node.stats)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (tuple, list)):
        return [(f"[{i}]", c) for i, c in enumerate(node)]
    return None


def flatten_with_path(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(key path, leaf) pairs of ``tree`` in ``jax.tree_util`` leaf
    order; each path is spelled as ``jax.tree_util.keystr`` spells the
    reference's (``[1].m['w'].mo.payload_q``)."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for key, child in kids:
        out += flatten_with_path(child, prefix + key)
    return out


def map_with_path(fn: Callable[[str, Any], Any], tree, prefix: str = ""):
    """A tree of ``tree``'s structure holding ``fn(path, leaf)`` for every
    leaf (the static fields of its nodes kept)."""
    from repro_torch.kernels.ref import MixedOperand
    from repro_torch.optim.moments import PackedMoment

    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{prefix}[{k!r}]")
                for k, v in tree.items()}
    if isinstance(tree, MixedOperand):
        return dataclasses.replace(tree, **{
            n: map_with_path(fn, getattr(tree, n), f"{prefix}.{n}")
            for n in MO_LANES})
    if isinstance(tree, PackedMoment):
        return dataclasses.replace(
            tree, mo=map_with_path(fn, tree.mo, prefix + ".mo"),
            stats=map_with_path(fn, tree.stats, prefix + ".stats"))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_with_path(fn, getattr(tree, f),
                                          f"{prefix}.{f}")
                            for f in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_with_path(fn, c, f"{prefix}[{i}]")
                          for i, c in enumerate(tree))
    return fn(prefix, tree)
