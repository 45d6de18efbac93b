"""Deterministic, seed-keyed fault injection: the chaos harness (port of
``repro.robust.faults``).

Every fault class the guard rails claim to survive is registered here,
in the reference's order, so a test suite can enumerate the classes and
pin each to a test. Every injector is a pure function of (object, seed)
but ``kv_page_trash``, which trashes the pool in place as the reference
does: the same seed corrupts the same leaf, element, bit and byte as the
reference's on the same tree (same leaf order, same
``np.random.default_rng`` draws).

Layers: ``train`` poisons a gradient tree (NaN / Inf); ``pack``
corrupts a :class:`~repro_torch.kernels.ref.MixedOperand` after packing
(payload bit flips, a NaN GAM scale, a NaN micro-scale byte); ``quant``
shrinks the group amax (a stale history value); ``serve`` trashes a live
page of a :class:`~repro_torch.serve.paged.PagedKVPool`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core.formats import true_divide
from repro_torch.core.tree import flatten_with_path, map_with_path

__all__ = [
    "FaultSpec",
    "register_fault",
    "fault_names",
    "fault_specs",
    "get_fault",
    "poison_tree",
    "make_grad_fault",
]


class FaultSpec(NamedTuple):
    name: str
    layer: str  # train | pack | quant | serve
    description: str
    inject: Callable


_REGISTRY: Dict[str, FaultSpec] = {}


def register_fault(name: str, layer: str, description: str):
    """Decorator: add an injector to the fault-class registry."""

    def deco(fn):
        if name in _REGISTRY:
            raise ValueError(f"duplicate fault class {name!r}")
        _REGISTRY[name] = FaultSpec(name, layer, description, fn)
        return fn

    return deco


def fault_names() -> Tuple[str, ...]:
    """All registered fault-class names, registration-ordered."""
    return tuple(_REGISTRY)


def fault_specs() -> Tuple[FaultSpec, ...]:
    return tuple(_REGISTRY.values())


def get_fault(name: str) -> FaultSpec:
    return _REGISTRY[name]


def _is_float(leaf) -> bool:
    t = torch.as_tensor(leaf)
    return t.is_floating_point() or t.is_complex()


def _pick_leaf(leaves, seed: int):
    """Deterministic (leaf index, flat element index) among the float
    leaves of a flattened tree."""
    rng = np.random.default_rng(seed)
    cands = [i for i, leaf in enumerate(leaves)
             if _is_float(leaf) and torch.as_tensor(leaf).numel() > 0]
    if not cands:
        raise ValueError("tree has no non-empty float leaves to poison")
    k = cands[int(rng.integers(len(cands)))]
    return k, int(rng.integers(torch.as_tensor(leaves[k]).numel()))


def _replace_leaf(tree, key: str, new):
    """``tree`` with its leaf at key path ``key`` replaced by ``new``; the
    other leaves are shared, not copied."""
    return map_with_path(lambda path, leaf: new if path == key else leaf,
                         tree)


def _set_element(leaf: torch.Tensor, idx: int, value) -> torch.Tensor:
    """A copy of ``leaf`` with flat element ``idx`` set to f32 ``value``
    cast to the leaf's dtype."""
    out = leaf.clone(memory_format=torch.contiguous_format)
    out.view(-1)[idx] = torch.tensor(value, dtype=torch.float32).to(
        leaf.dtype)
    return out


def poison_tree(tree, value, seed: int = 0):
    """Set one seed-keyed element of one float leaf to ``value``."""
    flat = flatten_with_path(tree)
    k, idx = _pick_leaf([leaf for _, leaf in flat], seed)
    key, leaf = flat[k]
    return _replace_leaf(tree, key, _set_element(leaf, idx, value))


def make_grad_fault(kind: str = "nan", seed: int = 0):
    """A gradient-poisoning hook for ``make_train_step(grad_fault=)``.

    The returned ``hook(grads, batch)`` poisons one seed-keyed element
    when the scalar ``batch['inject']`` is nonzero and is the identity
    otherwise. The choice of leaf and element is made on the host from
    the tree's structure; the flag is read on the device
    (``torch.where``), so one step function serves clean and injected
    steps with no host read."""
    bad = {"nan": np.nan, "inf": np.inf}[kind]

    def hook(grads, batch):
        flag = batch.get("inject")
        if flag is None:
            return grads
        flat = flatten_with_path(grads)
        k, idx = _pick_leaf([leaf for _, leaf in flat], seed)
        key, leaf = flat[k]
        fire = torch.any(torch.as_tensor(flag, device=leaf.device) > 0)
        poisoned = leaf.clone(memory_format=torch.contiguous_format)
        poisoned.view(-1)[idx] = torch.where(
            fire, torch.tensor(bad, dtype=torch.float32,
                               device=leaf.device).to(leaf.dtype),
            leaf.reshape(-1)[idx])
        return _replace_leaf(grads, key, poisoned)

    return hook


@register_fault(
    "grad_nan", "train",
    "one gradient element becomes NaN (e.g. 0/0 in a fused loss) -- "
    "must be preserved through compression's BF16 arm and dropped by "
    "the optimizer skip-step",
)
def inject_grad_nan(grads, seed: int = 0):
    return poison_tree(grads, np.nan, seed)


@register_fault(
    "grad_inf", "train",
    "one gradient element overflows to +Inf -- must not poison the "
    "Alg. 1 group mantissa of clean blocks and must be dropped by the "
    "optimizer skip-step",
)
def inject_grad_inf(grads, seed: int = 0):
    return poison_tree(grads, np.inf, seed)


@register_fault(
    "payload_bitflip", "pack",
    "one bit of the fp8 payload lane flips (bus/HBM upset) -- decodes "
    "to a wrong-but-finite or NaN value; containment is the consumer's "
    "nonfinite checks (skip-step / quarantine), detection the guard "
    "counters downstream",
)
def inject_payload_bitflip(mo, seed: int = 0):
    rng = np.random.default_rng(seed)
    pay = mo.payload_q
    idx = int(rng.integers(pay.numel()))
    bit = 1 << int(rng.integers(8))
    flat = pay.reshape(-1).clone()
    flat[idx] = flat[idx] ^ bit
    return dataclasses.replace(mo, payload_q=flat.reshape(pay.shape))


@register_fault(
    "scale_corrupt", "pack",
    "one per-block GAM scale becomes NaN (corrupted scale buffer) -- "
    "every element of that block decodes nonfinite. (An *Inf* scale "
    "would decode to silent zeros -- dequant divides by the scale -- "
    "which no finiteness guard can see; catching that class needs "
    "payload checksums, out of scope here.)",
)
def inject_scale_corrupt(mo, seed: int = 0):
    rng = np.random.default_rng(seed)
    sc = mo.scales
    idx = int(rng.integers(sc.numel()))
    return dataclasses.replace(mo, scales=_set_element(sc, idx, np.nan))


@register_fault(
    "micro_scale_corrupt", "pack",
    "one NVFP4 micro-scale byte becomes 0xFF (an E4M3 NaN bit "
    "pattern) -- the micro-group decodes NaN",
)
def inject_micro_scale_corrupt(mo, seed: int = 0):
    rng = np.random.default_rng(seed)
    ms = mo.micro_scales
    if ms.numel() == 0:
        raise ValueError("operand has no micro-scale lane to corrupt")
    idx = int(rng.integers(ms.numel()))
    flat = ms.reshape(-1).clone()
    flat[idx] = 0xFF
    return dataclasses.replace(mo, micro_scales=flat.reshape(ms.shape))


@register_fault(
    "stale_amax", "quant",
    "the group amax driving the scales is a stale history value that "
    "under-covers the live tensor -- the saturating cast would "
    "silently clip; the bounded re-encode retry must widen or fall "
    "back to BF16 with GUARD_STALE_SCALE",
)
def inject_stale_amax(amax, seed: int = 0, shrink: float = 8.0):
    del seed  # the staleness factor is the whole fault
    return true_divide(torch.as_tensor(amax, dtype=torch.float32),
                       float(shrink))


@register_fault(
    "kv_page_trash", "serve",
    "a live KV page's lanes are overwritten with garbage (NaN floats, "
    "0xFF payload bytes = fp8 NaN) -- the owning slot's decode emits "
    "nonfinite logits and must be quarantined without perturbing any "
    "other slot's tokens",
)
def inject_kv_page_trash(pool, page: int, seed: int = 0):
    """In place on the pool's paged leaves (the engine owns its pool; each
    holds the page on axis 1; slot-dense state has no pages). Integer
    lanes other than uint8 are left alone: the fault models data
    corruption the guard must catch, not an impossible tag."""
    del seed  # whole-page trash: position within the page is moot
    for _, leaf in pool.paged_leaves():
        if leaf.is_floating_point():
            leaf[:, page] = float("nan")
        elif leaf.dtype == torch.uint8:
            leaf[:, page] = 0xFF
