"""Paged KV-cache pool for continuous-batching decode (port of
``repro.serve.paged``).

KV leaves are stored as ``(n_units, n_pages + 1, page_size, ...)``
physical pages; a per-slot block table maps logical position ``p`` to
``(bt[slot, p // page_size], p % page_size)`` and a host-side free list
recycles pages. The last physical page is the *trash page*: block-table
rows of idle or prefilling slots point every entry at it, so a batched
decode step can always run over all slots. The pool is updated in
place (``scatter``, ``splice``, ``recompress_pages``); the reference
threads it through a donated jit.

Only leaves whose sequence axis spans ``max_seq`` are paged: the K/V
payloads and, in the fp8 and MoR tiers, the scale and tag lanes (every
leaf of the dense and MoE families' caches). Recurrent state (hymba's
``ssm/h`` and ``ssm/conv``, the xLSTM cells) and whisper's cross K/V have
no position axis and stay slot-dense, ``(n_units, slots, ...)``: a
batched step reads and replaces them at the full slot count, and
``splice`` writes one slot's row. Leaves are named by their key paths as
in the reference (``dense/k``, ``moe/k_scale``, ``hymba/ssm/h``,
``mlstm/C``, ...), and walked in the reference's pytree order (each
level's keys sorted).
"""
from __future__ import annotations

import collections
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.ref import TAG_BF16, TAG_E4M3, TAG_E5M2, TAG_NVFP4
from repro_torch.models import cache_specs
from repro_torch.models.attention import (kv_bytes_per_element,
                                          kv_stats_row, recompress_kv_nvfp4)

__all__ = ["PagedKVPool", "MOR_BLOCK_ROWS"]

MOR_BLOCK_ROWS = 128  # Partition("block").block_shape[0]


def _is_paged_key(key: str) -> bool:
    """KV leaves with a max_seq position axis; xk / xv (encoder cross-KV,
    enc_seq axis) and recurrent state stay slot-dense."""
    return key.rsplit("/", 1)[-1] in ("k", "v", "k_scale", "v_scale",
                                      "k_tags", "v_tags")


def leaf_paths(tree, prefix=""):
    """[(key path, leaf)] of a nested dict, each level's keys sorted."""
    out = []
    for k in sorted(tree):
        key = f"{prefix}/{k}" if prefix else k
        v = tree[k]
        out += leaf_paths(v, key) if isinstance(v, dict) else [(key, v)]
    return out


def _map(fn, tree, *others, prefix=""):
    """``fn(key path, leaf, *other leaves)`` over a nested dict, keeping
    its structure."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        rest = [o[k] for o in others]
        out[k] = (_map(fn, v, *rest, prefix=key) if isinstance(v, dict)
                  else fn(key, v, *rest))
    return out


class PagedKVPool:
    """Page pool + block table + free list over one model's cache."""

    def __init__(self, cfg: ArchConfig, slots: int, max_seq: int,
                 page_size: Optional[int] = None, kv_fp8: bool = False,
                 n_pages: Optional[int] = None, kv_mor: bool = False,
                 device="cuda"):
        page_size = page_size or min(64, max_seq)
        if max_seq % page_size:
            raise ValueError(
                f"page_size {page_size} must divide max_seq {max_seq}")
        if (MOR_BLOCK_ROWS % page_size) and (page_size % MOR_BLOCK_ROWS):
            raise ValueError(
                f"page_size {page_size} is not MoR-block aligned: it must "
                f"evenly tile the {MOR_BLOCK_ROWS}-row Partition block")
        self.cfg = cfg
        self.slots = slots
        self.max_seq = max_seq
        self.page_size = page_size
        self.pages_per_seq = max_seq // page_size
        self.n_pages = (slots * self.pages_per_seq if n_pages is None
                        else n_pages)
        self.trash = self.n_pages
        self.kv_fp8 = kv_fp8
        self.kv_mor = kv_mor
        self.device = torch.device(device)

        def storage(key, spec):
            shape, dtype = spec
            if _is_paged_key(key):
                # (n_units, B, max_seq, ...) -> (n_units, pages, ps, ...)
                n_units, _, _, *tail = shape
                shape = (n_units, self.n_pages + 1, page_size, *tail)
            return torch.zeros(shape, dtype=dtype, device=self.device)

        # {type: {leaf: tensor}}, nested as cache_specs (hymba's 'ssm').
        self.leaves = _map(storage, cache_specs(cfg, slots, max_seq, kv_fp8,
                                                kv_mor))
        paged = [_is_paged_key(k) for k, _ in self._by_key()]
        self.has_paged = any(paged)
        self.all_paged = all(paged)
        self.block_table = np.full((slots, self.pages_per_seq), self.trash,
                                   np.int32)
        self.free: collections.deque = collections.deque(range(self.n_pages))
        self._owned: List[List[int]] = [[] for _ in range(slots)]

    def _by_key(self):
        """[(key path, leaf)] in the reference's pytree order."""
        return leaf_paths(self.leaves)

    def paged_leaves(self):
        """[(key path, leaf)] of the paged (positional) leaves."""
        return [(k, v) for k, v in self._by_key() if _is_paged_key(k)]

    # ------------------------------------------------------- allocation --
    def free_pages(self) -> int:
        return len(self.free)

    def pages_for(self, n_positions: int) -> int:
        return -(-n_positions // self.page_size)

    def alloc(self, slot: int, n_positions: int) -> bool:
        """Reserve pages covering [0, n_positions) for ``slot``;
        all-or-nothing, False if the free list is short."""
        need = self.pages_for(n_positions) - len(self._owned[slot])
        if need <= 0:
            return True
        if need > len(self.free):
            return False
        got = [self.free.popleft() for _ in range(need)]
        start = len(self._owned[slot])
        self._owned[slot].extend(got)
        self.block_table[slot, start:start + len(got)] = got
        return True

    def release(self, slot: int):
        """Return ``slot``'s pages to the free list; contents stay stale
        (the per-slot cur_index mask hides them)."""
        self.free.extend(self._owned[slot])
        self._owned[slot] = []
        self.block_table[slot, :] = self.trash

    # ------------------------------------------------------ device view --
    def table_rows(self, rows) -> torch.Tensor:
        return torch.as_tensor(self.block_table[rows], dtype=torch.int64,
                               device=self.device)

    def gather(self, bt: torch.Tensor):
        """Dense cache of the pages ``bt`` (B, pages_per_seq) selects: the
        paged leaves as (n_units, B, max_seq, ...) copies; the slot-dense
        state leaves passed through as they are, at the full slot count
        (the caller only mixes them into full-width batches; a decode
        step updates them in place)."""
        B, pp = bt.shape

        def g(key, leaf):
            if not _is_paged_key(key):
                return leaf
            n_units, _, ps, *tail = leaf.shape
            return leaf[:, bt].reshape(n_units, B, pp * ps, *tail)
        return _map(g, self.leaves)

    def scatter(self, dense, bt: torch.Tensor, positions: torch.Tensor):
        """Write back the rows a step touched: ``positions`` (B, S) are
        the positions each row wrote; only those rows move pool-ward.
        State leaves are replaced wholesale (a no-op for the leaves
        ``gather`` passed through and the step updated in place)."""
        B, _ = positions.shape
        rows = torch.arange(B, device=self.device)[:, None]
        page_ids = bt[rows, positions // self.page_size]
        offs = positions % self.page_size

        def s(key, leaf, new):
            if not _is_paged_key(key):
                if new is not leaf:
                    leaf.copy_(new)
            else:
                leaf[:, page_ids, offs] = new[:, rows, positions]
        _map(s, self.leaves, dense)

    def splice(self, slot: int, dense_by_key: Dict[str, torch.Tensor],
               n_positions: int):
        """Write a single-sequence (B = 1) prefill cache into ``slot``:
        ``dense_by_key`` maps key paths (``"dense/k"``, ``"dense/k_scale"``,
        ``"hymba/ssm/h"``, ...) to (n_units, 1, P, ...) K/V leaves, whose
        rows 0..n_positions-1 scatter through the slot's block table, and
        (n_units, 1, ...) state leaves, which land in the slot's row.
        Leaves not named are left alone."""
        pos = torch.arange(n_positions, device=self.device)
        bt = torch.as_tensor(self.block_table[slot], dtype=torch.int64,
                             device=self.device)
        page_ids, offs = bt[pos // self.page_size], pos % self.page_size
        for key, leaf in self._by_key():
            d = dense_by_key.get(key)
            if d is None:
                continue
            if _is_paged_key(key):
                leaf[:, page_ids, offs] = d[:, 0, :n_positions].to(
                    device=self.device, dtype=leaf.dtype)
            else:
                leaf[:, slot] = d[:, 0].to(device=self.device,
                                           dtype=leaf.dtype)

    # -------------------------------------------------- MoR cold tier --
    def _kv_lane_groups(self):
        """[(payload, tags, scales)] per paged k / v lane group."""
        out = []
        for leaves in self.leaves.values():
            for name in ("k", "v"):
                if name + "_tags" in leaves and name + "_scale" in leaves:
                    out.append((leaves[name], leaves[name + "_tags"],
                                leaves[name + "_scale"]))
        return out

    def recompress_pages(self, pages) -> int:
        """Sub4-recompress whole (sealed) pages in place: fp8 payload
        bytes become packed E2M1 nibbles and micro-scale bytes inside
        the same lane, tags TAG_NVFP4, scales retargeted; each lane group
        is recompressed as one slab (one GAM group over the selected
        pages of every layer), as in the reference. The caller
        guarantees the pages are fully written and behind every reader's
        write frontier. Returns the number of pages recompressed."""
        if not self.kv_mor:
            raise ValueError(
                "recompress_pages needs a kv_mor pool (tags lanes)")
        pages = [int(p) for p in pages if int(p) != self.trash]
        if not pages:
            return 0
        idx = torch.as_tensor(pages, dtype=torch.int64, device=self.device)
        for payload, tags, scales in self._kv_lane_groups():
            pay, tg, sc = recompress_kv_nvfp4(payload[:, idx], tags[:, idx],
                                              scales[:, idx])
            payload[:, idx] = pay
            tags[:, idx] = tg.to(tags.dtype)
            scales[:, idx] = sc.to(scales.dtype)
        return len(pages)

    # ----------------------------------------------------- inspection --
    def guard_check(self, slot: int) -> Optional[str]:
        """KV-page guard: a finiteness sweep over ``slot``'s owned pages.
        Paged float lanes (bf16 / fp8 K/V, scale grids) must be finite
        everywhere -- unwritten positions are zero -- so any NaN or Inf is
        corruption. Each lane is reduced on its device and the flags read
        with one host copy; the first bad lane in key order is named.
        Returns the error string, or None when the pages are clean."""
        pages = self._owned[slot]
        if not pages:
            return None
        idx = torch.as_tensor(pages, dtype=torch.int64, device=self.device)
        keys, flags = [], []
        for key, leaf in self.paged_leaves():
            if leaf.is_floating_point():
                keys.append(key)
                flags.append(torch.isfinite(
                    leaf[:, idx].to(torch.float32)).all())
        ok = torch.stack(flags).cpu().numpy() if flags else []
        for key, good in zip(keys, ok):
            if not good:
                return (f"KV-page guard: nonfinite values in lane {key!r} "
                        f"of slot {slot}'s pages")
        return None

    def bytes_per_token(self) -> int:
        """Physical pool bytes per cache position, summed over the paged
        leaves and layers (bf16 2 B an element; MoR 1 B of payload plus
        the tag and scale lanes); 0 for a pool of state alone."""
        return int(sum(leaf.shape[0] * int(np.prod(leaf.shape[3:]))
                       * leaf.element_size()
                       for _, leaf in self.paged_leaves()))

    def state_bytes_per_slot(self) -> int:
        """Bytes of one slot's row of the slot-dense (state) leaves."""
        return int(sum(leaf[:, 0].numel() * leaf.element_size()
                       for k, leaf in self._by_key()
                       if not _is_paged_key(k)))

    def kv_cache_stats(self) -> Dict[str, float]:
        """Host-side tag census over written rows (scale > 0) of owned
        pages: tag fractions, logical payload bytes per element and a
        STATS_WIDTH stats row (``models.attention.kv_stats_row``). Empty
        without ``kv_mor``."""
        if not self.kv_mor:
            return {}
        owned = sorted({p for o in self._owned for p in o})
        if not owned:
            return {"written": 0}
        idx = torch.as_tensor(owned, dtype=torch.int64, device=self.device)
        tags_all, written = [], 0
        for _, tags, scales in self._kv_lane_groups():
            tg = tags[:, idx].cpu().numpy()
            mask = scales[:, idx].cpu().numpy() > 0
            tags_all.append(tg[mask])
            written += int(mask.sum())
        t = np.concatenate(tags_all) if tags_all else np.zeros(0, np.uint8)
        if t.size == 0:
            return {"written": 0}
        frac = lambda tag: float((t == tag).mean())
        tt = torch.from_numpy(t)
        return {
            "written": written,
            "frac_e4m3": frac(TAG_E4M3),
            "frac_e5m2": frac(TAG_E5M2),
            "frac_bf16": frac(TAG_BF16),
            "frac_nvfp4": frac(TAG_NVFP4),
            "frac_fp8": frac(TAG_E4M3) + frac(TAG_E5M2),
            "payload_bpe": float(kv_bytes_per_element(tt)),
            "stats_row": kv_stats_row(tt).numpy(),
        }

    def stats(self) -> Dict[str, int]:
        return {
            "n_pages": self.n_pages,
            "free": len(self.free),
            "page_size": self.page_size,
            "owned": sum(len(o) for o in self._owned),
        }
