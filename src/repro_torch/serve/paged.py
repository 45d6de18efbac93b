"""Paged KV-cache pool for continuous-batching decode (port of the bf16
pool of ``repro.serve.paged``).

KV leaves are stored as ``(n_units, n_pages + 1, page_size, hkv, hd)``
physical pages; a per-slot block table maps logical position ``p`` to
``(bt[slot, p // page_size], p % page_size)`` and a host-side free list
recycles pages. The last physical page is the *trash page*: block-table
rows of idle or prefilling slots point every entry at it, so a batched
decode step can always run over all slots. The pool is updated in
place (``scatter``); the reference threads it through a donated jit.
"""
from __future__ import annotations

import collections
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import cache_specs

__all__ = ["PagedKVPool", "MOR_BLOCK_ROWS"]

MOR_BLOCK_ROWS = 128  # Partition("block").block_shape[0]


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
        self.device = torch.device(device)

        specs = cache_specs(cfg, slots, max_seq, kv_fp8, kv_mor)
        # Every leaf of the ported caches is positional (k, v).
        self.leaves: Dict[str, Dict[str, torch.Tensor]] = {}
        for t, leaves in specs.items():
            self.leaves[t] = {}
            for key, (shape, dtype) in leaves.items():
                n_units, _, _, *tail = shape
                self.leaves[t][key] = torch.zeros(
                    (n_units, self.n_pages + 1, page_size, *tail),
                    dtype=dtype, device=self.device)
        self.block_table = np.full((slots, self.pages_per_seq), self.trash,
                                   np.int32)
        self.free: collections.deque = collections.deque(range(self.n_pages))
        self._owned: List[List[int]] = [[] for _ in range(slots)]

    # ------------------------------------------------------- allocation --
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
        """Dense cache {type: {leaf: (n_units, B, max_seq, ...)}} of the
        pages ``bt`` (B, pages_per_seq) selects (a copy)."""
        B, pp = bt.shape
        out = {}
        for t, leaves in self.leaves.items():
            out[t] = {}
            for key, leaf in leaves.items():
                n_units, _, ps, *tail = leaf.shape
                out[t][key] = leaf[:, bt].reshape(n_units, B, pp * ps, *tail)
        return out

    def scatter(self, dense, bt: torch.Tensor, positions: torch.Tensor):
        """Write back the rows a step touched: ``positions`` (B, S) are
        the positions each row wrote; only those rows move pool-ward."""
        B, _ = positions.shape
        rows = torch.arange(B, device=self.device)[:, None]
        page_ids = bt[rows, positions // self.page_size]
        offs = positions % self.page_size
        for t, leaves in self.leaves.items():
            for key, leaf in leaves.items():
                leaf[:, page_ids, offs] = dense[t][key][:, rows, positions]
