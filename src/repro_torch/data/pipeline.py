"""Deterministic, shardable synthetic data pipeline (the port's own copy
of ``repro.data.pipeline``, numpy only: ``batch_at(step)`` gives the
reference's tokens bit for bit).

Produces a reproducible token stream from a seed: batch ``i`` is a pure
function of (seed, step, shard), so any host in a multi-host job can
generate exactly its shard without communication, and restarts resume
bit-identically from the step counter (fault tolerance depends on this).

The generator is a structured Markov-ish stream (not uniform noise) so
small models actually have something learnable: token t+1 depends on
token t through a fixed random permutation plus noise -- cross-entropy
drops well below ln(V) within a few hundred steps, which the quality
benchmarks (paper Tables 2-4 analogues) rely on.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator

import numpy as np

__all__ = ["DataConfig", "SyntheticLM", "prefetch"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    # Structure: probability the next token follows the permutation rule.
    order: float = 0.8
    shard_id: int = 0
    num_shards: int = 1


class SyntheticLM:
    """step -> {'tokens': (B_local, S) i32, 'labels': (B_local, S) i32}."""

    def __init__(self, cfg: DataConfig):
        if cfg.global_batch % cfg.num_shards:
            raise ValueError(
                f"global_batch {cfg.global_batch} must divide evenly "
                f"over {cfg.num_shards} shard(s)"
            )
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.num_shards
        root = np.random.default_rng(cfg.seed)
        self.perm = root.permutation(cfg.vocab)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed, step, cfg.shard_id)
        )
        B, S = self.local_batch, cfg.seq_len
        toks = np.empty((B, S + 1), np.int32)
        toks[:, 0] = rng.integers(0, cfg.vocab, B)
        follow = rng.random((B, S)) < cfg.order
        noise = rng.integers(0, cfg.vocab, (B, S))
        for t in range(S):
            nxt = self.perm[toks[:, t]]
            toks[:, t + 1] = np.where(follow[:, t], nxt, noise[:, t])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def prefetch(it: Iterator, depth: int = 2) -> Iterator:
    """Background-thread prefetcher (overlaps host datagen with steps)."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = object()

    def worker():
        try:
            for item in it:
                q.put(item)
        finally:
            q.put(stop)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is stop:
            return
        yield item
