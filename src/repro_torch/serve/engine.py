"""Continuous-batching serving engine over a paged KV pool (port of
``repro.serve.engine``).

Every slot advances at its own position. Each engine step admits
queued requests (reserving their worst-case page span), runs one
fixed-size prompt chunk per prefilling slot and one batched decode step
over the decoding slots. Sampling is the reference's host-side numpy
code, so greedy and seeded sampled tokens match it given equal logits.
With ``quantize`` set, every GEMM weight becomes a QTensor and every
prefill and decode matmul runs through the mixed GEMM kernel; a params
tree already quantized (QTensor leaves) is taken as it is with
``quantize=None``.

KV tiers (``ServeConfig``): bf16 pages by default; ``kv_fp8`` (E4M3
payloads with per-(position, head) scales); ``kv_mor`` (per-row E4M3 /
E5M2 tag-select with GAM scales), with ``kv_mor_cold`` sealing pages the
write frontier has left that far behind into NVFP4; ``kv_guard`` sweeps
each decoding slot's pages for nonfinite lanes before its logits are
read, so the quarantine names the corrupted lane. ``_full_prefill`` is
the one-shot prefill (``make_prefill_fn`` plus ``PagedKVPool.splice``,
the tier's quantizer at the splice) of families whose state cannot be
paged (``chunked_prefill`` is False unless every cache leaf is
positional, as in the reference): the recurrent families (hymba,
xLSTM), whose state the splice writes into the slot's row. The dense and
MoE families prefill in chunks. Every batched decode step runs all
slots; slots that are not decoding ride along on the trash page and
overwrite their own recurrent state, which admission replaces. Under
``quantize`` the MoE expert stacks (4-D) and
routers stay dense, as in the reference: the expert GEMMs run through
``mor_dot`` under the engine's ``MoRDotPolicy``, and every slot of a
decode batch (idle ones on token 0 at position 0) feeds the same expert
buffers.

Tensor-parallel serving (``mesh``, a ``core.collectives.Mesh`` with a
'model' axis; one process a rank): every rank quantizes the global
params as above, keeps its blocks under the reference's rules
(``serve.quantized.shard_params``: ``sharding.rules.
quantized_param_specs``, then ``local_shards``) and runs every model
call with the mesh bound. Activations and the paged pool stay whole on
every rank, as the reference's engine shards only the params; the
ranks of a ``data`` axis hold the same blocks and compute the same. The
dense family only: the MoE and recurrent families' rules shard dense
expert stacks and mixer leaves (ROADMAP Queue 1, item 1d), and raise.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.collectives import Mesh, use_mesh
from repro_torch.core.policy import MoRDotPolicy, MoRPolicy
from repro_torch.models import make_decode_fn, make_prefill_fn
from repro_torch.models.attention import quantize_kv, quantize_kv_mor
from repro_torch.models.transformer import resolve_device

from .paged import PagedKVPool, leaf_paths
from .quantized import quantize_params, shard_params

__all__ = ["Request", "ServeConfig", "Engine", "PromptTooLongError"]


class PromptTooLongError(ValueError):
    """Prompt has no room in the cache (P >= max_seq)."""


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (P,) int32
    max_tokens: int = 16
    # temperature <= 0 is greedy argmax; otherwise softmax sampling,
    # optionally top_k-truncated, seeded per (seed, rid).
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    error: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    slots: int = 4
    max_seq: int = 512
    page_size: Optional[int] = None
    pool_pages: Optional[int] = None
    prefill_chunk: int = 32
    kv_fp8: bool = False
    kv_mor: bool = False
    kv_mor_cold: Optional[int] = None
    on_long_prompt: str = "reject"  # 'reject' | 'truncate'
    kv_guard: bool = False


def _check_mesh(cfg: ArchConfig, mesh) -> None:
    """A tensor-parallel mesh the engine serves: a ``Mesh`` with a 'model'
    axis, for the dense family."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a repro_torch.core.collectives.Mesh, "
                        f"got {type(mesh).__name__}")
    if "model" not in mesh.names:
        raise ValueError(f"mesh axes {mesh.names} have no 'model' axis")
    if cfg.family != "dense":
        raise NotImplementedError(
            f"tensor-parallel serving of the {cfg.family!r} family is not "
            "ported yet (ROADMAP Queue 1, item 1d: expert-parallel dense "
            "stacks and the recurrent mixers' rules)")


def _to_device(tree, dev):
    """Tensors and QTensors alike (``QTensor.to``)."""
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    return tree.to(dev)


class Engine:
    def __init__(self, cfg: ArchConfig, policy: MoRDotPolicy, params,
                 scfg: ServeConfig = ServeConfig(),
                 quantize: Optional[MoRPolicy] = None,
                 quantize_min_size: int = 1 << 16, mesh=None,
                 device="cuda"):
        """``quantize``: ahead-of-time MoR storage decision -- weight
        leaves become QTensors and every matmul against them runs
        through the mixed GEMM. ``mesh``: tensor-parallel serving on
        this rank (module docstring); every rank passes the same global
        params. ``device``: CUDA unless the caller asks for the CPU
        (then every kernel runs its plain version)."""
        if cfg.family in ("audio", "vlm"):
            raise NotImplementedError(
                f"family {cfg.family!r} needs a modality frontend the "
                "engine does not drive (frames/patches inputs)")
        if mesh is not None:
            _check_mesh(cfg, mesh)
        if scfg.max_seq % scfg.prefill_chunk:
            raise ValueError(
                f"prefill_chunk {scfg.prefill_chunk} must divide "
                f"max_seq {scfg.max_seq}")
        if scfg.kv_fp8 and scfg.kv_mor:
            raise ValueError("kv_fp8 and kv_mor are mutually exclusive")
        if scfg.kv_mor_cold is not None and not scfg.kv_mor:
            raise ValueError("kv_mor_cold needs kv_mor=True")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.scfg = scfg
        self.qstats = None
        params = _to_device(params, self.device)
        if quantize is not None:
            params, self.qstats = quantize_params(
                params, quantize, min_size=quantize_min_size)
        self.mesh = mesh
        if mesh is not None:
            # This rank's blocks; the global quantized tree is dropped.
            params = shard_params(cfg, params, mesh)
        self.params = params
        self.pool = PagedKVPool(cfg, scfg.slots, scfg.max_seq,
                                page_size=scfg.page_size, kv_fp8=scfg.kv_fp8,
                                n_pages=scfg.pool_pages, kv_mor=scfg.kv_mor,
                                device=self.device)
        self._sealed = set()  # (slot, page index) sub4-recompressed
        # Chunked prefill needs every cache leaf positional (pageable);
        # the recurrent families prefill in one shot at admission.
        self.chunked_prefill = self.pool.all_paged and self.pool.has_paged
        self._prefill = make_prefill_fn(cfg, policy)
        self._decode = make_decode_fn(cfg, policy)

        n = scfg.slots
        self.slot_req: List[Optional[Request]] = [None] * n
        self.slot_pos = np.zeros(n, np.int32)
        self.slot_next = np.zeros(n, np.int32)
        self.slot_state = ["idle"] * n  # idle | prefill | decode
        self.slot_filled = np.zeros(n, np.int32)
        self.queue: Deque[Request] = collections.deque()
        self.unfinished: List[Request] = []
        self.quarantined: List[Request] = []
        self.rejected: List[Request] = []
        self.steps = 0
        self.decode_steps = 0
        self.prefill_chunks = 0

    def _bound(self):
        """The mesh bound for a model call (``use_mesh``), or nothing."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return use_mesh(self.mesh)

    # ------------------------------------------------------------- step --
    def _step_fn(self, bt: torch.Tensor, toks: np.ndarray,
                 cur: np.ndarray) -> torch.Tensor:
        """One model call: gather the rows' pages, run the decode
        function (writes the new K/V into the gathered cache and the new
        recurrent state into the pool's), scatter the written positions
        back. Returns the logits."""
        cache = self.pool.gather(bt)
        toks_t = torch.as_tensor(toks, dtype=torch.int64, device=self.device)
        cur_t = torch.as_tensor(cur, dtype=torch.int64, device=self.device)
        with self._bound():
            logits, cache, _ = self._decode(self.params, cache, toks_t,
                                            cur_t)
        S = toks_t.shape[1]
        positions = cur_t[:, None] - (S - 1) + torch.arange(
            S, device=self.device)[None]
        self.pool.scatter(cache, bt, positions)
        return logits

    # ------------------------------------------------------------ admin --
    def submit(self, req: Request):
        """Queue a request; P >= max_seq is rejected (PromptTooLongError)
        or truncated per ``ServeConfig.on_long_prompt``."""
        P = len(req.prompt)
        if P < 1:
            raise ValueError(f"request {req.rid}: empty prompt")
        limit = self.scfg.max_seq - 1
        if P > limit:
            if self.scfg.on_long_prompt == "truncate":
                req.prompt = np.asarray(req.prompt)[:limit]
                req.error = (f"prompt truncated {P} -> {limit} tokens "
                             f"(max_seq={self.scfg.max_seq})")
            else:
                raise PromptTooLongError(
                    f"request {req.rid}: prompt of {P} tokens exceeds "
                    f"the max_seq - 1 = {limit} limit (set "
                    "on_long_prompt='truncate' to clip instead)")
        self.queue.append(req)

    def _horizon(self, req: Request) -> int:
        """Highest cache position + 1 the request can touch."""
        P = len(req.prompt)
        C = self.scfg.prefill_chunk
        span = -(-P // C) * C if self.chunked_prefill else P
        return min(max(span, P + req.max_tokens - 1), self.scfg.max_seq)

    def _admit(self):
        free = [i for i, r in enumerate(self.slot_req) if r is None]
        for slot in free:
            req = None
            while self.queue and req is None:
                head = self.queue[0]
                need = self.pool.pages_for(self._horizon(head))
                if need > self.pool.n_pages:
                    # Unsatisfiable: reject rather than starve the queue.
                    self.queue.popleft()
                    head.error = (
                        f"rejected at admission: worst-case reservation "
                        f"of {need} pages exceeds the pool's "
                        f"{self.pool.n_pages} total pages (page_size="
                        f"{self.pool.page_size}); shrink the prompt or "
                        "max_tokens, or grow pool_pages")
                    head.done = True
                    self.rejected.append(head)
                    continue
                req = head
            if req is None:
                return
            if not self.pool.alloc(slot, self._horizon(req)):
                return  # wait for evictions to refill the free list
            self.queue.popleft()
            self.slot_req[slot] = req
            self.slot_filled[slot] = 0
            if self.chunked_prefill:
                self.slot_state[slot] = "prefill"
            else:
                self._full_prefill(slot, req)

    # ---------------------------------------------------------- prefill --
    def _full_prefill(self, slot: int, req: Request):
        """One-shot prefill: the whole prompt in one causal pass, its bf16
        K/V quantized to the pool's tier and spliced into this slot's
        pages, its recurrent state into the slot's row."""
        prompt = torch.as_tensor(np.asarray(req.prompt)[None],
                                 dtype=torch.int64, device=self.device)
        with self._bound():
            logits, pcache, _ = self._prefill(self.params,
                                              {"tokens": prompt})
        by_key: Dict[str, torch.Tensor] = dict(leaf_paths(pcache))
        for key in list(by_key):
            if key.rsplit("/", 1)[-1] not in ("k", "v"):
                continue
            if self.scfg.kv_fp8:
                by_key[key], by_key[key + "_scale"] = quantize_kv(by_key[key])
            elif self.scfg.kv_mor:
                # One layer at a time, as one prefill chunk of the whole
                # prompt would write them (the reference hands the stacked
                # (n_units, 1, P, ...) leaf to quantize_kv_mor, which takes
                # 4-D rows and raises).
                per_layer = [quantize_kv_mor(x) for x in by_key[key]]
                for i, suffix in enumerate(("", "_tags", "_scale")):
                    by_key[key + suffix] = torch.stack(
                        [q[i] for q in per_layer])
        self.pool.splice(slot, by_key, len(req.prompt))
        self._start_decode(slot, req, len(req.prompt),
                           logits[0, -1].to(torch.float32).cpu().numpy())

    def _prefill_chunk_step(self, slot: int, req: Request):
        """Advance one prompt chunk for a prefilling slot (B=1)."""
        C = self.scfg.prefill_chunk
        start = int(self.slot_filled[slot])
        P = len(req.prompt)
        chunk = np.zeros(C, np.int32)
        real = min(C, P - start)
        chunk[:real] = np.asarray(req.prompt)[start:start + real]
        logits = self._step_fn(self.pool.table_rows([slot]), chunk[None],
                               np.asarray([start + C - 1], np.int32))
        self.prefill_chunks += 1
        self.slot_filled[slot] = start + real
        if start + real >= P:
            row = logits[0, real - 1].to(torch.float32).cpu().numpy()
            self._start_decode(slot, req, P, row)

    def _start_decode(self, slot: int, req: Request, P: int,
                      logits_row: np.ndarray):
        tok = self._sample(req, logits_row)
        req.out.append(tok)
        self.slot_pos[slot] = P
        self.slot_next[slot] = tok
        self.slot_state[slot] = "decode"
        if len(req.out) >= req.max_tokens:
            self._finish(slot)

    # ----------------------------------------------------------- decode --
    def _decode_batch(self, dec: List[int]):
        n = self.scfg.slots
        mask = np.zeros(n, bool)
        mask[dec] = True
        # Non-decoding slots ride along pointed at the trash page.
        bt = np.where(mask[:, None], self.pool.block_table,
                      self.pool.trash).astype(np.int64)
        toks = np.where(mask, self.slot_next, 0).astype(np.int32)[:, None]
        cur = np.where(mask, self.slot_pos, 0).astype(np.int32)
        logits = self._step_fn(torch.as_tensor(bt, device=self.device),
                               toks, cur)
        self.decode_steps += 1
        rows = logits[:, 0].to(torch.float32).cpu().numpy()
        for i in dec:
            r = self.slot_req[i]
            # Slot quarantine: a poisoned slot finishes early with the
            # condition surfaced instead of sampling garbage. The page
            # sweep runs first, so the error names the root cause (the
            # corrupted lane), also in pages the logits cannot see yet.
            if self.scfg.kv_guard:
                bad = self.pool.guard_check(i)
                if bad is not None:
                    self._quarantine(i, bad)
                    continue
            if not np.isfinite(rows[i][: self.cfg.vocab]).all():
                self._quarantine(
                    i, f"nonfinite logits at position "
                       f"{int(self.slot_pos[i])}")
                continue
            tok = self._sample(r, rows[i])
            r.out.append(tok)
            self.slot_pos[i] += 1
            self.slot_next[i] = tok
            if len(r.out) >= r.max_tokens or \
                    self.slot_pos[i] >= self.scfg.max_seq:
                self._finish(i)

    def _sample(self, req: Request, row: np.ndarray) -> int:
        V = self.cfg.vocab
        row = row[:V]
        if req.temperature <= 0.0:
            return int(row.argmax())
        rng = getattr(req, "_rng", None)
        if rng is None:
            rng = np.random.default_rng((req.seed, req.rid))
            req._rng = rng
        z = row.astype(np.float64) / req.temperature
        if req.top_k and req.top_k < V:
            kth = np.partition(z, -req.top_k)[-req.top_k]
            z = np.where(z >= kth, z, -np.inf)
        z -= z.max()
        p = np.exp(z)
        p /= p.sum()
        return int(rng.choice(V, p=p))

    def _quarantine(self, slot: int, reason: str):
        req = self.slot_req[slot]
        note = f"quarantined: {reason}"
        req.error = f"{req.error}; {note}" if req.error else note
        self.quarantined.append(req)
        self._finish(slot)

    def _finish(self, slot: int):
        self.slot_req[slot].done = True
        self.slot_req[slot] = None
        self.slot_state[slot] = "idle"
        self.slot_pos[slot] = 0
        self.slot_next[slot] = 0
        self.slot_filled[slot] = 0
        self.pool.release(slot)
        self._sealed = {(s, j) for s, j in self._sealed if s != slot}

    # --------------------------------------------------- MoR cold tier --
    def _seal_cold_pages(self):
        """Sub4-recompress the pages a decoding slot's write frontier has
        left at least ``kv_mor_cold`` positions behind. A sealed page is
        not written again while owned (positions only grow); the set
        forgets a slot's pages when they are released."""
        lag = self.scfg.kv_mor_cold
        ps = self.pool.page_size
        cold: List[int] = []
        for i in range(self.scfg.slots):
            if self.slot_state[i] != "decode":
                continue
            frontier = int(self.slot_pos[i])
            for j, page in enumerate(self.pool.block_table[i]):
                if page == self.pool.trash or (i, j) in self._sealed:
                    continue
                if (j + 1) * ps + lag <= frontier:
                    cold.append(int(page))
                    self._sealed.add((i, j))
        if cold:
            self.pool.recompress_pages(cold)

    def kv_cache_stats(self):
        """Tag census and bytes per element of the live cache (kv_mor)."""
        return self.pool.kv_cache_stats()

    # ------------------------------------------------------------- loop --
    def step(self) -> bool:
        """One scheduler tick; False once nothing is queued or in flight."""
        self._admit()
        worked = False
        for i in range(self.scfg.slots):
            if self.slot_state[i] == "prefill":
                self._prefill_chunk_step(i, self.slot_req[i])
                worked = True
        dec = [i for i in range(self.scfg.slots)
               if self.slot_state[i] == "decode"]
        if dec:
            self._decode_batch(dec)
            worked = True
        if worked and self.scfg.kv_mor_cold is not None:
            self._seal_cold_pages()
        if worked:
            self.steps += 1
        return worked or bool(self.queue)

    def run_to_completion(self, max_steps: int = 1024) -> int:
        """Drive steps until drained (or ``max_steps``); requests still in
        flight at exhaustion get ``error`` set and land on
        ``self.unfinished``."""
        steps = 0
        while (self.queue or any(self.slot_req)) and steps < max_steps:
            self.step()
            steps += 1
        self.unfinished = list(self.queue) + [
            r for r in self.slot_req if r is not None]
        for r in self.unfinished:
            note = f"unfinished after {max_steps} engine steps"
            r.error = f"{r.error}; {note}" if r.error else note
        return steps
