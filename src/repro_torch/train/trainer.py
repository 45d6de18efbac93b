"""The training loop (port of ``repro.train.trainer``): synthetic
batches by step, the train step, a straggler watchdog, the MoR
statistics streamed into :class:`MoRStatsTracker`, and checkpoint/restart
(``repro_torch.checkpoint``): with a ``ckpt_dir`` a run resumes from the
latest checkpoint bit-identically (the data is a pure function of the
step and the steps draw no random numbers), saves every ``ckpt_every``
steps, keeps the newest ``keep``, and on SIGTERM (a handler installed
from the main thread only) saves synchronously and stops.

A run saves its state once under the number of steps it has taken. The
reference also saves a preempted run's state a second time under
``total_steps``, so a restart resumes from ``total_steps`` and never
takes the steps the preemption cut; the port does not. The reference
also restores the params into ``init_params``' dtypes (f32 norm scales),
where the port restores them in the bf16 a train step leaves them, so
that a resumed run is bit-identical to the unbroken one (ROADMAP,
settled divergences).
"""
from __future__ import annotations

import dataclasses
import signal
import time
from collections import deque
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import Checkpointer, latest_step
from repro_torch.configs.base import ArchConfig
from repro_torch.core.mor import (STAT_FRAC_BF16, STAT_GROUP_MANTISSA,
                                  STAT_REL_ERR, STATS_WIDTH)
from repro_torch.core.policy import MoRDotPolicy
from repro_torch.core.stats import MoRStatsTracker
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models.api import init_params
from repro_torch.models.transformer import resolve_device
from repro_torch.optim.adamw import init_opt_state, tree_map

from .train_step import TrainConfig, make_train_step

__all__ = ["TrainerConfig", "Trainer"]


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    keep: int = 3
    log_every: int = 10  # read by nothing, as in the reference
    straggler_factor: float = 3.0
    seed: int = 0


class Trainer:
    """Runs train steps up to ``total_steps`` on ``device`` (CUDA unless
    the caller asks for the CPU), from random parameters made from
    ``run_cfg.seed`` or from the latest checkpoint in ``ckpt_dir``."""

    def __init__(self, cfg: ArchConfig, policy: MoRDotPolicy,
                 tcfg: TrainConfig, run_cfg: TrainerConfig,
                 data_cfg: Optional[DataConfig] = None,
                 straggler_cb: Optional[Callable[[int, float], None]] = None,
                 device="cuda"):
        self.cfg = cfg
        self.policy = policy
        self.run_cfg = run_cfg
        self.device = resolve_device(device)
        self.data_cfg = data_cfg or DataConfig(
            vocab=cfg.vocab, seq_len=256, global_batch=8, seed=run_cfg.seed)
        self.step_fn = make_train_step(cfg, policy, tcfg)
        self.tracker = MoRStatsTracker()
        self.ckpt = (Checkpointer(run_cfg.ckpt_dir, keep=run_cfg.keep)
                     if run_cfg.ckpt_dir else None)
        self.straggler_cb = straggler_cb or (lambda step, t: None)
        self._preempted = False
        self.history: list = []

    def _install_sigterm(self):
        """Install the preemption handler; returns the handler it replaced
        (None off the main thread, where none can be installed, or where
        the old one was not installed from Python and cannot be put
        back)."""
        def handler(signum, frame):
            self._preempted = True

        try:
            return signal.signal(signal.SIGTERM, handler)
        except ValueError:
            return None  # not the main thread

    def run(self) -> Dict[str, Any]:
        old = self._install_sigterm()
        try:
            return self._run()
        finally:
            if old is not None:
                signal.signal(signal.SIGTERM, old)

    def _run(self) -> Dict[str, Any]:
        params = init_params(self.cfg, seed=self.run_cfg.seed,
                             device=self.device)
        opt_state = init_opt_state(params)
        start, saved = 0, None
        if self.ckpt is not None:
            last = latest_step(self.run_cfg.ckpt_dir)
            if last is not None:
                # The params in the dtype a train step leaves them (AdamW
                # returns bf16 leaves; init_params makes the norm scales
                # f32): restored into init's dtypes, the resumed run would
                # differ from the unbroken one.
                like = tree_map(lambda p: p.to(torch.bfloat16), params)
                params, opt_state = self.ckpt.restore(last,
                                                      (like, opt_state))
                start = saved = last
        data = SyntheticLM(dataclasses.replace(self.data_cfg,
                                               seed=self.run_cfg.seed))
        times: deque = deque(maxlen=32)
        reached = start
        for step in range(start, self.run_cfg.total_steps):
            batch = {k: torch.from_numpy(v.astype(np.int64)).to(self.device)
                     for k, v in data.batch_at(step).items()}
            t0 = time.time()
            params, opt_state, metrics = self.step_fn(params, opt_state,
                                                      batch)
            loss = float(metrics["loss"])  # synchronizes: the step barrier
            dt = time.time() - t0
            if len(times) >= 8:
                med = float(np.median(times))
                if dt > self.run_cfg.straggler_factor * med:
                    self.straggler_cb(step, dt / med)
            times.append(dt)
            self.history.append(
                {"step": step, "loss": loss, "dt": dt,
                 "fwd_bf16": float(metrics.get("fwd_frac_bf16", 0.0)),
                 "bwd_bf16": float(metrics.get("bwd_frac_bf16", 0.0))})
            row = np.zeros(STATS_WIDTH, np.float64)
            row[STAT_REL_ERR] = float(metrics.get("fwd_rel_err", 0.0))
            row[STAT_FRAC_BF16] = float(metrics.get("fwd_frac_bf16", 0.0))
            row[STAT_GROUP_MANTISSA] = 1.0
            self.tracker.update({"global": row}, step)
            reached = step + 1
            if self.ckpt and (reached % self.run_cfg.ckpt_every == 0
                              or self._preempted):
                self.ckpt.save(reached, (params, opt_state))
                saved = reached
                if self._preempted:
                    break
        # The state is saved once, under the steps it has taken.
        if self.ckpt:
            if saved != reached:
                self.ckpt.save(reached, (params, opt_state))
            self.ckpt.wait()
        return {"params": params, "opt_state": opt_state,
                "history": self.history, "final_step": reached}
