"""The training loop (port of ``repro.train.trainer`` without
checkpointing): synthetic batches by step, the train step, a straggler
watchdog and the MoR statistics streamed into :class:`MoRStatsTracker`.
Checkpoint/restart and SIGTERM handling are not ported yet; a
``ckpt_dir``, or a ``ckpt_every`` / ``keep`` other than the reference's
defaults, raises.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.mor import (STAT_FRAC_BF16, STAT_GROUP_MANTISSA,
                                  STAT_REL_ERR, STATS_WIDTH)
from repro_torch.core.policy import MoRDotPolicy
from repro_torch.core.stats import MoRStatsTracker
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models.api import init_params
from repro_torch.models.transformer import resolve_device
from repro_torch.optim.adamw import init_opt_state

from .train_step import TrainConfig, make_train_step

__all__ = ["TrainerConfig", "Trainer"]


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    # Checkpointing is not ported: a ckpt_dir raises, and so do
    # ckpt_every / keep away from these (the reference's) defaults.
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    keep: int = 3
    log_every: int = 10  # read by nothing, as in the reference
    straggler_factor: float = 3.0
    seed: int = 0


class Trainer:
    """Runs ``total_steps`` train steps from random parameters made from
    ``run_cfg.seed`` on ``device`` (CUDA unless the caller asks for the
    CPU)."""

    def __init__(self, cfg: ArchConfig, policy: MoRDotPolicy,
                 tcfg: TrainConfig, run_cfg: TrainerConfig,
                 data_cfg: Optional[DataConfig] = None,
                 straggler_cb: Optional[Callable[[int, float], None]] = None,
                 device="cuda"):
        if (run_cfg.ckpt_dir or run_cfg.ckpt_every != 50
                or run_cfg.keep != 3):
            raise NotImplementedError(
                "checkpoint/restart is not ported yet "
                "(repro.checkpoint.ckpt)")
        self.cfg = cfg
        self.policy = policy
        self.run_cfg = run_cfg
        self.device = resolve_device(device)
        self.data_cfg = data_cfg or DataConfig(
            vocab=cfg.vocab, seq_len=256, global_batch=8, seed=run_cfg.seed)
        self.step_fn = make_train_step(cfg, policy, tcfg)
        self.tracker = MoRStatsTracker()
        self.straggler_cb = straggler_cb or (lambda step, t: None)
        self.history: list = []

    def run(self) -> Dict[str, Any]:
        params = init_params(self.cfg, seed=self.run_cfg.seed,
                             device=self.device)
        opt_state = init_opt_state(params)
        data = SyntheticLM(dataclasses.replace(self.data_cfg,
                                               seed=self.run_cfg.seed))
        times: deque = deque(maxlen=32)
        step = 0
        for step in range(self.run_cfg.total_steps):
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
        return {"params": params, "opt_state": opt_state,
                "history": self.history, "final_step": step + 1}
