"""Checkpoint/restart (port of ``repro.checkpoint``)."""
from .ckpt import Checkpointer, latest_step

__all__ = ["Checkpointer", "latest_step"]
