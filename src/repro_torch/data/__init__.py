"""Deterministic synthetic data of the port."""
from .pipeline import DataConfig, SyntheticLM, prefetch

__all__ = ["DataConfig", "SyntheticLM", "prefetch"]
