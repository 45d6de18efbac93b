"""hymba-1.5b: parallel attention + mamba heads per layer, ssm_state=16;
sliding-window attention for the long-context shape. [arXiv:2411.13676; hf]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv=5, head_dim=64,
    d_ff=5504, vocab=32001, unit=("hymba",), act="swiglu",
    ssm_state=16, d_inner=3200, window=2048, subquadratic=True,
))
