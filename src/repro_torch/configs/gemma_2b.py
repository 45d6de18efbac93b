"""gemma-2b: GeGLU, head_dim=256, MQA, tied head. [arXiv:2403.08295; hf]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="gemma-2b", family="dense",
    n_layers=18, d_model=2048, n_heads=8, n_kv=1, head_dim=256,
    d_ff=16384, vocab=256000, unit=("dense",), act="geglu",
    rope_theta=10000.0, tie_embed=True,
))
