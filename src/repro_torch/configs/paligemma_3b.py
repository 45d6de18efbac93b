"""paligemma-3b: SigLIP stub (precomputed patch embeddings) + gemma
backbone; image prefix attends bidirectionally. [arXiv:2407.07726; hf]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv=1, head_dim=256,
    d_ff=16384, vocab=257216, unit=("dense",), act="geglu",
    rope_theta=10000.0, img_tokens=256, tie_embed=True,
))
