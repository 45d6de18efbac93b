"""granite-3.0-1b-a400m: 32-expert top-8 MoE, tied head.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv=8, head_dim=64,
    d_ff=512, vocab=49155, unit=("moe",), act="swiglu",
    n_experts=32, top_k=8, rope_theta=10000.0, tie_embed=True,
))
