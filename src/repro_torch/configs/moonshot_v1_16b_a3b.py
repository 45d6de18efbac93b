"""moonshot-v1-16b-a3b (Moonlight-16B-A3B): 64-expert top-6 MoE.
[hf:moonshotai/Moonlight-16B-A3B; hf]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv=16, head_dim=128,
    d_ff=1408, vocab=163840, unit=("moe",), act="swiglu",
    n_experts=64, top_k=6, rope_theta=50000.0,
))
