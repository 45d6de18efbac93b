"""llama3-8b: GQA, 128k vocab, untied head. [arXiv:2407.21783]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="llama3-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv=8, head_dim=128,
    d_ff=14336, vocab=128256, unit=("dense",), act="swiglu",
    rope_theta=500000.0,
))
