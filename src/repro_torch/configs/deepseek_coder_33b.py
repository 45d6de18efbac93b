"""deepseek-coder-33b: llama-arch dense. [arXiv:2401.14196; hf]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="deepseek-coder-33b", family="dense",
    n_layers=62, d_model=7168, n_heads=56, n_kv=8, head_dim=128,
    d_ff=19200, vocab=32256, unit=("dense",), act="swiglu",
    rope_theta=100000.0,
))
