"""nemotron3-8b: the paper's experiment model (dense, squared-ReLU MLP,
MHA). [NGC nemotron-3-8b]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="nemotron3-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv=32, head_dim=128,
    d_ff=16384, vocab=256000, unit=("dense",), act="relu2",
    rope_theta=10000.0,
))
