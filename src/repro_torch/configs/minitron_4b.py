"""minitron-4b: pruned Nemotron (squared-ReLU MLP). [arXiv:2407.14679; hf]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="minitron-4b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv=8, head_dim=128,
    d_ff=9216, vocab=256000, unit=("dense",), act="relu2",
    rope_theta=10000.0,
))
