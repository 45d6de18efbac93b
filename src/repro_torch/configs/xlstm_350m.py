"""xlstm-350m: alternating mLSTM + sLSTM blocks. [arXiv:2405.04517; unverified]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv=4, head_dim=256,
    d_ff=0, vocab=50304, unit=("mlstm", "slstm"), act="gelu",
    subquadratic=True, tie_embed=True,
))
