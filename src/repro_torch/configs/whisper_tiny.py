"""whisper-tiny: enc-dec; conv frontend is a stub (input_specs provides
precomputed frame embeddings). [arXiv:2212.04356; unverified]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="whisper-tiny", family="audio",
    n_layers=4, d_model=384, n_heads=6, n_kv=6, head_dim=64,
    d_ff=1536, vocab=51865, unit=("dense",), act="gelu", norm="ln",
    enc_layers=4, enc_seq=1500, tie_embed=True,
))
