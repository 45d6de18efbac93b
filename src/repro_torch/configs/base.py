"""Architecture configs (port of ``repro.configs.base``).

Every architecture is a frozen :class:`ArchConfig`; the registry maps
names to configs and ``reduced()`` produces the CPU-test downscale of
the same family. The JAX module's ShapeDtypeStruct input specs are not
ported yet.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Tuple

__all__ = ["ArchConfig", "register", "get_config", "list_archs", "reduced"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # 'dense' | 'moe' | 'audio' | 'ssm' | 'vlm' | 'hybrid'
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    d_ff: int
    vocab: int
    # Repeating unit of layer types; the stack is unit * n_units.
    unit: Tuple[str, ...] = ("dense",)
    act: str = "swiglu"  # 'swiglu' | 'geglu' | 'gelu' | 'relu2'
    norm: str = "rms"  # 'rms' | 'ln'
    rope_theta: float = 10000.0
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    ssm_state: int = 0
    d_inner: int = 0
    conv_width: int = 4
    enc_layers: int = 0
    enc_seq: int = 0
    img_tokens: int = 0
    window: int = 0
    tie_embed: bool = False
    subquadratic: bool = False
    dtype: str = "bfloat16"

    @property
    def n_units(self) -> int:
        return self.n_layers // len(self.unit)


_REGISTRY: Dict[str, ArchConfig] = {}

# Configs ported so far (the dense family's); the JAX registry holds
# eleven.
_ARCH_MODULES = ["llama3_8b", "nemotron3_8b", "minitron_4b",
                 "deepseek_coder_33b"]


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def _ensure_loaded() -> None:
    for mod in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str) -> ArchConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown or unported arch {name!r}; ported: {list_archs()}"
        )
    return _REGISTRY[name]


def list_archs():
    _ensure_loaded()
    return sorted(_REGISTRY)


def reduced(cfg: ArchConfig) -> ArchConfig:
    """CPU-test downscale preserving the family's structure (same
    numbers as the JAX ``reduced``)."""
    kv = 1 if cfg.n_kv == 1 else 2
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-reduced",
        n_layers=2 * len(cfg.unit) if len(cfg.unit) > 1 else 2,
        d_model=64,
        n_heads=4,
        n_kv=kv,
        head_dim=16,
        d_ff=0 if cfg.d_ff == 0 else 96,
        vocab=512,
        n_experts=min(cfg.n_experts, 4),
        top_k=min(cfg.top_k, 2),
        ssm_state=min(cfg.ssm_state, 8) if cfg.ssm_state else 0,
        d_inner=128 if cfg.family in ("hybrid",) else 0,
        enc_layers=min(cfg.enc_layers, 2),
        enc_seq=min(cfg.enc_seq, 16) if cfg.enc_seq else 0,
        img_tokens=min(cfg.img_tokens, 8) if cfg.img_tokens else 0,
        window=min(cfg.window, 8) if cfg.window else 0,
    )
