"""Architecture configs and input shapes (port of
``repro.configs.base``).

Every architecture is a frozen :class:`ArchConfig`; the registry maps
names to configs and ``reduced()`` produces the CPU-test downscale of
the same family. ``input_specs`` gives every model input of a cell as
``{name: (shape, torch dtype)}``, the convention of
``models.cache_specs``.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Tuple

import torch

__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "register", "get_config",
           "list_archs", "reduced", "input_specs", "cell_is_runnable"]


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


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

    @property
    def mamba_d_inner(self) -> int:
        return self.d_inner or 2 * self.d_model

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), every
        family (the reference's arithmetic)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        hq, hkv, hd = self.n_heads, self.n_kv, self.head_dim
        attn = d * (hq + 2 * hkv) * hd + hq * hd * d
        gated = self.act in ("swiglu", "geglu")
        mlp = d * f * (3 if gated else 2)
        di = self.mamba_d_inner
        per_type = {
            "dense": attn + mlp,
            "moe": attn + self.n_experts * d * f * (3 if gated else 2)
            + d * self.n_experts,
            "hymba": (attn + mlp + 2 * d * di + di * d
                      + di * (2 * self.ssm_state + 2)
                      + di * self.conv_width),
            "mlstm": 2 * d * (2 * d) + (2 * d) * d + 3 * d,
            "slstm": 8 * d * d // max(self.n_heads, 1) * self.n_heads,
        }
        total = 0
        for t in self.unit:
            total += per_type.get(t, per_type["dense"]) * self.n_units
        total += v * d * (1 if self.tie_embed else 2)
        total += self.enc_layers * (attn + mlp)
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if self.n_experts == 0:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        per_expert = d * f * (3 if self.act in ("swiglu", "geglu") else 2)
        return self.param_count() - (
            (self.n_experts - self.top_k) * per_expert) * self.n_units


_REGISTRY: Dict[str, ArchConfig] = {}

# Every config of the reference's registry.
_ARCH_MODULES = ["llama3_8b", "nemotron3_8b", "minitron_4b",
                 "deepseek_coder_33b", "gemma_2b", "granite_moe_1b_a400m",
                 "moonshot_v1_16b_a3b", "paligemma_3b", "whisper_tiny",
                 "hymba_1_5b", "xlstm_350m"]


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


def cell_is_runnable(cfg: ArchConfig,
                     shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether (arch x shape) is a defined cell."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "long_500k needs sub-quadratic attention (skip noted)"
    return True, ""


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


def _frontend_specs(cfg: ArchConfig, batch: int):
    """The stub modality frontends' inputs (precomputed embeddings)."""
    extras = {}
    if cfg.family == "audio":
        extras["frames"] = ((batch, cfg.enc_seq, cfg.d_model),
                            torch.bfloat16)
    if cfg.family == "vlm":
        extras["patches"] = ((batch, cfg.img_tokens, cfg.d_model),
                             torch.bfloat16)
    return extras


def input_specs(cfg: ArchConfig, shape: ShapeConfig):
    """{name: (shape, dtype)} of every model input of this cell.

    train   -> tokens, labels, frontends
    prefill -> tokens, frontends
    decode  -> token (B, 1) and cur_index (B,), one position per slot;
               the cache's specs come from ``models.cache_specs``.
    """
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return {"tokens": ((b, s), torch.int32),
                "labels": ((b, s), torch.int32),
                **_frontend_specs(cfg, b)}
    if shape.kind == "prefill":
        return {"tokens": ((b, s), torch.int32), **_frontend_specs(cfg, b)}
    if shape.kind == "decode":
        return {"token": ((b, 1), torch.int32),
                "cur_index": ((b,), torch.int32)}
    raise ValueError(shape.kind)
