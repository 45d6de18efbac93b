"""Public model API (port of the decode builder of ``repro.models.api``)."""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.core.policy import MoRDotPolicy

from . import transformer as T

__all__ = ["make_decode_fn", "init_params", "cache_specs", "init_cache"]

init_params = T.init_params
cache_specs = T.cache_specs
init_cache = T.init_cache


def make_decode_fn(cfg: ArchConfig, policy: MoRDotPolicy):
    """decode_fn(params, cache, token, cur_index) -> (logits, cache,
    stats). ``token`` is (B, S): S == 1 for a decode step, S > 1 for a
    prefill chunk written into the cache; ``cur_index`` is the position
    of the last incoming token, scalar or per row (B,). The reference's
    stats-token argument has no counterpart (no backward in serving)."""

    def decode_fn(params, cache, token, cur_index):
        return T.forward(cfg, policy, params, {"token": token},
                         mode="decode", cache=cache, cur_index=cur_index)

    return decode_fn
