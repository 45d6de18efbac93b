"""Sharding rules of the port (``repro.sharding``): partition specs for
every tree, and each rank's pieces of a tree under them."""
from . import rules
from .rules import (
    P,
    PartitionSpec,
    local_mixed,
    local_shards,
    mixed_operand_pspec,
    qtensor_pspec_from_dense,
    quantized_param_specs,
)

__all__ = [
    "rules",
    "P",
    "PartitionSpec",
    "local_mixed",
    "local_shards",
    "mixed_operand_pspec",
    "qtensor_pspec_from_dense",
    "quantized_param_specs",
]
