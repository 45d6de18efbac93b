"""Sharding rules of the port (``repro.sharding``): partition specs for
every tree, each rank's pieces of a tree under them, and the elastic
re-mesh onto whatever ranks remain."""
from . import elastic, rules
from .elastic import (
    best_mesh_shape,
    elastic_restore,
    make_elastic_mesh,
    reshard_tree,
)
from .rules import (
    NamedSharding,
    P,
    PartitionSpec,
    local_mixed,
    local_shards,
    mixed_operand_pspec,
    qtensor_pspec_from_dense,
    quantized_param_specs,
)

__all__ = [
    "elastic",
    "rules",
    "best_mesh_shape",
    "elastic_restore",
    "make_elastic_mesh",
    "reshard_tree",
    "NamedSharding",
    "P",
    "PartitionSpec",
    "local_mixed",
    "local_shards",
    "mixed_operand_pspec",
    "qtensor_pspec_from_dense",
    "quantized_param_specs",
]
