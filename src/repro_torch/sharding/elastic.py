"""Elastic re-mesh: resume a checkpoint onto another set of ranks (port of
``repro.sharding.elastic``).

After a rank is lost the healthy set changes; this module builds a
(possibly smaller) ('data', 'model') mesh over the ranks that remain,
re-derives the sharding specs for it and gives each rank its blocks of
the restored tree. The checkpoint holds whole arrays, so any (data',
model') grid will do: a dimension that the new mesh's axes no longer
divide is replicated instead.

The reference puts whole host arrays on the new mesh with
``device_put``; here each rank keeps only its blocks
(``rules.NamedSharding``), and :func:`elastic_restore` reads them leaf by
leaf through ``Checkpointer.restore(shardings=)``, so no rank holds the
whole tree. Every rank of the world calls :func:`make_elastic_mesh`
(each creates every process group); a rank outside the mesh gets None.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

from repro_torch.configs.base import ArchConfig
from repro_torch.core.collectives import make_mesh

from . import rules
from .rules import NamedSharding, P

__all__ = ["best_mesh_shape", "make_elastic_mesh", "reshard_tree",
           "elastic_restore"]


def best_mesh_shape(n_ranks: int, prefer_model: int = 16) -> Tuple[int, int]:
    """The (data, model) grid with model = min(prefer_model, n_ranks) and
    as many data rows as tile the healthy rank count (the remainder
    ranks are dropped)."""
    model = min(prefer_model, n_ranks)
    return max(n_ranks // model, 1), model


def make_elastic_mesh(ranks: Optional[Sequence[int]] = None,
                      prefer_model: int = 16, device="cuda"):
    """A ('data', 'model') mesh of :func:`best_mesh_shape` over the first
    data * model of ``ranks`` (the whole world by default); None on a
    rank outside it."""
    import torch.distributed as dist

    if ranks is None:
        ranks = range(dist.get_world_size() if dist.is_initialized() else 1)
    ranks = list(ranks)
    data, model = best_mesh_shape(len(ranks), prefer_model)
    return make_mesh((data, model), ("data", "model"), device=device,
                     ranks=ranks[:data * model])


def demoted_spec(spec, shape, mesh) -> P:
    """``spec`` for a leaf of ``shape`` on ``mesh``: an entry whose axes'
    product does not divide its dimension becomes None (replicated), and
    an axis the mesh lacks counts as size 1 and is left out."""
    sizes = mesh.axis_sizes
    entries = list(spec) + [None] * (len(shape) - len(spec))
    fixed = []
    for dim, e in zip(shape, entries):
        names = () if e is None else (e if isinstance(e, tuple) else (e,))
        kept = tuple(n for n in names if n in sizes)
        size = 1
        for n in kept:
            size *= sizes[n]
        if not kept or dim % size:
            fixed.append(None)
        else:
            fixed.append(kept if isinstance(e, tuple) else kept[0])
    return P(*fixed)


def _fix_specs(tree, spec_tree, mesh):
    if isinstance(tree, dict):
        return {k: _fix_specs(v, spec_tree[k], mesh)
                for k, v in tree.items()}
    return demoted_spec(spec_tree, tuple(tree.shape), mesh)


def reshard_tree(tree, spec_tree, mesh):
    """This rank's blocks of every leaf of ``tree`` under ``spec_tree`` on
    ``mesh``, on the mesh's device, the specs demoted where the mesh no
    longer divides a dimension (:func:`demoted_spec`)."""
    return rules._map2(lambda t, s: NamedSharding(mesh, s).shard(t), tree,
                       _fix_specs(tree, spec_tree, mesh))


def elastic_restore(ckpt, step: int, target, cfg: ArchConfig,
                    ranks: Optional[Sequence[int]] = None, device="cuda"):
    """Checkpoint -> the elastic mesh over ``ranks`` (``prefer_model``
    16) -> this rank's blocks of every leaf, read one leaf at a time.
    ``target`` gives the params tree's structure, shapes and dtypes.
    Returns (tree, mesh); (None, None) on a rank outside the mesh."""
    mesh = make_elastic_mesh(ranks, device=device)
    if mesh is None:
        return None, None
    specs = _fix_specs(target, rules.param_specs(cfg, target), mesh)
    shardings = rules._map2(lambda s, _: NamedSharding(mesh, s), specs,
                            target)
    return ckpt.restore(step, target, shardings=shardings), mesh
