"""Axis-gated collectives for mesh-aware MoR statistics (port of
``repro.core.collectives``).

The MoR decision metrics (group amax, Eq. 3 error sums, the Eq. 2
global accept ratio, the stats-vector fractions) are *tensor-global*
quantities. When each process quantizes only its shard of an operand,
every global aggregate must be reduced over the sharded mesh axes
before any decision consumes it; otherwise per-shard recipes diverge
from the single-device choice (docs/sharding.md).

``MoRPolicy.mesh_axes`` names those axes; these helpers are the identity
when the tuple is empty, so the single-device path is the pre-mesh code.

The reference runs one program over all shards inside ``shard_map``,
which binds the axis names; here one process runs per shard
(``torch.distributed``, one rank each) and runs its own shard's code, so
``compat_shard_map`` has no counterpart. :func:`make_mesh` lays named
axes over the default process group's ranks, or over a given list of
them, in row-major order (as ``jax.make_mesh(shape, names)`` and
``Mesh(np.asarray(devices[:k]).reshape(shape), names)`` order devices)
and :func:`use_mesh` binds them for a body of code. A named axis that
no bound mesh has raises a ``ValueError`` naming it, as the reference
fails at trace time on an unbound axis name.

Every reduction gathers the participants' values and reduces them in
rank order on each rank: the result is the same on every rank and does
not depend on the backend's reduction order. ``pmax_over`` propagates a
NaN from any rank, as ``torch.amax`` does on one device. This is a
settled divergence from the reference, whose ``lax.pmax`` on the CPU
drops a NaN (ROADMAP Queue 3); gloo's own ``MAX`` gives an
order-dependent finite value, so it is not used. The reductions read
copies of the caller's tensors and record no autograd history: the
decision statistics are not differentiated. A gather ships every dtype
bit for bit (NaN payloads and -0.0 included); fp8, which gloo lacks,
crosses as its bytes.

:class:`Mesh` is a small class over ``dist.new_group`` rather than
``torch.distributed.device_mesh.DeviceMesh``: a reduction over several
named axes needs one group for their product, which ``DeviceMesh``
offers only through a private method.
"""
from __future__ import annotations

import contextlib
import itertools
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Mesh", "make_mesh", "use_mesh", "bound_mesh", "psum_over",
           "pmax_over", "all_gather_over", "global_size", "COLLECTIVES"]

# Meshes bound by use_mesh, innermost last. Process-wide on purpose: a
# backward on CUDA tensors runs on the autograd engine's own thread,
# which a thread-local binding would not reach.
_BOUND: List["Mesh"] = []

# Collectives issued (a reduction over a one-rank group counts none), the
# host seconds spent in them, and the bytes this rank contributed to them
# and received from the other ranks; chip_smoke.py reads them.
COLLECTIVES = {"calls": 0, "host_s": 0.0, "bytes_out": 0, "bytes_in": 0}

# Dtypes gloo cannot carry, shipped as the unsigned integers of their
# width.
_WIRE = {torch.float8_e4m3fn: torch.uint8, torch.float8_e5m2: torch.uint8}


class Mesh:
    """Named axes over ``ranks`` of the default process group: the i-th of
    them sits at ``np.unravel_index(i, shape)`` (row-major). Holds one
    process group per non-empty set of axes, so a reduction over
    ``('pod', 'data')`` is one collective over their product, whatever
    the order of the names."""

    def __init__(self, shape: Tuple[int, ...], names: Tuple[str, ...],
                 device, rank: int, groups: Dict[Tuple[int, ...], tuple],
                 ranks: Optional[Tuple[int, ...]] = None):
        self.shape = tuple(shape)
        self.names = tuple(names)
        self.device = torch.device(device)
        self.rank = rank
        # The process group's ranks in mesh order.
        self.ranks = tuple(range(int(np.prod(self.shape)))) \
            if ranks is None else tuple(ranks)
        # axis indices -> (process group or None for one rank, its size)
        self._groups = groups

    def group(self, axes: Sequence[str]):
        """(process group or None, size) of this rank's group over
        ``axes``."""
        return self._groups[tuple(sorted({self.names.index(a)
                                          for a in axes}))]

    @property
    def axis_sizes(self) -> Dict[str, int]:
        """{axis name: size}, as ``jax.sharding.Mesh.shape`` reads."""
        return dict(zip(self.names, self.shape))

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return int(np.unravel_index(self.ranks.index(self.rank),
                                    self.shape)[self.names.index(axis)])

    def __repr__(self):
        return (f"Mesh({dict(zip(self.names, self.shape))}, rank "
                f"{self.rank}, device {self.device})")


def make_mesh(shape: Sequence[int], names: Sequence[str],
              device="cuda", ranks: Optional[Sequence[int]] = None
              ) -> Optional[Mesh]:
    """A mesh of ``shape`` with axis ``names`` over ``ranks`` of the
    default process group (initialised by the caller, e.g.
    ``repro_torch.launch.ranks.init_world``; all of its ranks, in order,
    by default), its tensors on ``device``. Every rank of the process
    group must call it, with the same arguments: each rank creates every
    group, in the same order. A rank outside ``ranks`` gets None. Without
    a process group the one-rank mesh of this process is made (a shape of
    one rank)."""
    import torch.distributed as dist

    shape, names = tuple(int(s) for s in shape), tuple(names)
    if len(shape) != len(names) or len(set(names)) != len(names):
        raise ValueError(f"mesh shape {shape} and names {names} must "
                         f"pair up, names distinct")
    grouped = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if grouped else 1
    n = int(np.prod(shape))
    if ranks is None:
        if n != world:
            raise ValueError(f"mesh shape {shape} has {n} ranks, the "
                             f"process group {world}")
        ranks = range(world)
    ranks = tuple(int(r) for r in ranks)
    if len(ranks) != n or len(set(ranks)) != n or not all(
            0 <= r < world for r in ranks):
        raise ValueError(f"mesh shape {shape} has {n} ranks; {ranks} are "
                         f"not {n} distinct ranks of the process group "
                         f"({world})")
    rank = dist.get_rank() if grouped else 0
    ids = np.asarray(ranks).reshape(shape)
    groups = {}
    for k in range(1, len(shape) + 1):
        for sub in itertools.combinations(range(len(shape)), k):
            rest = [a for a in range(len(shape)) if a not in sub]
            # Ranks that differ only along `sub`: one group each.
            blocks = np.moveaxis(ids, rest, list(range(len(rest))))
            blocks = blocks.reshape(-1, int(np.prod([shape[a]
                                                     for a in sub])))
            for members in blocks.tolist():
                size = len(members)
                g = dist.new_group(members) if size > 1 else None
                if rank in members:
                    groups[sub] = (g, size)
    if rank not in ranks:
        return None
    return Mesh(shape, names, device, rank, groups, ranks)


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    """Bind ``mesh``'s axis names for the body (``shard_map``'s binding
    in the reference)."""
    _BOUND.append(mesh)
    try:
        yield mesh
    finally:
        _BOUND.pop()


def bound_mesh(axes: Sequence[str] = ()) -> Optional[Mesh]:
    """The innermost mesh bound by :func:`use_mesh`, or None; a named
    axis in ``axes`` that it lacks raises a ``ValueError`` naming it."""
    mesh = _BOUND[-1] if _BOUND else None
    for a in axes:
        if mesh is None or a not in mesh.names:
            raise ValueError(
                f"unbound mesh axis name {a!r}: no mesh bound by "
                f"use_mesh has it (bound: "
                f"{None if mesh is None else mesh.names})")
    return mesh


def _group_of(axes: Sequence[str]):
    return bound_mesh(axes).group(axes)


def _gather(x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
    """(n, *x.shape): the values of the n ranks of this rank's group over
    ``axes``, in rank order, on x's device, bit for bit."""
    import torch.distributed as dist

    group, n = _group_of(axes)
    t = x.detach().contiguous()
    if n == 1:
        return t[None].clone()
    t0 = time.perf_counter()
    wire = t.view(_WIRE[t.dtype]) if t.dtype in _WIRE else t
    parts = [torch.empty_like(wire) for _ in range(n)]
    dist.all_gather(parts, wire, group=group)
    out = torch.stack(parts).view(t.dtype)
    nbytes = wire.numel() * wire.element_size()
    COLLECTIVES["calls"] += 1
    COLLECTIVES["host_s"] += time.perf_counter() - t0
    COLLECTIVES["bytes_out"] += nbytes
    COLLECTIVES["bytes_in"] += (n - 1) * nbytes
    return out


def psum_over(x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
    """Sum over the mesh ``axes`` when non-empty, identity otherwise."""
    if not axes:
        return x
    return _gather(x, axes).sum(dim=0)


def pmax_over(x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
    """Max over the mesh ``axes`` when non-empty, identity otherwise; a
    NaN on any rank gives NaN on every rank (``torch.amax``)."""
    if not axes:
        return x
    return torch.amax(_gather(x, axes), dim=0)


def all_gather_over(x: torch.Tensor, axis: Optional[str]) -> torch.Tensor:
    """The values of every rank along ``axis`` stacked on a new leading
    axis, in the axis' order; without an axis the single-participant
    stack ``x[None]``."""
    if axis is None:
        return x[None]
    return _gather(x, (axis,))


def global_size(local_size: int, axes: Sequence[str]) -> torch.Tensor:
    """Global element count (f32) of a sharded operand: the sum of the
    local counts. For a *replicated* operand this over-counts by the axis
    product -- harmless for MoR because every consumer is a ratio of two
    sums (docs/sharding.md, 'replication safety'). On the bound mesh's
    device, or the CPU where no mesh is bound."""
    mesh = bound_mesh(axes)  # an unbound name raises here
    n = torch.full((), float(local_size), dtype=torch.float32,
                   device=None if mesh is None else mesh.device)
    return psum_over(n, axes)
