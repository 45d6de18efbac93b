"""Mesh factories and the card's roofline constants (port of
``repro.launch.mesh``).

The production meshes are the reference's: single-pod (data=16,
model=16) over 256 ranks, multi-pod (pod=2, data=16, model=16) over 512,
the 'pod' axis a pure data-parallel dimension whose gradient sums are
the cross-pod traffic that ``optim.compress.make_pod_compressed_psum``
compresses. A mesh here is ``core.collectives.make_mesh`` over the ranks
of the ``torch.distributed`` world, one process a rank.

The reference's ``host_device_env`` makes the environment of a child
process that sees n XLA host devices; it has no meaning for PyTorch. Its
counterpart is a world of n rank processes: ``launch.ranks.run_ranks``
starts them, each with ``launch.ranks.rank_env()``, and each joins the
world with ``launch.ranks.init_world``.

Defined as functions, never module-level meshes: importing this module
creates no process group.
"""
from __future__ import annotations

from repro_torch.core.collectives import make_mesh

__all__ = ["make_production_mesh", "make_local_mesh", "HW"]


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """(16, 16) ('data', 'model'), or (2, 16, 16) ('pod', 'data',
    'model') with ``multi_pod``, over the whole world; any other world
    size raises a ``ValueError`` naming both rank counts."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def make_local_mesh(data: int = 1, model: int = 1, device="cuda"):
    """A small ('data', 'model') mesh over the world's ranks (tests; one
    rank without a process group)."""
    return make_mesh((data, model), ("data", "model"), device=device)


class HW:
    """Roofline constants of one NVIDIA H100 SXM (NVIDIA's data sheet,
    dense rates without sparsity), the card the port runs on:
    nvidia-smi reads it as "NVIDIA H100 80GB HBM3, 700.00 W". The rates
    assume that 700 W limit; a card set lower runs slower."""

    # FLOP/s of the bf16 tensor cores (H100 80GB HBM3, 700.00 W).
    PEAK_FLOPS_BF16 = 989e12
    # FLOP/s of the fp8 tensor cores (H100 80GB HBM3, 700.00 W).
    PEAK_FLOPS_FP8 = 1979e12
    # B/s of the HBM3 (H100 80GB HBM3, 700.00 W).
    HBM_BW = 3.35e12
    # Bytes of HBM3 (H100 80GB HBM3, 700.00 W): 80 GiB, of which the CUDA
    # runtime reports a little less (the ECC reserve).
    HBM_BYTES = 80 * 2**30
