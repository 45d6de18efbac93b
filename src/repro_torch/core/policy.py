"""MoR recipe / policy configuration (port of ``repro.core.policy``).

``backend`` selects the lowering of a policy's quantization events and
GEMMs: ``'auto'`` launches the CUDA kernel for a CUDA tensor and runs
the plain PyTorch version for a CPU tensor; ``'torch'`` always runs the
plain version; ``'cuda'`` insists on the kernel (a CPU tensor raises).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

__all__ = ["MoRPolicy", "MoRDotPolicy", "TENSOR_MOR", "SUBTENSOR2_MOR",
           "SUBTENSOR3_MOR", "SUBTENSOR4_MOR", "BF16_BASELINE",
           "paper_default", "with_mesh_axes", "BACKENDS"]

BACKENDS = ("auto", "torch", "cuda")


@dataclasses.dataclass(frozen=True)
class MoRPolicy:
    """Policy for one quantization event.

    recipe: 'off' | 'tensor' | 'sub2' | 'sub3' | 'sub4' | 'e4m3' (see
    the reference for the semantics of each). ``threshold`` is the
    'tensor' recipe's Eq. 2 acceptance bound on the global mean
    relative error of the E4M3 candidate (th_E4M3, paper default 4.5%).
    ``mesh_axes`` names the mesh axes (``core.collectives``) the event's
    tensor-global statistics are reduced over when each rank holds a
    shard of the operand.
    """

    recipe: str = "tensor"
    partition: str = "block"
    block_shape: Tuple[int, int] = (128, 128)
    sub: int = 128
    threshold: float = 0.045  # th_E4M3, paper default 4.5%
    algo: str = "gam"  # 'gam' | 'e8m0' | 'fp32_amax'
    backend: str = "auto"  # 'auto' | 'torch' | 'cuda'
    mesh_axes: Tuple[str, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "mesh_axes", tuple(self.mesh_axes))
        object.__setattr__(self, "block_shape", tuple(self.block_shape))
        if self.backend not in BACKENDS:
            raise ValueError(
                f"unknown backend {self.backend!r} (want one of {BACKENDS})"
            )

    @property
    def enabled(self) -> bool:
        return self.recipe != "off"

    def replace(self, **kw) -> "MoRPolicy":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class MoRDotPolicy:
    """Per-operand policies for one mor_dot GEMM (fwd + both bwd GEMMs).

    ``quantize_bwd=False`` runs the backward GEMMs unquantized (an
    ablation hook). ``fuse_gemm=True`` routes all three GEMMs through the
    mixed-representation block GEMM on real packs instead of
    dequantize-then-bf16-dot; every enabled operand policy must then be
    'block'-partitioned with one shared block shape.
    ``decision_cache_steps`` is accepted and ignored: the reference
    declares it and nothing there reads it.
    """

    act: MoRPolicy = MoRPolicy()
    weight: MoRPolicy = MoRPolicy()
    grad: MoRPolicy = MoRPolicy()
    quantize_bwd: bool = True
    fuse_gemm: bool = False
    decision_cache_steps: int = 0  # unread, as in the reference

    @property
    def enabled(self) -> bool:
        return self.act.enabled or self.weight.enabled or self.grad.enabled

    def replace(self, **kw) -> "MoRDotPolicy":
        return dataclasses.replace(self, **kw)


def paper_default(recipe: str = "tensor", partition: str = "block",
                  block_shape: Tuple[int, int] = (128, 128),
                  threshold: float = 0.045,
                  algo: str = "gam") -> MoRDotPolicy:
    p = MoRPolicy(recipe=recipe, partition=partition,
                  block_shape=block_shape, threshold=threshold, algo=algo)
    return MoRDotPolicy(act=p, weight=p, grad=p)


def with_mesh_axes(policy: MoRDotPolicy,
                   axes: Tuple[str, ...]) -> MoRDotPolicy:
    """The same dot policy with every operand event reducing its global
    statistics over ``axes`` (for code run by each rank of a mesh on its
    shard). Safe to apply uniformly: a *replicated* operand's decisions
    are unchanged because every decision-bearing aggregate is a ratio of
    two sums or a max (docs/sharding.md, 'replication safety')."""
    axes = tuple(axes)
    return policy.replace(
        act=policy.act.replace(mesh_axes=axes),
        weight=policy.weight.replace(mesh_axes=axes),
        grad=policy.grad.replace(mesh_axes=axes),
    )


TENSOR_MOR = paper_default("tensor")
SUBTENSOR2_MOR = paper_default("sub2")
SUBTENSOR3_MOR = paper_default("sub3")
SUBTENSOR4_MOR = paper_default("sub4")
BF16_BASELINE = MoRDotPolicy(
    act=MoRPolicy(recipe="off"),
    weight=MoRPolicy(recipe="off"),
    grad=MoRPolicy(recipe="off"),
)
