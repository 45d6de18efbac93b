"""Partitioning of 2-D operand views into blocks (port of
``repro.core.partition``).

An operand is seen as (M, K) with the contraction axis last. A
:class:`Partition` resolves to a block shape (bm, bk); blocking pads
with zeros to a multiple of the block, which every consumer ignores.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

__all__ = ["Partition", "PER_TENSOR", "PER_BLOCK_128", "PER_BLOCK_64",
           "PER_CHANNEL", "SUB_CHANNEL_128", "to_blocks", "from_blocks",
           "block_amax"]


@dataclasses.dataclass(frozen=True)
class Partition:
    kind: str  # 'tensor' | 'block' | 'channel' | 'subchannel'
    block_shape: Tuple[int, int] = (128, 128)
    sub: int = 128
    # Resolved block dims are rounded up to this after the shrink to the
    # operand; the sub4 recipe uses (2, 16).
    align: Tuple[int, int] = (1, 1)

    def resolve(self, shape: Tuple[int, int]) -> Tuple[int, int]:
        m, k = shape
        if self.kind == "tensor":
            return (m, k)
        if self.kind == "block":
            bm, bk = self.block_shape
            am, ak = self.align
            return (min(bm, -(-m // am) * am), min(bk, -(-k // ak) * ak))
        if self.kind == "channel":
            return (1, k)
        if self.kind == "subchannel":
            return (1, min(self.sub, k))
        raise ValueError(f"unknown partition kind: {self.kind}")

    def grid(self, shape: Tuple[int, int]) -> Tuple[int, int]:
        bm, bk = self.resolve(shape)
        m, k = shape
        return (-(-m // bm), -(-k // bk))


PER_TENSOR = Partition("tensor")
PER_BLOCK_128 = Partition("block", (128, 128))
PER_BLOCK_64 = Partition("block", (64, 64))
PER_CHANNEL = Partition("channel")
SUB_CHANNEL_128 = Partition("subchannel", sub=128)


def _pad2d(x: torch.Tensor, bm: int, bk: int) -> torch.Tensor:
    m, k = x.shape
    pm, pk = (-m) % bm, (-k) % bk
    if pm or pk:
        x = F.pad(x, (0, pk, 0, pm))
    return x


def to_blocks(x: torch.Tensor, part: Partition) -> torch.Tensor:
    """(M, K) -> (nm, nk, bm, bk) zero-padded block view."""
    if x.ndim != 2:
        raise ValueError(f"to_blocks wants 2-D, got {tuple(x.shape)}")
    bm, bk = part.resolve(tuple(x.shape))
    xp = _pad2d(x, bm, bk)
    mp, kp = xp.shape
    return xp.reshape(mp // bm, bm, kp // bk, bk).permute(0, 2, 1, 3)


def from_blocks(xb: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    """(nm, nk, bm, bk) -> (M, K), dropping padding."""
    nm, nk, bm, bk = xb.shape
    x = xb.permute(0, 2, 1, 3).reshape(nm * bm, nk * bk)
    m, k = shape
    return x[:m, :k]


def block_amax(x: torch.Tensor, part: Partition) -> torch.Tensor:
    """Per-block absolute maxima (nm, nk) f32 (NaN propagates)."""
    xb = to_blocks(x.to(torch.float32), part)
    return torch.amax(xb.abs(), dim=(2, 3))
