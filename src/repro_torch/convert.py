"""Carry parameters drawn by the JAX package across to the port.

Torch cannot replay ``jax.random``, so tests that compare the two
packages draw weights with the reference's ``init_params`` and hand the
numpy tree here. numpy's bf16 (``ml_dtypes.bfloat16``) is not a dtype
``torch.from_numpy`` accepts: such leaves travel as their uint16 bit
patterns and are viewed back as ``torch.bfloat16``, bit for bit.
Layer-stacked (L, K, N) leaves keep their layer axis.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_jax"]


def _leaf(a, device) -> torch.Tensor:
    a = np.array(a, order="C")  # writable: JAX buffers are read-only
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def params_from_jax(tree, device="cuda"):
    """Nested dict of numpy arrays (the JAX ``init_params`` output after
    ``np.asarray``) -> the same nested dict of torch tensors on
    ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    return _leaf(tree, torch.device(device))
