"""The device an entry point of the port runs on, and the f32 matmul
precision its own f32 GEMMs run at."""
from __future__ import annotations

import contextlib

import torch

__all__ = ["resolve_device", "ieee_f32_matmul"]


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU; asking for CUDA on a machine without it raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    return dev


@contextlib.contextmanager
def ieee_f32_matmul():
    """Run the f32 matmuls inside in full f32 (no TF32), as the reference
    sums them, whatever the caller's setting; the caller's setting is
    restored after. PyTorch keeps a legacy (``allow_tf32``,
    ``set_float32_matmul_precision``) and a new (``fp32_precision``)
    flag, refuses to read them once they disagree, and cuBLAS reads
    both: the setting is switched through the API it was made with."""
    m = torch.backends.cuda.matmul
    try:
        legacy = m.allow_tf32
    except RuntimeError:  # set through the new API
        legacy = None
    if legacy is False:
        yield
        return
    if legacy is None:
        saved = m.fp32_precision
        m.fp32_precision = "ieee"
        try:
            yield
        finally:
            m.fp32_precision = saved
        return
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved)
