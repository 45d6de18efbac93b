"""Fault-tolerant checkpointing: async, atomic, keep-k (port of
``repro.checkpoint.ckpt``; the files are the reference's).

Layout: ``<dir>/step_<n>/arrays.npz`` + ``manifest.json`` (``{"step",
"extra", "dtypes"}``). Each leaf is stored under its key path as
``jax.tree_util.keystr`` spells it (``core.tree``), so either package
restores the other's checkpoints. Dtypes numpy lacks (bf16, fp8) are
stored as unsigned integers of their width, with their ``ml_dtypes``
name in the ``dtypes`` sidecar; the bits are viewed through torch, so
neither side of the round trip needs ``ml_dtypes``. Writes go to a
``.tmp`` directory that is then ``os.rename``d, so a preempted save
never corrupts the latest checkpoint: :func:`latest_step` only sees
renamed directories.

``save`` copies every leaf to the host before it returns (the port's
AdamW updates its state in place, so the caller may step at once); in
async mode only the file write runs on a writer thread, and ``wait()``
joins it (re-raising what the write raised). ``restore`` takes each
array's shape from the file (a packed moment's compact lanes change
shape with its tags), recomputes each MixedOperand's ``has_nvfp4`` from
its restored tags, and places each leaf on the target leaf's device in
its dtype, reading one array at a time. With ``shardings`` (a tree of
``sharding.NamedSharding``, the elastic re-mesh) each array is cut to
this rank's block as soon as it is read and placed on its mesh's
device; the whole array is dropped before the next one is read.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.tree import flatten_with_path, map_with_path

__all__ = ["Checkpointer", "latest_step"]

# Dtypes numpy has no name for: the ml_dtypes name the reference writes
# in the sidecar, and the unsigned integer type of their width.
_EXOTIC = {
    torch.bfloat16: ("bfloat16", np.uint16),
    torch.float8_e4m3fn: ("float8_e4m3fn", np.uint8),
    torch.float8_e5m2: ("float8_e5m2", np.uint8),
}
_BY_NAME = {name: dt for dt, (name, _) in _EXOTIC.items()}
_INT_OF_WIDTH = {1: torch.uint8, 2: torch.int16}


def _host_array(leaf) -> Tuple[np.ndarray, str]:
    """A host copy of one leaf that no later in-place update reaches, as
    an npz-safe array, and its dtype's name."""
    if not isinstance(leaf, torch.Tensor):
        arr = np.array(leaf)
        return arr, str(arr.dtype)
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype in _EXOTIC:
        name, store = _EXOTIC[t.dtype]
        arr = t.view(_INT_OF_WIDTH[t.element_size()]).numpy().view(store)
        return arr, name
    arr = t.numpy()
    return arr, str(arr.dtype)


def _flatten(tree) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    flat, dtypes = {}, {}
    for key, leaf in flatten_with_path(tree):
        flat[key], dtypes[key] = _host_array(leaf)
    return flat, dtypes


def _to_tensor(arr: np.ndarray, name: Optional[str]) -> torch.Tensor:
    """The tensor an array of the file holds (the sidecar names its
    dtype)."""
    if name in _BY_NAME:
        dt = _BY_NAME[name]
        width = torch.empty((), dtype=dt).element_size()
        ints = arr.view(np.uint8 if width == 1 else np.int16)
        return torch.from_numpy(np.asarray(ints, order="C")).view(dt)
    return torch.from_numpy(np.asarray(arr, order="C"))


def _refresh_has_nvfp4(tree):
    """Every MixedOperand of ``tree`` with ``has_nvfp4`` read from its
    tags (the GEMM decodes the nibble lanes only when it is set)."""
    from repro_torch.kernels.ref import TAG_NVFP4, MixedOperand
    from repro_torch.optim.moments import PackedMoment

    if isinstance(tree, MixedOperand):
        return dataclasses.replace(
            tree, has_nvfp4=bool((tree.tags == TAG_NVFP4).any()))
    if isinstance(tree, PackedMoment):
        return dataclasses.replace(tree, mo=_refresh_has_nvfp4(tree.mo))
    if isinstance(tree, dict):
        return {k: _refresh_has_nvfp4(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_refresh_has_nvfp4(c) for c in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_refresh_has_nvfp4(c) for c in tree)
    return tree


def _steps(directory: str):
    return [int(n.split("_")[1]) for n in os.listdir(directory)
            if n.startswith("step_") and not n.endswith(".tmp")
            and os.path.exists(os.path.join(directory, n, "manifest.json"))]


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = _steps(directory)
    return max(steps) if steps else None


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3, async_save=True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        os.makedirs(directory, exist_ok=True)

    # ---------------------------------------------------------------- save
    def save(self, step: int, tree: Any, extra: Optional[dict] = None):
        """Snapshot ``tree`` at ``step``: every leaf is copied to the host
        before this returns; the file is written in the background when
        async."""
        self.wait()
        flat, dtypes = _flatten(tree)
        meta = {"step": step, "extra": extra or {}, "dtypes": dtypes}

        def write():
            final = os.path.join(self.dir, f"step_{step}")
            tmp = final + ".tmp"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            np.savez(os.path.join(tmp, "arrays.npz"), **flat)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(meta, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()

        if self.async_save:
            def run():
                try:
                    write()
                except Exception as e:  # re-raised by wait()
                    self._error = e

            self._thread = threading.Thread(target=run, daemon=True)
            self._thread.start()
        else:
            write()

    def wait(self):
        """Join the writer thread; re-raise what the write raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = sorted(_steps(self.dir))
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # ------------------------------------------------------------- restore
    def restore(self, step: int, target: Any, shardings: Any = None):
        """Restore into the structure of ``target``: each leaf from the
        file (its shape too), on the target leaf's device in its dtype;
        a target leaf that is no tensor gets a CPU tensor. ``shardings``:
        a tree of ``sharding.NamedSharding`` at the target's leaves (the
        elastic re-mesh); each such leaf becomes this rank's block, on
        the mesh's device in the target leaf's dtype."""
        d = os.path.join(self.dir, f"step_{step}")
        dtypes = self.manifest(step).get("dtypes", {})
        cuts = dict(flatten_with_path(shardings))
        with np.load(os.path.join(d, "arrays.npz")) as zf:
            def load(key, leaf):
                t = _to_tensor(zf[key], dtypes.get(key))
                dtype = leaf.dtype if isinstance(leaf, torch.Tensor) \
                    else None
                if key in cuts:
                    return cuts[key].shard(t, key, dtype)
                if dtype is not None:
                    t = t.to(dtype=dtype).to(device=leaf.device)
                return t

            out = map_with_path(load, target)
        return _refresh_has_nvfp4(out)

    def manifest(self, step: int) -> dict:
        with open(os.path.join(self.dir, f"step_{step}",
                               "manifest.json")) as f:
            return json.load(f)
