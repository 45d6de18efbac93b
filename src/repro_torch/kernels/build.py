"""Build the CUDA kernels with ``nvcc`` at first use and load them with
``ctypes``.

Each ``csrc/<name>.cu`` compiles into its own shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), for
``sm_90a`` and without fast-math: payload bytes must be bit-exact, and
fast-math changes IEEE division and flushes denormals. Libraries are
cached in ``build/kernels/`` at the repository root (listed in
``.gitignore``) under a SHA-256 digest of the sources and flags, so an
edited source rebuilds. :func:`build_all` starts one ``nvcc`` per source
at once. The processes of a multi-process world only load what their
parent built (:func:`_build`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

__all__ = ["CSRC", "BUILD_DIR", "SOURCES", "build_all", "build_log", "load",
           "library_path"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

_COMMON = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# Per-source flags. The quantization kernels' bytes, stored values and
# error sums follow the reference op by op, so no multiply-add
# contraction there. The GEMMs and attention are held to an f32
# summation-order tolerance, not bit for bit: a fused multiply-add rounds
# once where a product and a sum round twice, which is within it, so they
# keep contraction. None uses fast-math (IEEE division, expf rather than
# __expf, denormals kept).
SOURCES: Dict[str, List[str]] = {
    "mor_select": ["-fmad=false"],
    "gam_quant": ["-fmad=false"],
    "mixed_gemm": [],
    "flash_attention": [],
    "fp8_gemm": [],
}

_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build on a machine with the "
            "CUDA toolkit (PATH or /usr/local/cuda/bin)"
        )
    return found


def _target(name: str) -> Path:
    flags = _COMMON + SOURCES[name]
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _build(names) -> Dict[str, str]:
    """Build the named libraries not yet cached, one nvcc per source, all
    started together; returns each fresh build's compiler log. In a
    process started with ``REPRO_TORCH_PREBUILT=1`` (a rank of a
    multi-process world, ``launch.ranks.rank_env``) a missing
    library raises instead: the parent builds, the ranks only load."""
    started = {}
    for name in names:
        so = _target(name)
        if so.exists():
            continue
        if os.environ.get("REPRO_TORCH_PREBUILT") == "1":
            raise RuntimeError(
                f"kernel library {so.name} is not built: run "
                f"kernels.build.build_all() before starting the ranks")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_COMMON, *SOURCES[name], "-I", str(CSRC), "-o",
               str(tmp), str(CSRC / f"{name}.cu")]
        started[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, so)
    logs = {}
    for name, (proc, tmp, so) in started.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        (BUILD_DIR / f"{so.stem}.log").write_text(log)
        os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
        logs[name] = log
    return logs


def build_log(name: str) -> str:
    """The compiler log of the cached build of ``csrc/<name>.cu`` (its
    ``-Xptxas -v`` lines), building it first if needed."""
    _build([name])
    return (BUILD_DIR / f"{_target(name).stem}.log").read_text()


def build_all() -> Dict[str, str]:
    """Build every kernel library not yet cached (register and
    shared-memory use from ``-Xptxas -v`` in the returned logs)."""
    return _build(SOURCES)


def library_path(name: str) -> Path:
    """Path of the built library of ``csrc/<name>.cu``, built if needed."""
    _build([name])
    return _target(name)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        _build([name])
        lib = ctypes.CDLL(str(_target(name)))
        _LOADED[name] = lib
    return lib
