"""Ablations of the MoR selection kernels' tile route on one NVIDIA GPU.

    PYTHONPATH=src python3 -m repro_torch.kernels.mor_select_ablation

Builds copies of ``csrc/mor_select.cu`` and the tile route's shared
header ``csrc/tile.cuh`` with one part of the tile route (the 128 x 128
block) taken out (one nvcc per copy, started together, each copy in its
own directory under ``build/ablation/`` beside the kernels' build
directory, where its edited header shadows the source's) and times
each beside the source as it is (``full``), in turns (all copies, then
all in reverse, twice), on the wi view of llama3-8b (28672 x 4096 bf16,
N(0, 0.02) weights, sub3), pack and select. Copies:

- ``no_eq1_divide``: Eq. 1 without its division by x (|x - stored|);
- ``no_stored_value``: the table lookup of a code's stored value
  replaced by a shift of the code;
- ``no_stores``: the 16-byte stores of the payload lanes and y kept as
  register uses, nothing written;
- ``no_load``: each CTA's first blocks copied and waited for, later
  blocks computed on what their ring slot holds (real weights, no
  copies and no waits);
- ``direct_loads``: 16-byte loads from device memory in place of the
  TMA ring (the same persistent grid, registers and resident CTAs).

Only ``full`` and ``direct_loads`` compute the selection; their outputs
are held bit for bit against the plain version. Prints the card's name
and power limit, then one JSON line per variant with each copy's mean ms,
its share of ``full``'s and its runs. Exits non-zero without a card, or
if an edit point no longer occurs exactly once in its file.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

SHAPE = (28672, 4096)
MODE = "sub3"
KERNEL, HEADER = "mor_select.cu", "tile.cuh"
SOURCES = (KERNEL, HEADER)

EQ1 = "  return fabsf(kInRange ? div_in_range(x - st, x) : (x - st) / x);\n"
STORED = "  return ((uint32_t)tab[b & 0x7Fu] << 16) | ((b & 0x80u) << 24);\n"
STORE = "  *reinterpret_cast<uint4*>(p) = v;\n"
WAIT = "    mbar_wait(&full[s], (uint32_t)(k / T_STAGES) & 1u);\n"
REISSUE = "    if (tid == 0 && b + T_STAGES * (int)gridDim.x < nblocks) {\n"
PROLOGUE = "      if (b < nblocks) issue_block(&xmap, ring, full, b, s, nk);\n"
SLOT = ("      const unsigned char* st = ring + s * T_BOX + rq * (TILE * 2) + "
        "cq * 32;\n")
SLOT_READS = (
    "        const uint4 a = *reinterpret_cast<const uint4*>(st + p * 32 * "
    "(TILE * 2) + 16 * sw);\n"
    "        const uint4 c = *reinterpret_cast<const uint4*>(st + p * 32 * "
    "(TILE * 2) + 16 * (sw ^ 1));\n")
# The same rows read straight from device memory, 16 B a load.
ROW = ("      const unsigned char* st = reinterpret_cast<const unsigned char*>("
       "x + ((size_t)i * TILE + rq) * Kp + (size_t)j * TILE) + cq * 32;\n")
ROW_READS = (
    "        const uint4 a = __ldg(reinterpret_cast<const uint4*>(st + "
    "(size_t)p * 64 * Kp + 16 * sw));\n"
    "        const uint4 c = __ldg(reinterpret_cast<const uint4*>(st + "
    "(size_t)p * 64 * Kp + 16 * (sw ^ 1)));\n")
# copy -> (file, text taken out, text put in its place)
ABLATIONS = {
    "full": [],
    "no_eq1_divide": [(HEADER, EQ1, "  return fabsf(x - st);\n")],
    "no_stored_value": [(HEADER, STORED, "  return b << 22;\n")],
    "no_stores": [(HEADER, STORE, '  asm volatile("" ::"r"(v.x), "r"(v.y), '
                                  '"r"(v.z), "r"(v.w));\n')],
    "no_load": [(KERNEL, WAIT, "    if (k < T_STAGES) " + WAIT.lstrip()),
                (KERNEL, REISSUE, "    if (false) {\n")],
    "direct_loads": [(KERNEL, WAIT, ""), (KERNEL, PROLOGUE, ""),
                     (KERNEL, REISSUE, "    if (false) {\n"),
                     (KERNEL, SLOT, ROW), (KERNEL, SLOT_READS, ROW_READS)],
}
COMPUTES = ("full", "direct_loads")


def edited_sources(srcs, ablations=None):
    """name -> the edited copy of ``srcs`` (file name -> text) for each
    copy of ``ablations`` (this module's ``ABLATIONS`` by default); raises
    if an edit point moved."""
    out = {}
    for name, edits in (ablations or ABLATIONS).items():
        texts = dict(srcs)
        for fname, old, new in edits:
            if texts[fname].count(old) != 1:
                raise RuntimeError(f"{name}: {fname} no longer holds "
                                   f"{old.strip()!r} exactly once")
            texts[fname] = texts[fname].replace(old, new)
        out[name] = texts
    return out


def build_copies(build, kernel="mor_select", sources=SOURCES,
                 ablations=None):
    """Write and compile each copy of ``csrc/<kernel>.cu`` and the other
    ``sources`` (``ablations``: this module's ``ABLATIONS`` by default);
    returns name -> its library."""
    srcs = {f: (build.CSRC / f).read_text() for f in sources}
    out = build.BUILD_DIR.parent / "ablation"
    procs = {}
    for name, texts in edited_sources(srcs, ablations).items():
        d = out / f"{kernel}_{name}"
        d.mkdir(parents=True, exist_ok=True)
        for fname, text in texts.items():
            (d / fname).write_text(text)
        # The copy's own header comes first ("" includes search the
        # including file's directory); the other headers from the source.
        cmd = [build._nvcc(), *build._COMMON, *build.SOURCES[kernel],
               "-I", str(build.CSRC), "-o",
               str(out / f"lib{kernel}_{name}.so"), str(d / f"{kernel}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(out / f"lib{kernel}_{name}.so"))
    return libs


def launcher(lib, variant, xp, mg):
    """A closure launching ``variant`` (pack / select) of the copy in
    ``lib`` on xp; returns its outputs."""
    from .mor_select import _ALGOS, _MODES
    from repro_torch.core.metrics import E5M2_RANGE_RATIO, NVFP4_RANGE_RATIO
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    Mp, Kp = xp.shape
    nb = (Mp // 128) * (Kp // 128)
    dev = xp.device
    grid = {k: torch.empty(nb, dtype=torch.float32, device=dev)
            for k in ("scales", "e4", "e5", "cnt")}
    sel = torch.empty(nb, dtype=torch.int32, device=dev)
    if variant == "pack":
        f = lib.mor_select_pack_tile_launch
        f.argtypes = [P] * 12 + [I] * 4 + [F, F, P]
        q = torch.empty(Mp, Kp, dtype=torch.uint8, device=dev)
        bf = torch.empty(Mp, Kp, dtype=torch.bfloat16, device=dev)
        outs = {"payload_q": q, "payload_bf16": bf, "sel": sel}
        ptrs = (xp.data_ptr(), mg.data_ptr(), q.data_ptr(), bf.data_ptr(),
                sel.data_ptr(), *(grid[k].data_ptr() for k in grid),
                None, None, None)
    else:
        f = lib.mor_select_select_tile_launch
        f.argtypes = [P] * 9 + [I] * 4 + [F, F, P]
        y = torch.empty(Mp, Kp, dtype=torch.bfloat16, device=dev)
        outs = {"y": y, "sel": sel}
        ptrs = (xp.data_ptr(), mg.data_ptr(), y.data_ptr(), sel.data_ptr(),
                *(grid[k].data_ptr() for k in grid), None)
    f.restype = I
    args = (*ptrs, Mp, Kp, _MODES[MODE], _ALGOS["gam"], E5M2_RANGE_RATIO,
            NVFP4_RANGE_RATIO)

    def run():
        err = f(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return outs
    return run


def time_ms(fn, iters=20):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("mor_select_ablation: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core.partition import Partition
    from . import build, ops
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    libs = build_copies(build)
    g = torch.Generator(device="cuda").manual_seed(5)
    w = (torch.randn(SHAPE, generator=g, device="cuda") * 0.02).to(
        torch.bfloat16)
    xp, _, mg = (t[0] for t in ops._kernel_inputs(
        w[None], (128, 128), ops.SELECT_FORMATS, "gam"))
    part = Partition("block", (128, 128))
    mo_t, _ = ops.quantize_pack(w, part, MODE, backend="torch")
    y_t = ops.mor_select(w, part, MODE, backend="torch").y
    for variant in ("pack", "select"):
        runs = {n: launcher(lib, variant, xp, mg) for n, lib in libs.items()}
        for name in COMPUTES:
            out = runs[name]()
            torch.cuda.synchronize()
            if variant == "pack":
                same = (torch.equal(out["payload_q"], mo_t.payload_q)
                        and torch.equal(out["payload_bf16"].view(torch.int16),
                                        mo_t.payload_bf16.view(torch.int16)))
            else:
                same = torch.equal(out["y"].view(torch.int16),
                                   y_t.view(torch.int16))
            if not same:
                raise AssertionError(f"{name} {variant}: output differs from "
                                     f"the plain version")
        order = (list(runs) + list(runs)[::-1]) * 2
        ms = {n: [] for n in runs}
        for n in order:
            ms[n].append(time_ms(runs[n]))
        mean = {n: sum(t) / len(t) for n, t in ms.items()}
        print(json.dumps({"variant": variant, "shape": list(SHAPE),
                          "mode": MODE, "ms": mean,
                          "share_of_full": {n: mean[n] / mean["full"]
                                            for n in mean},
                          "runs": ms, "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
