"""Ablations of the one-format quantize kernel's tile route on one NVIDIA
GPU.

    PYTHONPATH=src python3 -m repro_torch.kernels.gam_quant_ablation

Builds copies of ``csrc/gam_quant.cu`` and the tile route's shared header
``csrc/tile.cuh`` with one part of the tile route (the 128 x 128 block)
taken out or changed (``mor_select_ablation.build_copies``: one nvcc per
copy, started together) and times each beside the source as it is
(``full``), in turns (all copies, then all in reverse, twice), on the wi
view of llama3-8b (28672 x 4096 bf16, N(0, 0.02) weights, E4M3, gam).
Copies:

- ``no_eq1_divide``: Eq. 1 without its division by x (|x - stored|);
- ``f32_sum``: each thread's Eq. 1 terms summed in f32, converted to
  f64 once (no f32 -> f64 conversion and f64 add per element);
- ``no_stored_value``: the table lookup of a code's stored value
  replaced by a shift of the code;
- ``no_stores``: the 16-byte stores of xq kept as register uses,
  nothing written;
- ``no_load``: each CTA's first blocks copied and waited for, later
  blocks computed on what their ring slot holds (real weights, no
  copies and no waits).

``full`` and the copies that keep xq (``no_eq1_divide``, ``f32_sum``)
are held against the plain version first (xq bit for bit). Prints the
card's name and power limit, then one JSON line with each copy's mean
ms, its share of ``full``'s and its runs. Exits non-zero without a card,
or if an edit point no longer occurs exactly once in its file.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

from .mor_select_ablation import (EQ1, REISSUE, STORE, STORED, WAIT,
                                  build_copies, time_ms)

SHAPE = (28672, 4096)
KERNEL, HEADER = "gam_quant.cu", "tile.cuh"
SOURCES = (KERNEL, HEADER)

SUM = ("      err += f0 != 0.0f ? (double)eq1_err<kInRange>(f0, "
       "__uint_as_float(v0)) : 0.0;\n"
       "      err += f1 != 0.0f ? (double)eq1_err<kInRange>(f1, "
       "__uint_as_float(v1)) : 0.0;\n")
SUM_F32 = ("      ef += f0 != 0.0f ? eq1_err<kInRange>(f0, __uint_as_float(v0)) "
           ": 0.0f;\n"
           "      ef += f1 != 0.0f ? eq1_err<kInRange>(f1, __uint_as_float(v1)) "
           ": 0.0f;\n")
ACC = "  double err = 0.0;\n#pragma unroll 1\n"
RET = "    rotate<32, 8>(xr);\n  }\n  return err;\n"
# copy -> (file, text taken out, text put in its place)
ABLATIONS = {
    "full": [],
    "no_eq1_divide": [(HEADER, EQ1, "  return fabsf(x - st);\n")],
    "f32_sum": [(KERNEL, ACC, "  float ef = 0.0f;\n" + ACC),
                (KERNEL, SUM, SUM_F32),
                (KERNEL, RET, "    rotate<32, 8>(xr);\n  }\n"
                              "  return err + (double)ef;\n")],
    "no_stored_value": [(HEADER, STORED, "  return b << 22;\n")],
    "no_stores": [(HEADER, STORE, '  asm volatile("" ::"r"(v.x), "r"(v.y), '
                                  '"r"(v.z), "r"(v.w));\n')],
    "no_load": [(KERNEL, WAIT, "    if (k < T_STAGES) " + WAIT.lstrip()),
                (KERNEL, REISSUE, "    if (false) {\n")],
}
KEEPS_XQ = ("full", "no_eq1_divide", "f32_sum")


def launcher(lib, xp, mg):
    """A closure launching the tile route (E4M3, gam) of the copy in
    ``lib`` on xp; returns its xq."""
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    Mp, Kp = xp.shape
    nb = (Mp // 128) * (Kp // 128)
    dev = xp.device
    xq = torch.empty(Mp, Kp, dtype=torch.bfloat16, device=dev)
    exp = torch.empty(nb, dtype=torch.int32, device=dev)
    err, cnt = (torch.empty(nb, dtype=torch.float32, device=dev)
                for _ in range(2))
    f = lib.gam_quant_tile_launch
    f.argtypes = [P] * 6 + [I] * 3 + [F, I, P]
    f.restype = I
    args = (xp.data_ptr(), mg.data_ptr(), xq.data_ptr(), exp.data_ptr(),
            err.data_ptr(), cnt.data_ptr(), Mp, Kp, 0, 448.0, 0)

    def run():
        e = f(*args, torch.cuda.current_stream().cuda_stream)
        if e != 0:
            raise RuntimeError(f"launch failed: CUDA error {e}")
        return xq
    return run


def main() -> int:
    if not torch.cuda.is_available():
        print("gam_quant_ablation: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core.formats import E4M3
    from . import build, ops
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    libs = build_copies(build, "gam_quant", SOURCES, ABLATIONS)
    g = torch.Generator(device="cuda").manual_seed(5)
    w = (torch.randn(SHAPE, generator=g, device="cuda") * 0.02).to(
        torch.bfloat16)
    mg = ops._kernel_inputs(w[None], (128, 128), (E4M3,), "gam")[2][0]
    xq_t = ops.gam_quant(w, fmt=E4M3, backend="torch")[0]
    runs = {n: launcher(lib, w, mg) for n, lib in libs.items()}
    for name in KEEPS_XQ:
        xq = runs[name]()
        torch.cuda.synchronize()
        if not torch.equal(xq.view(torch.int16), xq_t.view(torch.int16)):
            raise AssertionError(f"{name}: xq differs from the plain version")
    order = (list(runs) + list(runs)[::-1]) * 2
    ms = {n: [] for n in runs}
    for n in order:
        ms[n].append(time_ms(runs[n]))
    mean = {n: sum(t) / len(t) for n, t in ms.items()}
    print(json.dumps({"kernel": "gam_quant", "route": "tile",
                      "shape": list(SHAPE), "fmt": "e4m3", "algo": "gam",
                      "ms": mean,
                      "share_of_full": {n: mean[n] / mean["full"]
                                        for n in mean},
                      "runs": ms, "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
