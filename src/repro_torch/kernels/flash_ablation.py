"""Ablations of flash attention's wgmma route on one NVIDIA GPU.

    PYTHONPATH=src python3 -m repro_torch.kernels.flash_ablation

Builds copies of ``csrc/flash_attention.cu`` with one part of the wgmma
route taken out (one nvcc per copy, started together, into
``build/ablation/`` beside the kernels' build directory) and times each
beside the source as it is (``full``), in turns (all copies, then all in
reverse, twice), at llama3-8b's heads (32 q / 8 kv, dh 128, bf16,
causal): the 2 x 1024 training batch, the 8192 context and a 4-slot
prefill chunk of 32 queries against 512 positions. Copies:

- ``no_lo_mma``: p v with hi only (the second MMA of the split p out);
- ``no_pv_mma``: no p v wgmma at all;
- ``no_qk_mma``: no q k^T wgmma (the softmax runs on stale scores);
- ``cheap_exp``: 2^x replaced by a multiply.

Every copy keeps reading the wgmmas' registers (an empty asm pins them),
so ptxas keeps the wgmmas that remain. Only ``full`` computes attention;
its error against the plain version is printed as err / tol. Prints the
card's name and power limit, then one JSON line per shape with each
copy's mean ms and its runs. Exits non-zero without a card.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

SHAPES = {"a_train_2x1024": (2, 1024, 1024, None),
          "b_context_8192": (1, 8192, 8192, None),
          "c_prefill_chunk": (4, 32, 512, (0, 64, 200, 480))}
HQ, HKV, DH = 32, 8, 128

PV_HI = "      wgmma_bf16_rs_n128(o, ph[kk], dv, 1);\n"
PV_LO = "      wgmma_bf16_rs_n128(o, pl[kk], dv, 1);\n"
QK = ("    wgmma_bf16_ss_n128(s, w_desc(q_addr + c * (FW_BQ * 128) + w, 16, 1024),\n"
      "                       w_desc(k_addr + c * (FW_BK * 128) + w, 16, 1024), kk > 0);\n")
EX2 = '  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));\n'
# copy -> (text taken out, text put in its place)
ABLATIONS = {"full": [],
             "no_lo_mma": [(PV_LO, "")],
             "no_pv_mma": [(PV_HI, ""), (PV_LO, "")],
             "no_qk_mma": [(QK, "")],
             "cheap_exp": [(EX2, "  y = x * 0.5f;\n")]}


def build_copies(build):
    """Write and compile each copy; returns name -> its launch function."""
    src = (build.CSRC / "flash_attention.cu").read_text()
    out = build.BUILD_DIR.parent / "ablation"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in ABLATIONS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the source no longer holds "
                                   f"{old.strip()!r} exactly once")
            text = text.replace(old, new)
        cu = out / f"{name}.cu"
        cu.write_text(text)
        cmd = [build._nvcc(), *build._COMMON, "-I", str(build.CSRC), "-o",
               str(out / f"lib{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        f = ctypes.CDLL(str(out / f"lib{name}.so")).flash_attention_wgmma_launch
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        f.argtypes = [P] * 5 + [I] * 6 + [L] * 6 + [I, ctypes.c_float, I, P]
        f.restype = I
        fns[name] = f
    return fns


def launcher(f, q, k, v, offs):
    from .flash_attention import flash_layout, flash_offsets
    B, H, G, S, T, d, qs, ks = flash_layout(q, k, v)
    off = flash_offsets(offs, S, T, B * H, q.device)
    y = torch.empty_like(q)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), off.data_ptr(),
            y.data_ptr(), B, H, G, S, T, d, *qs, *ks, 1, float(d ** -0.5), 1)

    def run():
        err = f(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return y
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
        print("flash_ablation: no CUDA device", file=sys.stderr)
        return 1
    from . import build, ops
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    fns = build_copies(build)
    g = torch.Generator(device="cuda").manual_seed(3)
    for shape, (B, S, T, offs) in SHAPES.items():
        q, k, v = (torch.randn(sh, generator=g, device="cuda").to(torch.bfloat16)
                   for sh in ((B, S, HQ, DH), (B, T, HKV, DH), (B, T, HKV, DH)))
        off = None if offs is None else torch.tensor(
            offs, dtype=torch.int32, device="cuda")
        rows = None if off is None else off.repeat_interleave(HQ)
        runs = {n: launcher(f, q, k, v, rows) for n, f in fns.items()}
        y = runs["full"]().clone()
        yt = ops.flash_attention(q, k, v, q_offset=off, backend="torch")
        o = yt.float().abs().clamp_min(2.0**-126)
        tol = 1e-5 * float(v.float().abs().max()) + torch.exp2(
            torch.floor(torch.log2(o)) - 7)
        ratio = float(((y.float() - yt.float()).abs() / tol).max())
        del yt, o, tol
        order = (list(runs) + list(runs)[::-1]) * 2
        ms = {n: [] for n in runs}
        for n in order:
            ms[n].append(time_ms(runs[n]))
        print(json.dumps({"shape": shape, "full_err_over_tol": ratio,
                          "ms": {n: sum(t) / len(t) for n, t in ms.items()},
                          "runs": ms, "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
