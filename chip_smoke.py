#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit, builds both CUDA kernels
   (one nvcc per source, started together) and prints the build time.
2. Holds each kernel against its plain PyTorch version on the same CUDA
   tensors (``backend='torch'``): ``mor_select_pack`` byte for byte on
   inputs that hit every tag (a real layer shape among them),
   ``mixed_gemm`` within an f32-summation-order tolerance.
3. Times both kernels, their plain versions and a library yardstick at
   the shapes the engine gives them.
4. Serves 8 requests through the llama3-8b engine at full width with
   sub3-quantized random weights, and checks that every GEMM of the run
   went through ``mixed_gemm`` and every weight through
   ``mor_select_pack`` (launch counters), never the plain versions.
5. Runs a prefill chunk (M = 32) and a decode step (M = 4) at depth 2
   three ways -- kernel path, plain path, GEMMs summed in f64 -- and
   holds every GEMM of the kernel path (all five weight shapes) against
   the plain version on its real inputs at 1e-5 sum|a||b|; the kernel
   path's logits may be at most twice as far from the f64 path's as
   the plain path's are.

Prints JSON lines (the ``kernels`` and ``engine`` lines among them) and
ends with ``{"ok": true, "device": ...}``. Exits non-zero on any failure,
without a card, or without the rest of the repository beside it.
"""
import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
BF16_FLOPS = 989e12           # H100 SXM dense bf16 tensor-core peak
N_LAYERS = 32                 # llama3-8b depth; cut only if time forces it


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def mixed_tags(shape, seed=0, bf16_blocks=True):
    """Operand whose blocks hit every tag: normal rows (E4M3), rows of
    huge (BF16) and moderate (E5M2) dynamic range, rows on a
    micro-scaled E2M1 grid (NVFP4 under sub4), single-element outliers
    and an all-zero stripe. ``bf16_blocks=False`` leaves out the huge
    range and the outliers, so no block needs BF16."""
    rng = np.random.default_rng(seed)
    m, k = shape
    kp = -(-k // 16) * 16
    x = rng.standard_normal((m, kp))
    q = max(m // 4, 1)
    h = kp // 2 if bf16_blocks else 0
    x[q:2 * q, :h] *= np.exp2(rng.integers(-20, 20, (q, h)))
    # Moderate range, magnitudes kept off zero so the Eq. 4 gate passes.
    x[q:2 * q, h:] = np.sign(x[q:2 * q, h:]) * rng.uniform(
        1, 2, (q, kp - h)) * np.exp2(rng.integers(-12, 4, (q, kp - h)))
    grid = np.array([0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0])
    mm = grid[rng.integers(0, 7, (q, kp))] * np.exp2(
        rng.integers(-9, 9, (q, kp // 16))).repeat(16, axis=1)
    x[2 * q:3 * q] = mm * np.where(rng.standard_normal((q, kp)) > 0, 1, -1)
    if bf16_blocks:
        rows = rng.integers(0, q, 8)
        x[rows, rng.integers(0, kp, 8)] *= 1e4  # outliers in normal blocks
    x[-max(m // 8, 1):] = 0.0
    return torch.from_numpy(x[:, :k].astype(np.float32)).to(torch.bfloat16)


def time_ms(fn, iters=10):
    """Mean device time of one call (CUDA events around ``iters`` calls
    after a warm-up)."""
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


def assert_pack_equal(mo_k, mo_t, r_k, r_t, what):
    for lane in ("payload_q", "payload_bf16", "payload_nib",
                 "micro_scales", "tags", "scales"):
        a, b = getattr(mo_k, lane), getattr(mo_t, lane)
        if a.dtype in (torch.bfloat16, torch.float32):
            a, b = a.view(torch.int16 if a.dtype == torch.bfloat16
                          else torch.int32), \
                b.view(torch.int16 if b.dtype == torch.bfloat16
                       else torch.int32)
        check(a.shape == b.shape and torch.equal(a, b),
              f"{what}: lane {lane} differs from the plain version")
    for f in ("e4_sums", "e5_sums", "nv_sums"):
        a, b = getattr(r_k, f), getattr(r_t, f)
        if a is None and b is None:
            continue
        check(torch.allclose(a, b, rtol=1e-5, atol=0.0, equal_nan=True),
              f"{what}: {f} beyond rtol 1e-5")
    check(torch.equal(r_k.counts, r_t.counts), f"{what}: counts differ")


def phase_mor_select(ops, Partition):
    """Kernel vs plain version of the pack-emitting selection."""
    cases = [((256, 384), (64, 64), 1), ((200, 136), (128, 128), 2),
             ((28672, 4096), (128, 128), 3)]  # the last: the wi view
    want = {"sub2": {0, 2}, "sub3": {0, 1, 2}, "sub4": {0, 1, 2, 3}}
    seen = {mode: set() for mode in want}
    max_err = 0.0
    for shape, block, seed in cases:
        x = mixed_tags(shape, seed).cuda()
        x[5, 7] = float("nan")
        x[shape[0] // 2 + 3, shape[1] - 9] = float("inf")
        for mode in ("sub2", "sub3", "sub4"):
            align = (2, 16) if mode == "sub4" else (1, 1)
            part = Partition("block", block, align=align)
            mo_k, r_k = ops.quantize_pack(x, part, mode, backend="cuda")
            mo_t, r_t = ops.quantize_pack(x, part, mode, backend="torch")
            torch.cuda.synchronize()
            what = f"mor_select_pack {shape} {mode}"
            assert_pack_equal(mo_k, mo_t, r_k, r_t, what)
            tags = set(np.unique(mo_t.tags.cpu().numpy()).tolist())
            seen[mode] |= tags
            d = (mo_k.dequant().float() - mo_t.dequant().float()).abs()
            max_err = max(max_err, float(d.nan_to_num(0.0).max()))
            emit({"parity": "mor_select_pack", "shape": list(shape),
                  "block": list(block), "mode": mode,
                  "tags": sorted(tags), "identical": True})
    for mode, tags in want.items():
        check(tags <= seen[mode], f"mor_select_pack {mode}: tags "
              f"{sorted(seen[mode])} miss some of {sorted(tags)}")
    return max_err


def phase_mixed_gemm(ops, ref, Partition):
    """Kernel vs plain version of the mixed GEMM on packs that mix every
    tag and compact lanes, f32 and bf16 output, within ``gemm_tol``."""
    def pack(x, mode, block=(128, 128)):
        align = (2, 16) if mode == "sub4" else (1, 1)
        mo, _ = ops.quantize_pack(x, Partition("block", block, align=align),
                                  mode, backend="cuda")
        return mo.compact()

    K = 4096
    b_mixed = pack(mixed_tags((1024, K), 4).cuda(), "sub4")
    b_fp8 = pack((torch.randn(2048, K, device="cuda") * 0.02).to(
        torch.bfloat16), "sub3")  # all E4M3: bf16 and NVFP4 lanes compact
    check(tuple(b_fp8.payload_bf16.shape) == (128, 128),
          "the all-E4M3 pack should have a compact bf16 lane")
    b_nobf = pack(mixed_tags((1024, K), 6, bf16_blocks=False).cuda(),
                  "sub4")  # E4M3/E5M2/NVFP4, bf16 lane compact
    check(tuple(b_nobf.payload_bf16.shape) == (128, 128) and len(
        np.unique(b_nobf.tags.cpu().numpy())) == 3,
        "the no-BF16 sub4 pack should mix three tags, bf16 lane compact")
    a_mixed = pack(mixed_tags((256, K), 5).cuda(), "sub4")
    cases = []
    for M in (4, 32, 129):
        x = torch.randn(M, K, device="cuda").to(torch.bfloat16)
        for label, b in (("4 tags", b_mixed), ("no BF16", b_nobf),
                         ("all E4M3", b_fp8)):
            a = ref.passthrough_mixed(
                x, (ref.activation_row_block(M, 128), 128))
            cases.append((f"passthrough M={M} x {label} N={b.shape[0]}",
                          a, b))
    cases.append(("mixed A (sub4) x mixed B (sub4)", a_mixed, b_mixed))
    for name, a, b in cases:
        A = ref.decode_mixed_ref(a)[:a.shape[0]]
        B = ref.decode_mixed_ref(b)[:b.shape[0]]
        for out_dtype in (torch.float32, torch.bfloat16):
            ck = ops.mixed_gemm(a, b, out_dtype=out_dtype, backend="cuda")
            ct = ops.mixed_gemm(a, b, out_dtype=out_dtype, backend="torch")
            err = (ck.float() - ct.float()).abs()
            check(bool(torch.all(err <= gemm_tol(A, B, ct, out_dtype))),
                  f"mixed_gemm {name} {out_dtype}: max err "
                  f"{float(err.max())} beyond tolerance")
        emit({"parity": "mixed_gemm", "case": name, "ok": True})


def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def weight_bytes(mo):
    """Bytes a GEMM must read of a packed weight: each block's named lane
    only (fp8 1 B/elt, BF16 2 B/elt, NVFP4 0.5 + 1/16 B/elt) plus the
    tag and scale grids."""
    counts = np.bincount(mo.tags.reshape(-1).cpu().numpy(), minlength=4)
    per_block = mo.block[0] * mo.block[1]
    bpe = np.array([1.0, 1.0, 2.0, 0.5625])
    return float((counts[:4] * bpe).sum() * per_block + mo.tags.numel() * 8)


def phase_timing(ops, ref, Partition, cfg):
    """Kernel, plain and library times at the engine's shapes: the
    quantization of the wi weight view and the decode GEMM against it."""
    from repro_torch.core.formats import E4M3, E5M2, NVFP4
    from repro_torch.kernels.mixed_gemm import mixed_gemm_blocks
    from repro_torch.kernels.mor_select import mor_select_pack
    d, f = cfg.d_model, cfg.d_ff
    w = (torch.randn(2 * f, d, device="cuda") * 0.02).to(torch.bfloat16)
    part = Partition("block", (128, 128))
    _, safe_g = ops._group_amax(w)
    mg = torch.stack([ops._group_mantissa(safe_g, fmt, "gam")
                      for fmt in (E4M3, E5M2, NVFP4)] + [safe_g])
    sel_k = time_ms(lambda: mor_select_pack(w, mg, block=(128, 128),
                                            mode="sub3"))
    sel_t = time_ms(lambda: ref.quantize_pack_ref(w, part, "sub3"),
                    iters=2)
    mo_k, r_k = ops.quantize_pack(w, part, "sub3", backend="cuda")
    mo_t, r_t = ops.quantize_pack(w, part, "sub3", backend="torch")
    assert_pack_equal(mo_k, mo_t, r_k, r_t, "mor_select_pack timing shape")
    sel_err = float((mo_k.dequant().float()
                     - mo_t.dequant().float()).abs().max())
    n = w.numel()
    # x read once; payload_q, the bf16 lane, tags/scales/stats written.
    sel_bound = bound(2 * n + 1 * n + 2 * n + mo_k.tags.numel() * 24, 0.0)

    wq = mo_k.compact()
    x = torch.randn(4, d, device="cuda").to(torch.bfloat16)
    xa = ref.passthrough_mixed(x, (ref.activation_row_block(4, 128), 128))
    gk = time_ms(lambda: mixed_gemm_blocks(xa, wq), iters=20)
    gt = time_ms(lambda: ref.mixed_gemm_ref(xa, wq), iters=2)
    wdec = wq.dequant()
    glib = time_ms(lambda: torch.matmul(x, wdec.T), iters=20)
    yk = ops.mixed_dot(x, wq, out_dtype=torch.float32, backend="cuda")
    yt = ops.mixed_dot(x, wq, out_dtype=torch.float32, backend="torch")
    g_err = float((yk - yt).abs().max())
    check(bool(torch.all((yk - yt).abs() <= gemm_tol(
        x, wdec, yt, torch.float32))),
        f"mixed_gemm timing shape: max err {g_err} beyond 1e-5 sum|a||b|")
    N = w.shape[0]
    g_bound = bound(weight_bytes(wq) + x.numel() * 2 + 4 * N * 2,
                    2.0 * 4 * N * d)
    extra = {}
    for M in (32,):  # a prefill chunk
        xm = torch.randn(M, d, device="cuda").to(torch.bfloat16)
        xma = ref.passthrough_mixed(
            xm, (ref.activation_row_block(M, 128), 128))
        extra[f"mixed_gemm_M{M}_ms"] = time_ms(
            lambda: mixed_gemm_blocks(xma, wq), iters=10)
        extra[f"mixed_gemm_M{M}_bound_ms"] = bound(
            weight_bytes(wq) + M * d * 2 + M * N * 2, 2.0 * M * N * d)[0]
        extra[f"mixed_gemm_M{M}_library_ms"] = time_ms(
            lambda: torch.matmul(xm, wdec.T), iters=10)
    return {
        "mor_select_pack": dict(ms=sel_k, plain_ms=sel_t,
                                bound_ms=sel_bound[0],
                                bound_by=sel_bound[1], library_ms=None,
                                max_abs_err=sel_err,
                                shape=list(w.shape)),
        "mixed_gemm": dict(ms=gk, plain_ms=gt, bound_ms=g_bound[0],
                           bound_by=g_bound[1], library_ms=glib,
                           max_abs_err=g_err,
                           shape=[4, N, d]),
        "extra": extra,
    }


def phase_engine(cfg, n_layers):
    """The slice: full-width llama3-8b served by the Engine, with the
    launch counters zeroed just before and read just after."""
    from repro_torch.core.policy import MoRDotPolicy, MoRPolicy
    from repro_torch.kernels import mixed_gemm as mg_mod
    from repro_torch.kernels import mor_select as ms_mod
    from repro_torch.kernels import ref
    from repro_torch.models import init_params
    from repro_torch.serve import Engine, Request, ServeConfig
    from repro_torch.serve.quantized import param_bytes, tag_counts

    cfg = dataclasses.replace(cfg, n_layers=n_layers)
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    mg_mod.mixed_gemm_blocks.launches = 0
    ms_mod.mor_select_pack.launches = 0
    ref.mixed_gemm_ref.calls = 0
    ref.quantize_pack_ref.calls = 0
    t0 = time.perf_counter()
    eng = Engine(cfg, MoRDotPolicy(), params,
                 ServeConfig(slots=4, max_seq=512, prefill_chunk=32),
                 quantize=MoRPolicy(recipe="sub3"), device="cuda")
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    del params
    lengths = [5, 7, 19, 33, 48, 64, 77, 100]
    rng = np.random.default_rng(0)
    reqs = []
    for i, L in enumerate(lengths):
        kw = dict(temperature=0.8, top_k=40, seed=1) if i == 3 else {}
        reqs.append(Request(i, rng.integers(0, cfg.vocab, L).astype(
            np.int32), max_tokens=16, **kw))
    step_ms = {"decode": [], "prefill": []}

    def timed(fn, key):
        def wrapper(*a):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            step_ms[key].append((time.perf_counter() - t) * 1e3)
            return out
        return wrapper

    eng._decode_batch = timed(eng._decode_batch, "decode")
    eng._prefill_chunk_step = timed(eng._prefill_chunk_step, "prefill")
    for r in reqs:
        eng.submit(r)
    t0 = time.perf_counter()
    steps = eng.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"mixed_gemm": mg_mod.mixed_gemm_blocks.launches,
                "mor_select_pack": ms_mod.mor_select_pack.launches}
    plain = {"mixed_gemm_ref": ref.mixed_gemm_ref.calls,
             "quantize_pack_ref": ref.quantize_pack_ref.calls}

    for r in reqs:
        check(r.done and r.error is None, f"request {r.rid}: {r.error}")
        check(len(r.out) == 16 and all(0 <= t < cfg.vocab for t in r.out),
              f"request {r.rid}: tokens {r.out}")
    check(not eng.quarantined and not eng.rejected, "quarantine/reject")
    calls = eng.prefill_chunks + eng.decode_steps
    L = cfg.n_units
    check(launches["mixed_gemm"] == (4 * L + 1) * calls,
          f"mixed_gemm launches {launches['mixed_gemm']} != (4L+1) x "
          f"{calls} model calls")
    check(launches["mor_select_pack"] == 4 * L + 1,
          f"mor_select_pack launches {launches['mor_select_pack']} != "
          f"{4 * L + 1} quantized matrices")
    check(plain == {"mixed_gemm_ref": 0, "quantize_pack_ref": 0},
          f"plain versions ran on the main path: {plain}")
    profile = profile_decode(eng)
    tc = tag_counts(eng.params)
    tokens = sum(len(r.out) for r in reqs)
    engine = {
        "arch": cfg.name, "layers": L, "d_model": cfg.d_model,
        "d_ff": cfg.d_ff, "vocab": cfg.vocab, "n_heads": cfg.n_heads,
        "n_kv": cfg.n_kv, "slots": 4, "max_seq": 512, "prefill_chunk": 32,
        "quantize_s": quantize_s,
        "tag_fractions": {n: float(c) / float(tc.sum()) for n, c in
                          zip(("e4m3", "e5m2", "bf16", "nvfp4"), tc)},
        "weight_bytes": param_bytes(eng.params),
        "steps": steps, "prefill_chunks": eng.prefill_chunks,
        "decode_steps": eng.decode_steps,
        "decode_step_ms": float(np.median(step_ms["decode"])),
        "prefill_chunk_ms": float(np.median(step_ms["prefill"])),
        "wall_s": wall, "tokens": tokens, "tokens_per_s": tokens / wall,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches, "plain_calls": plain, "profile": profile,
    }
    del eng
    torch.cuda.empty_cache()
    return engine, launches


def profile_decode(eng, calls=3):
    """Device time by kernel over ``calls`` decode-shaped model calls
    (all slots on the trash page, the same work as a 4-slot decode
    step), from torch.profiler, and the device's busy share of the host
    wall time. PERF.md's breakdown rests on it, so a profile without
    device time fails the run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    slots = eng.scfg.slots
    bt = torch.full((slots, eng.pool.pages_per_seq), eng.pool.trash,
                    dtype=torch.int64, device=eng.device)
    toks = np.zeros((slots, 1), np.int32)
    cur = np.zeros(slots, np.int32)
    eng._step_fn(bt, toks, cur)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            eng._step_fn(bt, toks, cur)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        # Kernel events only: an operator's device time repeats theirs.
        dev_us = ev.self_device_time_total
        if ev.device_type == DeviceType.CUDA and dev_us > 0:
            rows.append((dev_us, ev.key, ev.count))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    check(any("mixed_gemm" in k for _, k, _ in rows),
          f"the decode profile shows no mixed_gemm kernel: {rows[:8]}")
    return {
        "calls": calls, "wall_ms_per_call": wall_ms / calls,
        "device_ms_per_call": busy_ms / calls,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "top": [{"name": k[:60], "ms_per_call": us / 1e3 / calls,
                 "count_per_call": c / calls} for us, k, c in rows[:8]],
    }


@contextlib.contextmanager
def patched(module, name, fn):
    """Temporarily replace ``module.name`` (the model layers look
    ``ops.mixed_dot`` up at call time)."""
    old = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, old)


def gemm_tol(x2, w, y_plain, out_dtype):
    """The kernel-vs-plain limit of one GEMM: 1e-5 * sum_k |a||b| (only
    the f32 summation order differs), plus one bf16 ulp of the result
    (<= 2^-7 |c|) for bf16 output."""
    tol = 1e-5 * (x2.double().abs() @ w.double().abs().T).float()
    if out_dtype == torch.bfloat16:
        tol = tol + 2.0**-7 * y_plain.float().abs()
    return tol


def checked_dot(ops, ref, seen):
    """``ops.mixed_dot`` that launches the kernel and holds every call
    against the plain version on the same inputs (and against an f64
    sum, for the order-noise figures); returns the kernel's result."""
    orig = ops.mixed_dot

    def dot(x2, mo, *, out_dtype=torch.bfloat16, backend="auto"):
        yk = orig(x2, mo, out_dtype=out_dtype, backend="cuda")
        yt = orig(x2, mo, out_dtype=out_dtype, backend="torch")
        w = ref.decode_mixed_ref(mo)[:mo.shape[0], :x2.shape[1]]
        ye = (x2.double() @ w.double().T).float().to(out_dtype)
        err = (yk.float() - yt.float()).abs()
        key = (x2.shape[0], mo.shape[0], x2.shape[1],
               str(out_dtype).split(".")[-1])
        check(bool(torch.all(err <= gemm_tol(x2, w, yt, out_dtype))),
              f"mixed_gemm M,N,K,out={key}: max err {float(err.max())} "
              "beyond 1e-5 sum|a||b| (+1 bf16 ulp)")
        s = seen.setdefault(key, {"calls": 0, "max_abs_err": 0.0,
                                  "kernel_vs_plain_differ": 0.0,
                                  "plain_vs_f64_differ": 0.0})
        s["calls"] += 1
        s["max_abs_err"] = max(s["max_abs_err"], float(err.max()))
        # Share of outputs whose rounding differs: summation order alone.
        s["kernel_vs_plain_differ"] = max(
            s["kernel_vs_plain_differ"], float((yk != yt).float().mean()))
        s["plain_vs_f64_differ"] = max(
            s["plain_vs_f64_differ"], float((yt != ye).float().mean()))
        return yk
    return dot


def phase_depth2(cfg, ops, ref):
    """A prefill chunk (4 rows x 8 tokens: M = 32) and a decode step
    (M = 4) of make_decode_fn at depth 2 and full width, on the same
    sub3 weights, three ways: the kernel path, the plain path, and a path
    whose GEMMs sum in f64. Every GEMM of the kernel path -- all five
    weight shapes, the f32 head included, at both M -- is held against
    the plain version on its real inputs at 1e-5 sum|a||b|; the kernel
    path is run twice and must repeat bit for bit."""
    from repro_torch.core.policy import MoRDotPolicy, MoRPolicy
    from repro_torch.models import init_cache, init_params, make_decode_fn
    from repro_torch.models.transformer import padded_vocab
    from repro_torch.serve.quantized import quantize_params

    cfg = dataclasses.replace(cfg, n_layers=2)
    params, _ = quantize_params(init_params(cfg, seed=1, device="cuda"),
                                MoRPolicy(recipe="sub3"))
    rng = np.random.default_rng(1)
    chunk = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 8))).cuda()
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 1))).cuda()

    def run(backend):
        fn = make_decode_fn(cfg, MoRDotPolicy(
            weight=MoRPolicy(backend=backend)))
        cache = init_cache(cfg, 4, 64, device="cuda")
        l1, cache, _ = fn(params, cache, chunk, torch.full((4,), 7).cuda())
        l2, cache, _ = fn(params, cache, tok, torch.full((4,), 8).cuda())
        return l1[..., :cfg.vocab], l2[..., :cfg.vocab]

    def f64_dot(x2, mo, *, out_dtype=torch.bfloat16, backend="auto"):
        w = ref.decode_mixed_ref(mo)[:mo.shape[0], :x2.shape[1]]
        return (x2.double() @ w.double().T).float().to(out_dtype)

    gemms = {}
    with patched(ops, "mixed_dot", checked_dot(ops, ref, gemms)):
        out = {"kernel": run("auto")}
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
    want = {(m, n, k) for m in (32, 4) for n, k in (
        ((cfg.n_heads + 2 * cfg.n_kv) * hd, d), (d, cfg.n_heads * hd),
        (2 * f, d), (d, f), (padded_vocab(cfg), d))}
    check(want <= {key[:3] for key in gemms},
          f"depth-2 GEMM shapes {sorted(gemms)} miss some of {sorted(want)}")
    again = run("auto")
    out["plain"] = run("torch")
    with patched(ops, "mixed_dot", f64_dot):
        out["f64"] = run("auto")
    res = {"gemms": [{"M": k[0], "N": k[1], "K": k[2], "out": k[3], **v}
                     for k, v in sorted(gemms.items())]}
    for i, what in enumerate(("prefill_chunk", "decode_step")):
        check(torch.equal(out["kernel"][i], again[i]),
              f"depth-2 {what}: the kernel path does not repeat")
        k, p, e = (out[n][i] for n in ("kernel", "plain", "f64"))
        r = res[what] = {
            "max_logit": float(p.abs().max()),
            "kernel_vs_plain": float((k - p).abs().max()),
            "kernel_vs_f64": float((k - e).abs().max()),
            "plain_vs_f64": float((p - e).abs().max()),
            "argmax_equal": bool(torch.equal(k.argmax(-1), p.argmax(-1))),
        }
        # Any two summation orders flip a few bf16 activations, and the
        # model carries those flips to the logits: the plain path is as
        # far from the f64 path as the kernel path is from either. The
        # kernel path may be at most twice as far from the f64 path as
        # the plain path; a wrong block or lane would be far beyond.
        check(r["kernel_vs_f64"] <= 2.0 * r["plain_vs_f64"],
              f"depth-2 {what}: kernel path {r['kernel_vs_f64']} from the "
              f"f64 path, plain path {r['plain_vs_f64']}")
    return res


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.core.partition import Partition
    from repro_torch.kernels import build, ops, ref

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    logs = build.build_all()
    emit({"build_s": time.perf_counter() - t0, "built": sorted(logs),
          "ptxas": {n: [ln.strip() for ln in log.splitlines()
                        if "registers" in ln or "spill" in ln]
                    for n, log in logs.items()},
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "card": smi})

    sel_err = phase_mor_select(ops, Partition)
    phase_mixed_gemm(ops, ref, Partition)
    cfg = get_config("llama3-8b")
    timing = phase_timing(ops, ref, Partition, cfg)
    engine, launches = phase_engine(cfg, N_LAYERS)
    depth2 = phase_depth2(cfg, ops, ref)

    kernels = []
    for name, src, replaces in (
        ("mor_select_pack", "src/repro_torch/csrc/mor_select.cu",
         "src/repro/kernels/mor_select.py:289"),
        ("mixed_gemm", "src/repro_torch/csrc/mixed_gemm.cu",
         "src/repro/kernels/mixed_gemm.py:214"),
    ):
        t = timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "shape": t["shape"], "card": smi,
        })
    emit({"parity_max_abs_err": {"mor_select_pack": sel_err}})
    emit({"timing_extra": timing["extra"], "card": smi})
    emit({"depth2": depth2, "card": smi})
    emit({"engine": engine, "card": smi})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
