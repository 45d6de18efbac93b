"""The port's flash attention entry point (``kernels.ops.flash_attention``,
the work of the ``flash_attention`` kernel) against the JAX package's:
``ops.flash_attention(backend='xla')`` (its plain reference) in the 4-D
GQA layout (G = 1, 2, 4) and the 3-D folded layout, causal and full, f32
and bf16, S = T and S < T with the default, a scalar, a per-batch and a
per-row query offset, and rows with no visible key; the Pallas kernel
itself (interpret mode) on rows with visible keys; and the ValueErrors
of both wrappers.

Tolerances. Against the reference function: |port - jax| <= 1e-5 *
max|v| + one ulp of the output dtype at |out| -- the two sum the same
f32 terms in other orders (PyTorch's and XLA's matmuls) and their f32
exps may differ in the last bit, which can flip a bf16 rounding. Against
the Pallas kernel: the reference suite's own tolerance
(``tests/test_kernels.py``: rtol 2e-2, atol 2e-6 for f32, 2e-2 for
bf16), since the kernel's online softmax differs from both. A row with
no visible key is, in the reference and the port, the mean of v over
all T keys (within the same tolerance). On the card the CUDA kernel is
held against the plain version (the ``cuda``-marked tests here, and
``chip_smoke.py`` at llama3-8b's shapes).

The ``wgmma`` route (bf16, d 64 or 128; ``flash_route``) runs on the
tensor cores: bf16 q k^T with f32 sums, an online softmax in base 2 over
128-key tiles, and p v with p split into two bf16 terms (hi = bf16(p),
lo = bf16(p - hi)), f32 sums. Its rounding is emulated here in plain
PyTorch and held against the reference under the same tolerance, with
f32 and bf16 outputs; a single bf16 p breaks that tolerance, which is
why the kernel splits p."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.flash_attention import flash_attention_fwd as jflash_fwd
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import flash_route

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
B, HQ, DH = 2, 4, 32


def to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(a.copy())


def operands(shapes, dtype, seed):
    """The same numpy-made q, k, v in both frameworks."""
    rng = np.random.default_rng(seed)
    jd = DTYPES[dtype][0]
    js = [jnp.asarray(rng.standard_normal(s), jd) for s in shapes]
    return js, [to_torch(j) for j in js]


def ulp(x: np.ndarray, dtype: str) -> np.ndarray:
    """One ulp of ``dtype`` at |x| (upper bound: 2^(e - mantissa bits))."""
    bits = 23 if dtype == "f32" else 7
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0**-126)))
    return np.exp2(e - bits)


def err_over_tol(want, got, v, dtype) -> float:
    """Largest |want - got| / (1e-5 max|v| + one ulp of ``dtype`` at
    |want|): the tolerance of assert_attention_close, as a ratio."""
    w = np.asarray(want, np.float32).astype(np.float64)
    g = got.to(torch.float32).numpy().astype(np.float64)
    v = v.to(torch.float32).numpy() if isinstance(v, torch.Tensor) else v
    tol = 1e-5 * float(np.abs(np.asarray(v, np.float32)).max()) + ulp(
        w, dtype)
    return float((np.abs(w - g) / tol).max())


def assert_attention_close(want, got, v, dtype, what):
    if isinstance(v, torch.Tensor):
        v = v.to(torch.float32).numpy()
    # `want` is the reference's array, or (on the card) the plain
    # version's tensor, which numpy cannot read in bf16.
    if isinstance(want, torch.Tensor):
        want = want.to(torch.float32).numpy()
    w = np.asarray(want, np.float32).astype(np.float64)
    g = got.to(torch.float32).numpy().astype(np.float64)
    assert w.shape == g.shape, (what, w.shape, g.shape)
    tol = 1e-5 * float(np.abs(np.asarray(v, np.float32)).max()) + ulp(
        w, dtype)
    bad = np.abs(w - g) > tol
    assert not bad.any(), (f"{what}: {int(bad.sum())} outputs beyond "
                           f"tolerance, max |diff| {np.abs(w - g).max()}")


def offsets(kind, S, T, rows):
    """The numpy query offset (or None) of one offset case; ``rows`` is
    the count of folded rows a per-row offset needs."""
    rng = np.random.default_rng(len(kind) + rows)
    if kind in ("same", "default"):
        return None
    if kind == "scalar":
        return np.int32(T - S - 5)
    if kind == "per_batch":
        return rng.integers(0, T - S + 1, B).astype(np.int32)
    if kind == "per_row":
        return rng.integers(0, T - S + 1, rows).astype(np.int32)
    if kind == "negative":  # the first rows of some folded rows see no key
        off = rng.integers(0, T - S + 1, rows).astype(np.int32)
        off[::3] = -6
        return off
    raise ValueError(kind)


CAUSAL_OFFSETS = ("same", "default", "scalar", "per_batch", "per_row",
                  "negative")
GQA_CASES = ([(g, True, o, dt) for g in (1, 2, 4) for o in CAUSAL_OFFSETS
              for dt in DTYPES]
             + [(g, False, "default", dt) for g in (1, 2, 4) for dt in DTYPES])


@pytest.mark.parametrize("G,causal,offset,dtype", GQA_CASES, ids=str)
def test_gqa_layout_matches_reference(G, causal, offset, dtype):
    S, T = (32, 32) if offset == "same" else (16, 48)
    hkv = HQ // G
    (qj, kj, vj), (qt, kt, vt) = operands(
        [(B, S, HQ, DH), (B, T, hkv, DH), (B, T, hkv, DH)], dtype,
        seed=G * 10 + len(offset))
    off = offsets(offset, S, T, B * HQ)
    want = jops.flash_attention(
        qj, kj, vj, causal=causal, backend="xla",
        q_offset=None if off is None else jnp.asarray(off))
    got = tops.flash_attention(
        qt, kt, vt, causal=causal,
        q_offset=None if off is None else torch.from_numpy(np.asarray(off)))
    assert got.shape == (B, S, HQ, DH) and got.dtype == qt.dtype
    assert_attention_close(want, got, vj, dtype,
                           f"G={G} causal={causal} {offset} {dtype}")


FOLDED_CASES = ([(True, o, dt) for o in CAUSAL_OFFSETS if o != "per_batch"
                 for dt in DTYPES]
                + [(False, "default", dt) for dt in DTYPES])


@pytest.mark.parametrize("causal,offset,dtype", FOLDED_CASES, ids=str)
def test_folded_layout_matches_reference(causal, offset, dtype):
    BH = 6
    S, T = (24, 24) if offset == "same" else (8, 40)
    (qj, kj, vj), (qt, kt, vt) = operands(
        [(BH, S, DH), (BH, T, DH), (BH, T, DH)], dtype, seed=len(offset))
    off = offsets(offset, S, T, BH)
    want = jops.flash_attention(
        qj, kj, vj, causal=causal, backend="xla",
        q_offset=None if off is None else jnp.asarray(off))
    got = tops.flash_attention(qt, kt, vt, causal=causal, q_offset=off)
    assert_attention_close(want, got, vj, dtype,
                           f"folded causal={causal} {offset} {dtype}")


@pytest.mark.parametrize("dtype", tuple(DTYPES))
def test_rows_without_visible_key_average_v(dtype):
    """q_offset + row < 0: no key is visible; the reference's softmax over
    T scores of -1e30 weights every key alike, so the row is the mean of
    v over all T keys -- the port's plain version gives the same."""
    BH, S, T = 3, 8, 20
    _, (qt, kt, vt) = operands([(BH, S, DH), (BH, T, DH), (BH, T, DH)],
                               dtype, seed=5)
    off = np.array([-4, -8, 3], np.int32)
    got = tops.flash_attention(qt, kt, vt, q_offset=off)
    mean = vt.to(torch.float32).mean(dim=1)
    for bh, o in enumerate(off):
        for row in range(S):
            if o + row >= 0:
                continue
            assert_attention_close(mean[bh].numpy(), got[bh, row], vt,
                                   dtype, f"row {bh},{row}")
    assert (off[:, None] + np.arange(S) < 0).sum() == 4 + 8


PALLAS_CASES = [(c, dt, o) for c in (True, False) for dt in DTYPES
                for o in ("same", "per_row")]


@pytest.mark.parametrize("causal,dtype,offset", PALLAS_CASES, ids=str)
def test_matches_pallas_kernel_interpreted(causal, dtype, offset):
    """The TPU kernel itself (interpret mode) on rows that see a key."""
    BH = 4
    S, T = (64, 64) if offset == "same" else (16, 64)
    (qj, kj, vj), (qt, kt, vt) = operands(
        [(BH, S, DH), (BH, T, DH), (BH, T, DH)], dtype, seed=9)
    off = offsets(offset, S, T, BH)
    want = jflash_fwd(qj, kj, vj, causal=causal, block_q=16, block_k=32,
                      q_offset=None if off is None else jnp.asarray(off),
                      interpret=True)
    got = tops.flash_attention(qt, kt, vt, causal=causal, q_offset=off,
                               block_q=16, block_k=32)
    atol = 2e-6 if dtype == "f32" else 2e-2
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), rtol=2e-2,
                               atol=atol)


def _bad_inputs(fw):
    """The reference suite's rejection matrix, in framework ``fw``."""
    rng = np.random.default_rng(70)

    def arr(shape):
        a = rng.standard_normal(shape).astype(np.float32)
        return jnp.asarray(a) if fw == "jax" else torch.from_numpy(a)

    q, k = arr((2, 8, 16)), arr((2, 16, 16))
    q4, k4, v4 = arr((2, 8, 3, 16)), arr((2, 8, 2, 16)), arr((2, 8, 2, 16))
    off3 = np.zeros(3, np.int32)
    return [
        ("folded", (q[0], k, k), {}),
        ("match", (q, k, k[:1]), {}),
        ("positive", (q, k, k), {"block_q": 0}),
        ("q_offset", (q, k, k),
         {"q_offset": jnp.asarray(off3) if fw == "jax" else off3}),
        ("GQA", (q4, k4, v4), {}),
        ("4-D q needs matching", (q4, k, k), {}),
        ("q_offset", (arr((2, 8, 4, 16)), k4, v4),
         {"q_offset": jnp.asarray(off3) if fw == "jax" else off3}),
    ]


@pytest.mark.parametrize("case", range(7))
def test_rejects_what_the_reference_rejects(case):
    """The same inputs raise a ValueError with the same words in the
    JAX wrapper (launcher checks, interpret backend) and the port's."""
    match, args, kw = _bad_inputs("jax")[case]
    with pytest.raises(ValueError, match=match):
        jops.flash_attention(*args, backend="interpret", **kw)
    match, args, kw = _bad_inputs("torch")[case]
    with pytest.raises(ValueError, match=match):
        tops.flash_attention(*args, **kw)


def test_cpu_tensors_take_the_plain_version():
    _, (qt, kt, vt) = operands([(2, 8, 32), (2, 8, 32), (2, 8, 32)], "f32",
                               seed=1)
    calls = tref.flash_attention_ref.calls
    tops.flash_attention(qt, kt, vt)
    assert tref.flash_attention_ref.calls == calls + 1
    with pytest.raises(ValueError, match="CUDA"):
        tops.flash_attention(qt, kt, vt, backend="cuda")


@pytest.mark.parametrize("dtype", tuple(DTYPES))
@pytest.mark.parametrize("d", (32, 64, 128))
def test_flash_route_by_dtype_and_head_dim(dtype, d):
    """bf16 with d 64 or 128 takes the tensor cores; f32 (whose products
    must not meet TF32 or bf16) and d = 32 take the CUDA-core kernel."""
    want = "wgmma" if dtype == "bf16" and d in (64, 128) else "cuda_core"
    assert flash_route(DTYPES[dtype][1], d) == want


WGMMA_BK = 128  # keys of one tile of the wgmma route
LOG2E = 1.4426950408889634


def wgmma_route_emulation(split: bool, out_f32: bool):
    """A stand-in for ``kernels.ref.flash_attention_ref`` (folded q (BH, S,
    d), k / v (BH, T, d), (BH,) offsets) that rounds as the wgmma route
    does: bf16 products summed in f32, an online softmax over 128-key
    tiles in f32 with the max taken on the unscaled scores and p =
    2^(s c - m c), c the launcher's f32 d^-0.5 log2 e, s c - m c rounded
    once (the kernel's FFMA), then p v with p as hi + lo (two bf16 terms,
    ``split``) or as one bf16 value, f32 sums, and the IEEE division by
    max(l, 1e-30). Returns f32 (``out_f32``) or q's dtype."""
    def emulated(q, k, v, causal, q_offset):
        BH, S, d = q.shape
        T = k.shape[1]
        qf, kf, vf = (x.to(torch.float32) for x in (q, k, v))
        sl2 = torch.tensor(d ** -0.5 * LOG2E, dtype=torch.float32)
        pos = q_offset.to(torch.int64)[:, None] + torch.arange(S)
        m = torch.full((BH, S), -1e30)
        l = torch.zeros(BH, S)
        o = torch.zeros(BH, S, d)
        for k0 in range(0, T, WGMMA_BK):
            keys = torch.arange(k0, min(k0 + WGMMA_BK, T))
            x = torch.einsum("bqd,bkd->bqk", qf, kf[:, keys])
            if causal:
                x = torch.where(keys[None, None, :] > pos[:, :, None],
                                torch.tensor(-1e30), x)
                x = torch.where((pos < 0)[:, :, None], torch.tensor(0.0), x)
            m_new = torch.maximum(m, x.amax(dim=-1))
            ms_new = m_new * sl2
            corr = torch.exp2(m * sl2 - ms_new)
            # The FFMA: the exact f64 product less m c, rounded once.
            p = torch.exp2((x.to(torch.float64) * sl2.to(torch.float64)
                            - ms_new.to(torch.float64)[..., None]
                            ).to(torch.float32))
            l = l * corr + p.sum(dim=-1)
            hi = p.to(torch.bfloat16).to(torch.float32)
            pv = hi @ vf[:, keys]
            if split:
                lo = (p - hi).to(torch.bfloat16).to(torch.float32)
                pv = pv + lo @ vf[:, keys]
            o = o * corr[..., None] + pv
            m = m_new
        out = torch.div(o, l.clamp_min(1e-30)[..., None])
        return out if out_f32 else out.to(q.dtype)
    return emulated


# (layout, causal, offset kind, q and k scale): G = 4 GQA and folded,
# causal with the default offset and with rows that see no key, full; a
# causal case with scores ~8x larger.
EMULATED_CASES = [(lay, c, o, 1.0) for lay in ("gqa", "folded")
                  for c, o in ((True, "default"), (True, "negative"),
                               (False, "default"))]
EMULATED_CASES += [("gqa", True, "default", 8.0)]


def emulated_run(layout, causal, offset, scale, split, out, monkeypatch):
    """The reference (XLA, from the bf16 operands' values in f32 or bf16)
    and the port's ops.flash_attention with the wgmma route's emulated
    rounding in place of its plain version; returns (want, got, v)."""
    S, T, hq, dh = 64, 300, 4, 64
    if layout == "gqa":
        shapes = [(B, S, hq, dh), (B, T, 1, dh), (B, T, 1, dh)]
    else:
        shapes = [(B * hq, S, dh), (B * hq, T, dh), (B * hq, T, dh)]
    (qj, kj, vj), (qt, kt, vt) = operands(shapes, "bf16", seed=31)
    if scale != 1.0:
        qj, kj = (x * jnp.asarray(scale, jnp.bfloat16) for x in (qj, kj))
        qt, kt = to_torch(qj), to_torch(kj)
    off = offsets(offset, S, T, B * hq)
    jd = jnp.float32 if out == "f32" else jnp.bfloat16
    want = jops.flash_attention(
        qj.astype(jd), kj.astype(jd), vj.astype(jd), causal=causal,
        backend="xla", q_offset=None if off is None else jnp.asarray(off))
    monkeypatch.setattr(tref, "flash_attention_ref",
                        wgmma_route_emulation(split, out == "f32"))
    got = tops.flash_attention(
        qt, kt, vt, causal=causal,
        q_offset=None if off is None else torch.from_numpy(np.asarray(off)))
    return want, got, vt


@pytest.mark.parametrize("out", ("f32", "bf16"))
@pytest.mark.parametrize("layout,causal,offset,scale", EMULATED_CASES,
                         ids=str)
def test_wgmma_route_rounding_within_tolerance(layout, causal, offset, scale,
                                               out, monkeypatch):
    """The wgmma route's arithmetic (emulated) against the reference
    within the file's tolerance: the error budget of the split p on the
    CPU, before the card shows it (chip_smoke.py holds the kernel to the
    same flash_tol)."""
    want, got, v = emulated_run(layout, causal, offset, scale, True, out,
                                monkeypatch)
    assert_attention_close(want, got, v, out,
                           f"{layout} causal={causal} {offset} x{scale} {out}")


@pytest.mark.parametrize("out", ("f32", "bf16"))
def test_single_bf16_p_breaks_tolerance(out, monkeypatch):
    """p rounded once to bf16 (~2^-9 a weight) misses the tolerance that
    the split p keeps: why the route multiplies by hi and lo."""
    want, got, v = emulated_run("gqa", True, "default", 1.0, False, out,
                                monkeypatch)
    assert err_over_tol(want, got, v, out) > 4.0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU or "
                    "interpret mode (chip_smoke.py runs them on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dh", (64, 128))
@pytest.mark.parametrize("dtype", tuple(DTYPES))
@pytest.mark.parametrize("causal", (True, False))
def test_kernel_matches_plain_version_on_card(dtype, causal, dh,
                                              cuda_device):
    """The CUDA kernel of ``flash_route``'s route (bf16: wgmma; f32:
    cuda_core) against its plain version on the same CUDA tensors, GQA
    and folded, ragged extents, per-row offsets with rows that see no
    key; tolerance as against the reference."""
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    S, T, hq, hkv = 100, 300, 8, 2
    _, (qt, kt, vt) = operands(
        [(2, S, hq, dh), (2, T, hkv, dh), (2, T, hkv, dh)], dtype, seed=3)
    qt, kt, vt = qt.to(cuda_device), kt.to(cuda_device), vt.to(cuda_device)
    route = flash_route(qt.dtype, dh)
    assert route == ("wgmma" if dtype == "bf16" else "cuda_core")
    off = torch.tensor([150, -20] * hq, dtype=torch.int32)
    fold = {"q": qt.movedim(2, 1).reshape(2 * hq, S, dh).contiguous(),
            "k": kt.repeat_interleave(hq // hkv, dim=2).movedim(2, 1)
            .reshape(2 * hq, T, dh).contiguous()}
    fold["v"] = vt.repeat_interleave(hq // hkv, dim=2).movedim(2, 1).reshape(
        2 * hq, T, dh).contiguous()
    for args in ((qt, kt, vt), (fold["q"], fold["k"], fold["v"])):
        for kw in ({}, {"q_offset": off},
                   {"q_offset": torch.tensor([7, 200])}):
            if args[0].ndim == 3 and kw.get("q_offset") is not None \
                    and kw["q_offset"].numel() == 2:
                continue  # a per-batch offset is a 4-D layout's
            before = flash_attention_fwd.launches_by_route[route]
            k = tops.flash_attention(*args, causal=causal, backend="cuda",
                                     **kw)
            assert flash_attention_fwd.launches_by_route[route] == before + 1
            t = tops.flash_attention(*args, causal=causal, backend="torch",
                                     **kw)
            assert_attention_close(t.cpu(), k.cpu(), args[2].cpu(), dtype,
                                   f"{args[0].ndim}-D {kw}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", tuple(DTYPES))
def test_nan_in_the_next_batch_stays_out_on_card(dtype, cuda_device):
    """A ragged T with NaN in batch 1's first v rows: batch 0's keys past
    T read as zeros (the wgmma route's 3-D TMA maps; the cuda_core
    route's row bound), so batch 0 stays finite and within tolerance."""
    S, T, hq, hkv, dh = 100, 300, 8, 2, 128
    _, (qt, kt, vt) = operands(
        [(2, S, hq, dh), (2, T, hkv, dh), (2, T, hkv, dh)], dtype, seed=4)
    vt[1, :4] = float("nan")
    qt, kt, vt = qt.to(cuda_device), kt.to(cuda_device), vt.to(cuda_device)
    for causal in (True, False):
        k = tops.flash_attention(qt, kt, vt, causal=causal, backend="cuda")
        t = tops.flash_attention(qt, kt, vt, causal=causal, backend="torch")
        assert bool(torch.isfinite(k[0]).all())
        assert_attention_close(t[0].cpu(), k[0].cpu(), vt[0].cpu(), dtype,
                               f"batch 0, causal={causal}")
