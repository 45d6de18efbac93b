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
held against the plain version (the ``cuda``-marked test here, and
``chip_smoke.py`` at llama3-8b's shapes)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.flash_attention import flash_attention_fwd as jflash_fwd
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU or "
                    "interpret mode (chip_smoke.py runs them on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", tuple(DTYPES))
@pytest.mark.parametrize("causal", (True, False))
def test_kernel_matches_plain_version_on_card(dtype, causal, cuda_device):
    """The CUDA kernel against its plain version on the same CUDA
    tensors, GQA and folded, ragged extents, per-row offsets with rows
    that see no key; tolerance as against the reference."""
    S, T, hq, hkv, dh = 100, 300, 8, 2, 128
    _, (qt, kt, vt) = operands(
        [(2, S, hq, dh), (2, T, hkv, dh), (2, T, hkv, dh)], dtype, seed=3)
    qt, kt, vt = qt.to(cuda_device), kt.to(cuda_device), vt.to(cuda_device)
    off = torch.tensor([150, -20] * hq, dtype=torch.int32)
    for kw in ({}, {"q_offset": off}, {"q_offset": torch.tensor([7, 200])}):
        k = tops.flash_attention(qt, kt, vt, causal=causal, backend="cuda",
                                 **kw)
        t = tops.flash_attention(qt, kt, vt, causal=causal, backend="torch",
                                 **kw)
        assert_attention_close(t.cpu(), k.cpu(), vt.cpu(), dtype, str(kw))
