"""The port's per-block-scaled fp8 GEMM (``kernels.ops.fp8_gemm``, the
work of the ``fp8_gemm`` kernel) against the JAX package's: its plain
reference (``ops.fp8_gemm(backend='xla')``, ``ref.fp8_gemm_ref``) and
the Pallas kernel in interpret mode, on the reference suite's shapes
(``tests/test_kernels.py``) and one non-square block, with E4M3 and E5M2
payloads and f32 and bf16 output. The payloads cross between the
frameworks as uint8 bytes. Also: the wrapper's route
(``fp8_gemm_route``: wgmma or cuda_core, a pure function of the shape
and block), and blocks of N(0,1) * 1e-18 values, whose scales' product sa *
sb overflows f32 (the JAX Pallas kernel, which divides each partial by
sa * sb, gives 0 there; the XLA reference and the port dequantize
element by element).

Tolerance: |port - jax| <= 1e-6 * sum_k |a_k b_k| (the dequantized
operands, summed in f64) plus, for bf16 output, one bf16 ulp at |out|;
against the XLA reference on tiny blocks also the sum of the products
that are f32 denormals, which XLA on the CPU flushes and the port keeps.
The same f32 products are summed in PyTorch's and XLA's orders (the
Pallas kernel also divides each block's partial by sa * sb instead of
dequantizing the elements), which moves an f32 sum by a few ulps of the
sum of magnitudes; a bf16 result may then round the other way. On the
card the CUDA kernel is held against the plain version at 1e-5 (the
``cuda``-marked test here, and ``chip_smoke.py`` at llama3-8b's
shapes)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.formats import E4M3 as JE4M3
from repro.core.formats import E5M2 as JE5M2
from repro.core.gam import compute_scales
from repro.core.partition import Partition
from repro.kernels import ops as jops
from repro.kernels.fp8_gemm import fp8_gemm as jfp8_gemm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.fp8_gemm import (ROUTES, fp8_gemm_blocks,
                                          fp8_gemm_route)

FORMATS = {"e4m3": (JE4M3, jnp.float8_e4m3fn, torch.float8_e4m3fn),
           "e5m2": (JE5M2, jnp.float8_e5m2, torch.float8_e5m2)}
OUTS = {"f32": (jnp.float32, torch.float32),
        "bf16": (jnp.bfloat16, torch.bfloat16)}
# (M, N, K) and block (bm, bn, bk): the reference suite's shapes, then a
# non-square block.
SHAPES = [((128, 128, 128), (128, 128, 128)),
          ((256, 128, 384), (128, 128, 128)),
          ((128, 256, 256), (128, 128, 128)),
          ((256, 512, 256), (128, 256, 128))]


def operands(mnk, block, fmt, seed=1, scale=1.0, fmt_b=None):
    """Payloads and GAM block scales built as the reference suite builds
    them (scale, clip, cast), in JAX and as torch tensors: A and B of
    N(0,1) * ``scale`` values, A in ``fmt`` and B in ``fmt_b`` (default
    ``fmt``)."""
    M, N, K = mnk
    bm, bn, bk = block
    rng = np.random.default_rng(seed)
    a = jnp.asarray(rng.standard_normal((M, K)) * scale, jnp.float32)
    b = jnp.asarray(rng.standard_normal((K, N)) * scale, jnp.float32)
    fmts = (FORMATS[fmt], FORMATS[fmt_b or fmt])
    sa = compute_scales(a, Partition("block", (bm, bk)), fmts[0][0]).scale
    sb = compute_scales(b, Partition("block", (bk, bn)), fmts[1][0]).scale

    def quantize(x, s, r, c, f):
        jfmt, jdt, _ = f
        xb = x.reshape(x.shape[0] // r, r, x.shape[1] // c, c)
        xs = xb * s[:, None, :, None]
        return jnp.clip(xs, -jfmt.amax, jfmt.amax).astype(jdt).reshape(
            x.shape)

    aq = quantize(a, sa, bm, bk, fmts[0])
    bq = quantize(b, sb, bk, bn, fmts[1])

    def to_torch(x):
        tdt = torch.float8_e5m2 if x.dtype == jnp.float8_e5m2 else \
            torch.float8_e4m3fn
        return torch.from_numpy(np.asarray(x).view(np.uint8).copy()).view(tdt)

    jax_args = (aq, bq, sa, sb)
    torch_args = (to_torch(aq), to_torch(bq),
                  torch.from_numpy(np.asarray(sa).copy()),
                  torch.from_numpy(np.asarray(sb).copy()))
    return jax_args, torch_args


def dequantized(aq, bq, sa, sb, block):
    """The dequantized operands in f64."""
    bm, bn, bk = block
    a = np.asarray(aq, np.float64) / np.repeat(np.repeat(
        np.asarray(sa, np.float64), bm, 0), bk, 1)
    b = np.asarray(bq, np.float64) / np.repeat(np.repeat(
        np.asarray(sb, np.float64), bk, 0), bn, 1)
    return a, b


def magnitude_sums(aq, bq, sa, sb, block):
    """sum_k |a_k b_k| of the dequantized operands, in f64."""
    a, b = dequantized(aq, bq, sa, sb, block)
    return np.abs(a) @ np.abs(b)


def assert_gemm_close(want, got, mags, out, what):
    # `want` is the reference's array, or (on the card) the plain
    # version's tensor, which numpy cannot read in bf16.
    if isinstance(want, torch.Tensor):
        want = want.to(torch.float32).numpy()
    w = np.asarray(want, np.float32).astype(np.float64)
    g = got.to(torch.float32).numpy().astype(np.float64)
    assert w.shape == g.shape, what
    tol = 1e-6 * mags
    if out == "bf16":
        tol = tol + np.exp2(np.floor(np.log2(np.maximum(np.abs(w),
                                                        2.0**-126))) - 7)
    bad = np.abs(w - g) > tol
    assert not bad.any(), (f"{what}: {int(bad.sum())} beyond tolerance, "
                           f"max |diff| {np.abs(w - g).max()}")


CASES = [(s, f, o) for s in range(len(SHAPES)) for f in FORMATS for o in OUTS]


@pytest.mark.parametrize("shape,fmt,out", CASES, ids=str)
def test_matches_reference(shape, fmt, out):
    mnk, block = SHAPES[shape]
    jargs, targs = operands(mnk, block, fmt)
    want = jops.fp8_gemm(*jargs, block=block, out_dtype=OUTS[out][0],
                         backend="xla")
    got = tops.fp8_gemm(*targs, block=block, out_dtype=OUTS[out][1])
    assert got.dtype == OUTS[out][1]
    assert_gemm_close(want, got, magnitude_sums(*jargs, block), out,
                      f"{mnk} {block} {fmt} {out}")


@pytest.mark.parametrize("shape,fmt,out", CASES, ids=str)
def test_matches_pallas_kernel_interpreted(shape, fmt, out):
    mnk, block = SHAPES[shape]
    jargs, targs = operands(mnk, block, fmt, seed=2)
    want = jfp8_gemm(*jargs, block=block, out_dtype=OUTS[out][0],
                     interpret=True)
    got = tops.fp8_gemm(*targs, block=block, out_dtype=OUTS[out][1])
    assert_gemm_close(want, got, magnitude_sums(*jargs, block), out,
                      f"{mnk} {block} {fmt} {out}")


def test_dequantized_product_approximates_the_f32_gemm():
    """As the reference suite checks: fp8 payloads with GAM scales give a
    product near the unquantized one."""
    M, N, K = 128, 256, 256
    _, targs = operands((M, N, K), (128, 128, 128), "e4m3", seed=1)
    rng = np.random.default_rng(1)
    a, b = rng.standard_normal((M, K)), rng.standard_normal((K, N))
    exact = a @ b
    got = tops.fp8_gemm(*targs, out_dtype=torch.float32).numpy()
    assert np.median(np.abs(got - exact) / (np.abs(exact) + 1e-2)) < 0.1


def test_rejects_what_the_reference_cannot_take():
    _, (aq, bq, sa, sb) = operands((128, 128, 128), (128, 128, 128), "e4m3")
    with pytest.raises(ValueError, match="divisible"):
        tops.fp8_gemm(aq, bq, sa, sb, block=(128, 128, 96))
    with pytest.raises(ValueError, match="contraction"):
        tops.fp8_gemm(aq, bq[:64], sa, sb)
    with pytest.raises(ValueError, match="b_scale"):
        tops.fp8_gemm(aq, bq, sa, sb[:, :0])
    with pytest.raises(TypeError, match="float8"):
        tops.fp8_gemm(aq.float(), bq, sa, sb)
    with pytest.raises(TypeError, match="out_dtype"):
        tops.fp8_gemm(aq, bq, sa, sb, out_dtype=torch.float16)


def test_cpu_tensors_take_the_plain_version():
    _, targs = operands((128, 128, 128), (128, 128, 128), "e5m2")
    calls = tref.fp8_gemm_ref.calls
    tops.fp8_gemm(*targs)
    assert tref.fp8_gemm_ref.calls == calls + 1
    with pytest.raises(ValueError, match="CUDA"):
        tops.fp8_gemm(*targs, backend="cuda")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU or "
                    "interpret mode (chip_smoke.py runs them on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", range(len(SHAPES)))
@pytest.mark.parametrize("fmt", tuple(FORMATS))
def test_kernel_matches_plain_version_on_card(shape, fmt, cuda_device):
    """The CUDA kernel against its plain version on the same CUDA
    tensors: within 1e-5 sum|a b| (+ one bf16 ulp for bf16 out)."""
    mnk, block = SHAPES[shape]
    jargs, targs = operands(mnk, block, fmt)
    targs = [t.to(cuda_device) for t in targs]
    mags = magnitude_sums(*jargs, block)
    for out in OUTS:
        k = tops.fp8_gemm(*targs, block=block, out_dtype=OUTS[out][1],
                          backend="cuda")
        t = tops.fp8_gemm(*targs, block=block, out_dtype=OUTS[out][1],
                          backend="torch")
        assert_gemm_close(t.cpu(), k.cpu(), 10 * mags, out, f"{mnk} {out}")


# (M, N, K), block -> route the wrapper must pick: the wgmma route where each
# 64 x 128 slab lies in one scale block and a 64-deep stage in one K
# block, the CUDA-core kernel for every other block the contract allows.
PLAN_CASES = [
    ((2048, 6144, 4096), (128, 128, 128), "wgmma"),
    ((2048, 28672, 4096), (128, 128, 128), "wgmma"),
    ((256, 512, 256), (128, 256, 128), "wgmma"),
    ((192, 256, 384), (64, 128, 128), "wgmma"),
    ((192, 256, 320), (64, 128, 64), "cuda_core"),
    ((128, 256, 512), (128, 128, 256), "wgmma"),
    ((128, 128, 128), (128, 128, 32), "cuda_core"),
    ((128, 128, 128), (128, 64, 128), "cuda_core"),
    ((96, 128, 128), (32, 128, 128), "cuda_core"),
    ((256, 384, 192), (128, 128, 96), "cuda_core"),
]


@pytest.mark.parametrize("mnk,block,route", PLAN_CASES, ids=str)
def test_plan_picks_the_route_from_the_shape(mnk, block, route):
    M, N, K = mnk
    assert route in ROUTES
    assert fp8_gemm_route(M, N, K, block) == route
    assert fp8_gemm_route(M, N, K, block) == route  # a pure function


# Blocks and shapes the reference takes and the kernels cannot: a K block
# of no whole 32-deep steps, N not a multiple of 16. The wrapper raises
# before it looks at the device.
KERNEL_REFUSALS = [((128, 128, 128), (128, 128, 16), "steps K by 32"),
                   ((128, 8, 128), (128, 8, 128), "multiple of 16")]


@pytest.mark.parametrize("mnk,block,match", KERNEL_REFUSALS, ids=str)
def test_wrapper_refuses_what_its_kernels_cannot_take(mnk, block, match):
    _, targs = operands(mnk, block, "e4m3")
    with pytest.raises(ValueError, match=match):
        fp8_gemm_blocks(*targs, block=block)


def flushable_mass(a, b):
    """sum_k |a_k b_k| over the products below f32's smallest normal,
    2^-126: what XLA on the CPU, which flushes f32 denormals, may drop
    from an output that IEEE arithmetic keeps."""
    out = np.zeros((a.shape[0], b.shape[1]))
    for k in range(a.shape[1]):
        p = np.abs(np.outer(a[:, k], b[k]))
        out += np.where(p < 2.0**-126, p, 0.0)
    return out


@pytest.mark.parametrize("out", tuple(OUTS))
def test_tiny_blocks_follow_the_xla_reference(out):
    """Both operands' blocks at N(0,1) * 1e-18: sa * sb overflows f32.
    The port's plain version dequantizes element by element as the XLA
    reference does: in IEEE arithmetic it matches an f64 sum of the
    dequantized operands within the file's tolerance, and it matches the
    XLA reference within that tolerance plus the mass of the products
    that are f32 denormals (~1% of these), which XLA on the CPU flushes.
    The Pallas kernel in interpret mode divides each partial by sa * sb =
    inf and gives 0 everywhere."""
    mnk, block = (256, 256, 512), (128, 128, 128)
    jargs, targs = operands(mnk, block, "e4m3", seed=4, scale=1e-18)
    aq, bq, sa, sb = jargs
    assert np.all(np.isinf(np.asarray(sa)[:, :, None]
                           * np.asarray(sb)[None, :, :]))
    jdt, tdt = OUTS[out]
    got = tops.fp8_gemm(*targs, block=block, out_dtype=tdt)
    a, b = dequantized(*jargs, block)
    mags = magnitude_sums(*jargs, block)
    exact = a @ b
    assert np.abs(exact).max() > 1e-36
    assert_gemm_close(exact.astype(np.float32), got, mags, out,
                      f"tiny blocks {out} vs f64")
    want = jops.fp8_gemm(*jargs, block=block, out_dtype=jdt, backend="xla")
    assert_gemm_close(want, got, mags + 1e6 * flushable_mass(a, b), out,
                      f"tiny blocks {out} vs xla")
    pallas = jfp8_gemm(*jargs, block=block, out_dtype=jdt, interpret=True)
    assert not np.any(np.asarray(pallas, np.float32))


# Card cases beyond the reference suite's shapes, each on the route the
# wrapper picks for its block. wgmma: mixed formats, a 64-row block with a
# ragged last tile (M = 192), a 256-deep K block, tiny blocks; cuda_core:
# a 32-deep and a 64-deep K block, a 64-column block, tiny blocks.
CARD_CASES = [
    ((256, 512, 256), (128, 128, 128), "e4m3", "e5m2", 1.0),
    ((256, 512, 256), (128, 256, 128), "e5m2", "e4m3", 1.0),
    ((192, 256, 384), (64, 128, 128), "e4m3", "e4m3", 1.0),
    ((128, 256, 512), (128, 128, 256), "e5m2", "e5m2", 1.0),
    ((256, 256, 512), (128, 128, 128), "e4m3", "e4m3", 1e-18),
    ((256, 256, 512), (128, 128, 32), "e5m2", "e4m3", 1.0),
    ((192, 256, 320), (64, 128, 64), "e4m3", "e5m2", 1.0),
    ((256, 512, 256), (128, 64, 128), "e5m2", "e5m2", 1.0),
    ((256, 256, 512), (128, 128, 32), "e4m3", "e4m3", 1e-18),
]


@pytest.mark.cuda
@pytest.mark.parametrize("mnk,block,fa,fb,scale", CARD_CASES, ids=str)
def test_routes_match_plain_version_on_card(mnk, block, fa, fb, scale,
                                            cuda_device):
    """The route the wrapper picks against the plain version on the same
    CUDA tensors, within 1e-5 sum|a b| (+ one bf16 ulp), f32 and bf16
    out; each call counted on its route; a repeat is bit-identical."""
    jargs, targs = operands(mnk, block, fa, seed=6, scale=scale, fmt_b=fb)
    targs = [t.to(cuda_device) for t in targs]
    mags = magnitude_sums(*jargs, block)
    route = fp8_gemm_route(*mnk, block)
    for out in OUTS:
        t = tops.fp8_gemm(*targs, block=block, out_dtype=OUTS[out][1],
                          backend="torch")
        before = dict(fp8_gemm_blocks.launches_by_route)
        k = fp8_gemm_blocks(*targs, block=block, out_dtype=OUTS[out][1])
        k2 = fp8_gemm_blocks(*targs, block=block, out_dtype=OUTS[out][1])
        assert fp8_gemm_blocks.launches_by_route[route] == before[route] + 2
        assert torch.equal(k, k2), f"{mnk} {route} {out}: repeat differs"
        if scale < 1.0:
            assert float(t.float().abs().max()) > 0.0
        assert_gemm_close(t.cpu(), k.cpu(), 10 * mags, out,
                          f"{mnk} {block} {fa}x{fb} {route} {out}")
