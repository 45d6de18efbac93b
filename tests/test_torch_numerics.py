"""Numerics foundation of the PyTorch port against the JAX reference:
formats (fp8 casts, the E2M1 snap and codes, two-level NVFP4), Alg. 1
GAM scaling and partitions. Everything here must agree bit for bit:
full fp8 and bf16 grids, random f32 with exponents in +-20, zeros,
denormals, NaN and Inf. A NaN may differ in sign or payload bits
between the frameworks, so NaN positions are compared as positions.

f32 denormals: XLA on the CPU treats them as zero in arithmetic and
comparisons, the port follows IEEE (as does its CUDA code, built
without fast-math). Casts agree on them; where arithmetic or a sign
test sees one, the two differ, and test_f32_denormal_divergence pins
exactly that.

The reference is compiled whole (``jit_ref``): run op by op, JAX
compiles every primitive separately, which took most of the time."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as jf
from repro.core import gam as jg
from repro.core import partition as jp
from repro_torch.core import formats as tf
from repro_torch.core import gam as tg
from repro_torch.core import partition as tp

FMT_NAMES = ("e4m3", "e5m2", "bf16", "nvfp4")


def jit_ref(fn):
    """``fn`` compiled by XLA with its excess precision off, so every
    bf16 op rounds as written (as in the port)."""
    return jax.jit(fn, compiler_options={"xla_allow_excess_precision": False})


def to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(a.copy())


def to_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def assert_bits_equal(j, t, what=""):
    """Same values bit for bit; NaNs compared by position only."""
    a, b = np.asarray(j), to_numpy(t)
    if a.dtype.name == "bfloat16":
        a = a.view(np.uint16)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    if a.dtype.kind == "f":
        an, bn = np.isnan(a), np.isnan(b)
        np.testing.assert_array_equal(an, bn, err_msg=f"{what}: NaN mask")
        bits = {4: np.uint32, 8: np.uint64}[a.dtype.itemsize]
        np.testing.assert_array_equal(a[~an].view(bits), b[~bn].view(bits),
                                      err_msg=what)
    else:
        np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=what)


def is_denormal(a) -> np.ndarray:
    a = np.abs(np.asarray(a, np.float32))
    return (a > 0) & (a < np.float32(2.0**-126))


def special_f32(denormals: bool = True) -> np.ndarray:
    """Every bf16 bit pattern, both fp8 grids with their midpoints, random
    f32 with exponents in +-20, f32 denormals, zeros, NaN and +-Inf."""
    rng = np.random.default_rng(0)
    bf = np.arange(1 << 16, dtype=np.uint32) << 16
    parts = [bf.view(np.float32)]
    for dt in (jnp.float8_e4m3fn, jnp.float8_e5m2):
        g = np.arange(256, dtype=np.uint8).view(dt).astype(np.float32)
        g = np.sort(g[np.isfinite(g)])
        parts += [g, (g[1:] + g[:-1]) / 2, g * 1.0001, g * 0.9999]
    mant = rng.uniform(1.0, 2.0, 20000)
    expo = rng.integers(-20, 21, 20000)
    sign = rng.choice([-1.0, 1.0], 20000)
    parts.append((sign * mant * np.exp2(expo)).astype(np.float32))
    parts.append(np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 1e-45,
                           -1e-45, 1e-40, 3e-39, 1e30, -1e30, 448.0,
                           464.0, 57344.0, 61440.0], np.float32))
    x = np.concatenate(parts).astype(np.float32)
    return x if denormals else x[~is_denormal(x)]


@pytest.mark.parametrize("name", FMT_NAMES)
def test_format_specs_match(name):
    a, b = jf.FORMATS[name], tf.FORMATS[name]
    for field in ("name", "amax", "min_normal", "min_subnormal",
                  "mantissa_bits", "bits"):
        assert getattr(a, field) == getattr(b, field), field
    assert a.is_passthrough == b.is_passthrough and a.eps == b.eps


@pytest.mark.parametrize("name", ("e4m3", "e5m2", "bf16"))
def test_cast_to_format_bit_exact(name):
    x = special_f32()
    # Scaled copies push values past the fp8 range: the clip must come
    # before the cast (torch saturates, ml_dtypes returns NaN).
    x = np.concatenate([x, x * 300.0, x * 2.0**-12])
    j = jit_ref(lambda v: jf.cast_to_format(v, jf.FORMATS[name]))(
        jnp.asarray(x))
    t = tf.cast_to_format(torch.from_numpy(x), tf.FORMATS[name])
    assert_bits_equal(j, t, name)


def test_true_divide_is_ieee():
    x = special_f32(denormals=False)
    # Quotients stay normal: XLA flushes denormal results to zero.
    x = x[np.isfinite(x) & (np.abs(x) > 1e-30) & (np.abs(x) < 1e30)]
    for num in (448.0, 57344.0, 2688.0, 1.0):
        np.testing.assert_array_equal(
            to_numpy(tf.true_divide(num, torch.from_numpy(x))),
            np.asarray(jnp.float32(num) / jnp.asarray(x)))
    np.testing.assert_array_equal(
        to_numpy(tf.true_divide(torch.from_numpy(x), 6.0)),
        np.asarray(jnp.asarray(x) / 6.0))


def test_e2m1_round_encode_decode_bit_exact():
    x = special_f32(denormals=False)
    x = np.concatenate([x, np.linspace(-8, 8, 4097, dtype=np.float32)])
    r_j = jit_ref(jf.round_to_e2m1)(jnp.asarray(x))
    r_t = tf.round_to_e2m1(torch.from_numpy(x))
    assert_bits_equal(r_j, r_t, "round_to_e2m1")
    assert torch.isnan(r_t[torch.isnan(torch.from_numpy(x))]).all()
    on_grid = np.asarray(r_j)[~np.isnan(np.asarray(r_j))]
    assert_bits_equal(jit_ref(jf.encode_e2m1)(jnp.asarray(on_grid)),
                      tf.encode_e2m1(torch.from_numpy(on_grid)), "encode")
    codes = np.arange(16, dtype=np.int32)
    for jd, td in ((jnp.float32, torch.float32),
                   (jnp.bfloat16, torch.bfloat16)):
        assert_bits_equal(jf.decode_e2m1(jnp.asarray(codes), dtype=jd),
                          tf.decode_e2m1(torch.from_numpy(codes), dtype=td),
                          f"decode {td}")


def test_f32_denormal_divergence():
    """The one documented gap: a negative f32 denormal snaps to -0.0 in
    the port (IEEE sign test) and to +0.0 in the reference (XLA flushes
    it to zero before ``x < 0``); casts agree on denormals."""
    x = np.array([1e-40, -1e-40, -3e-39, -1e-45], np.float32)
    r_t = to_numpy(tf.round_to_e2m1(torch.from_numpy(x)))
    r_j = np.asarray(jf.round_to_e2m1(jnp.asarray(x)))
    assert (r_t == 0).all() and (r_j == 0).all()
    np.testing.assert_array_equal(np.signbit(r_t), x < 0)
    assert not np.signbit(r_j).any()
    for name in ("e4m3", "e5m2", "bf16"):
        assert_bits_equal(jf.cast_to_format(jnp.asarray(x), jf.FORMATS[name]),
                          tf.cast_to_format(torch.from_numpy(x),
                                            tf.FORMATS[name]), name)


@pytest.mark.parametrize("k", (64, 40))
def test_cast_to_nvfp4_bit_exact(k):
    rng = np.random.default_rng(k)
    x = (rng.standard_normal((32, k)) * np.exp2(
        rng.integers(-12, 12, (32, 1)))).astype(np.float32)
    x[3, :] = 0.0
    x[5, 2] = np.nan
    x[6, 1] = np.inf
    assert_bits_equal(jit_ref(jf.cast_to_nvfp4)(jnp.asarray(x)),
                      tf.cast_to_nvfp4(torch.from_numpy(x)), "nvfp4")


def test_exp2i_and_split_bit_exact():
    e = np.arange(-300, 301, dtype=np.int32)
    assert_bits_equal(jit_ref(jg.exp2i)(jnp.asarray(e)),
                      tg.exp2i(torch.from_numpy(e)))
    x = np.abs(special_f32(denormals=False))
    x = x[(x > 0) & np.isfinite(x)]
    mj, ej = jit_ref(jg.split_mantissa_exponent)(jnp.asarray(x))
    mt, et = tg.split_mantissa_exponent(torch.from_numpy(x))
    assert_bits_equal(mj, mt, "mantissa")
    assert_bits_equal(ej, et, "exponent")


def _bmax_cases():
    rng = np.random.default_rng(1)
    b = np.abs(rng.standard_normal((6, 7)) * np.exp2(
        rng.integers(-20, 21, (6, 7)))).astype(np.float32)
    b[0, 0] = 0.0
    b[1, 1] = 2e-38
    b[2, 2] = 3e38
    with_nan = b.copy()
    with_nan[3, 3] = np.nan
    with_inf = b.copy()
    with_inf[4, 4] = np.inf
    return {"clean": b, "nan": with_nan, "inf": with_inf,
            "zero": np.zeros((2, 3), np.float32)}


@pytest.mark.parametrize("algo", ("gam", "e8m0", "fp32_amax"))
@pytest.mark.parametrize("name", ("e4m3", "e5m2", "nvfp4"))
def test_scales_from_bmax_bit_exact(algo, name):
    for case, b in _bmax_cases().items():
        for g in (None, 7.5, 0.0, np.nan):
            gj = None if g is None else jnp.float32(g)
            gt = None if g is None else torch.tensor(g, dtype=torch.float32)
            sj = jg.scales_from_bmax(jnp.asarray(b), jf.FORMATS[name], algo,
                                     group_amax=gj)
            st = tg.scales_from_bmax(torch.from_numpy(b), tf.FORMATS[name],
                                     algo, group_amax=gt)
            for f in sj._fields:
                assert_bits_equal(getattr(sj, f), getattr(st, f),
                                  f"{case} g={g} {f}")


PARTS = [("tensor", (128, 128), (1, 1)), ("block", (128, 128), (1, 1)),
         ("block", (64, 64), (2, 16)), ("channel", (128, 128), (1, 1)),
         ("subchannel", (128, 128), (1, 1))]


@pytest.mark.parametrize("kind,block,align", PARTS)
def test_partition_and_blocks_bit_exact(kind, block, align):
    rng = np.random.default_rng(2)
    for shape in ((256, 384), (200, 136)):
        pj_ = jp.Partition(kind, block, sub=32, align=align)
        pt_ = tp.Partition(kind, block, sub=32, align=align)
        assert pj_.resolve(shape) == pt_.resolve(shape)
        assert pj_.grid(shape) == pt_.grid(shape)
        x = jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
        xt = to_torch(x)
        xb_j, fb_j, am_j, sc_j, pad_j = jit_ref(lambda v: (
            jp.to_blocks(v, pj_),
            jp.from_blocks(jp.to_blocks(v, pj_), shape),
            jp.block_amax(v, pj_),
            jg.compute_scales(v, pj_, jf.E4M3).scale,
            jp._pad2d(v, 64, 48)))(x)
        xb_t = tp.to_blocks(xt, pt_)
        assert_bits_equal(xb_j, xb_t, f"to_blocks {shape}")
        assert_bits_equal(fb_j, tp.from_blocks(xb_t, shape), "from_blocks")
        assert_bits_equal(am_j, tp.block_amax(xt, pt_), "block_amax")
        assert_bits_equal(sc_j, tg.compute_scales(xt, pt_, tf.E4M3).scale,
                          "compute_scales")
        assert_bits_equal(pad_j, tp._pad2d(xt, 64, 48), "_pad2d")
