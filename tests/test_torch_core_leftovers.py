"""The small core functions of the port (``core.mor.quant_dequant`` /
``quant_dequant_with_scales``, ``core.metrics``, ``kernels.ref.
expand_micro_onehot``) against the JAX reference on the CPU, op by op.

Inputs are f32 values from numpy, N(0, 1) times powers of two, kept
clear of f32 denormals (XLA on the CPU flushes them).

Tolerances: the fake-quant values, the GAM scales and every count or
decision bit for bit (the same IEEE operations); the f32 sums
(``relative_error``'s mean, ``block_relative_error_sums``' sums) within
rtol 1e-5, since XLA and PyTorch add their terms in different orders.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as jformats
from repro.core import metrics as jmetrics
from repro.core import mor as jmor
from repro.core.partition import Partition as JPartition
from repro.kernels import ref as jref
from repro_torch import core as tcore
from repro_torch.core import formats as tformats
from repro_torch.core import mor as tmor
from repro_torch.core.partition import Partition as TPartition
from repro_torch.kernels import ref as tref

PARTS = {"block128": ("block", (128, 128)), "block64": ("block", (64, 64)),
         "tensor": ("tensor", (128, 128))}


def values(shape, seed, spread=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * np.exp2(
        rng.integers(-spread, spread, shape))
    x = x.astype(np.float32)
    x.reshape(-1)[: x.size // 16] = 0.0
    return x


def bits(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def parts(name):
    kind, block = PARTS[name]
    return JPartition(kind, block), TPartition(kind, block)


@pytest.mark.parametrize("fmt", ("e4m3", "e5m2", "nvfp4"))
@pytest.mark.parametrize("algo", ("gam", "e8m0", "fp32_amax"))
@pytest.mark.parametrize("part", sorted(PARTS))
def test_quant_dequant_matches_reference(fmt, algo, part):
    """quant_dequant (and through it quant_dequant_with_scales): the f32
    fake-quant values and every GamScales field bit for bit."""
    x = values((192, 320), seed=len(fmt) + len(algo) + len(part))
    jp, tp = parts(part)
    yj, sj = jmor.quant_dequant(jnp.asarray(x), jp, jformats.FORMATS[fmt],
                                algo)
    yt, st = tcore.quant_dequant(torch.from_numpy(x), tp,
                                 tformats.FORMATS[fmt], algo)
    assert yt.dtype == torch.float32 and tuple(yt.shape) == x.shape
    np.testing.assert_array_equal(bits(yt), bits(yj))
    for f in ("scale", "group_mantissa", "block_exp", "group_amax"):
        np.testing.assert_array_equal(bits(getattr(st, f)),
                                      bits(getattr(sj, f)), err_msg=f)
    again = tmor.quant_dequant_with_scales(torch.from_numpy(x), tp,
                                           tformats.FORMATS[fmt], st)
    assert torch.equal(again, yt)


def test_relative_error_matches_reference():
    x = values((96, 200), 1)
    xq = (x * (1 + values((96, 200), 2, spread=2) * 1e-3)).astype(
        np.float32)
    j = float(jmetrics.relative_error(jnp.asarray(x), jnp.asarray(xq)))
    t = tcore.relative_error(torch.from_numpy(x), torch.from_numpy(xq))
    assert t.dtype == torch.float32 and t.ndim == 0
    assert float(t) == pytest.approx(j, rel=1e-5)
    zero = torch.zeros(4, 4)
    assert float(tcore.relative_error(zero, zero)) == 0.0


@pytest.mark.parametrize("part", ("block128", "block64"))
def test_block_relative_error_sums_match_reference(part):
    x = values((200, 300), 3)
    xq = (x * (1 + values((200, 300), 4, spread=2) * 1e-3)).astype(
        np.float32)
    jp, tp = parts(part)
    ej, nj = jmetrics.block_relative_error_sums(jnp.asarray(x),
                                                jnp.asarray(xq), jp)
    et, nt = tcore.block_relative_error_sums(torch.from_numpy(x),
                                             torch.from_numpy(xq), tp)
    assert nt.dtype == torch.int32 and et.dtype == torch.float32
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), rtol=1e-5)


@pytest.mark.parametrize("part", ("block128", "block64"))
def test_block_dynamic_range_ok_matches_reference(part):
    """Blocks on both sides of Eq. 4's bound (spreads of 2^14 to 2^40),
    an all-zero block and a one-magnitude block."""
    x = values((256, 256), 5, spread=4)
    rng = np.random.default_rng(6)
    for i, spread in enumerate((7, 12, 14, 20)):
        r = slice(i * 64, i * 64 + 64)
        x[r, 128:] = rng.standard_normal((64, 128)) * np.exp2(
            rng.integers(-spread, spread, (64, 128)))
    x[:64, :64] = 0.0
    x[64:128, :64] = 3.0
    jp, tp = parts(part)
    j = jmetrics.block_dynamic_range_ok(jnp.asarray(x), jp)
    t = tcore.block_dynamic_range_ok(torch.from_numpy(x), tp)
    assert t.dtype == torch.bool
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert 0 < int(t.sum()) < t.numel()  # both outcomes occur


@pytest.mark.parametrize("g0", (0, 3, 8))
def test_expand_micro_onehot_matches_reference(g0):
    """Each output is its one group value: bit for bit against the
    reference's one-hot dot and against a repeat."""
    d = values((32, 16), 7)
    j = jref.expand_micro_onehot(jnp.asarray(d), 128, g0)
    t = tref.expand_micro_onehot(torch.from_numpy(d), 128, g0)
    np.testing.assert_array_equal(bits(t), bits(j))
    want = np.repeat(d[:, g0:g0 + 8], 16, axis=1)
    np.testing.assert_array_equal(bits(t), bits(want))


def test_core_exports_as_the_reference():
    from repro import core as jcore
    for name in ("quant_dequant", "relative_error",
                 "block_relative_error_sums", "block_dynamic_range_ok"):
        assert name in jcore.__all__ and name in tcore.__all__
        assert callable(getattr(tcore, name))
    assert "expand_micro_onehot" in jref.__all__
    assert "expand_micro_onehot" in tref.__all__
