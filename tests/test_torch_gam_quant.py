"""The port's one-format quantize event (``kernels.ops.quant_err`` and
``kernels.ops.gam_quant``, the work of the ``gam_quant`` kernel) against
the JAX reference run with ``backend='xla'``, across E4M3 and E5M2, the
three scaling algos, ragged shapes, an all-zero stripe and NaN / Inf
blocks.

Tolerances: the stored values ``xq`` / ``y``, the E8M0 exponents, the
nonzero counts and the group scalars must agree bit for bit (NaN
positions compared as positions). The per-block error sums are f32
sums of the same terms whose order may differ (XLA's and PyTorch's
reductions), so they agree within rtol 1e-5. On the card the CUDA kernel
is held against the same plain version (the ``cuda``-marked test here,
and ``chip_smoke.py`` at the layer shapes of training).

The reference is compiled whole (``jit_ref``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.formats import E4M3 as JE4M3
from repro.core.formats import E5M2 as JE5M2
from repro.core.partition import Partition as JPartition
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core.formats import E4M3, E5M2
from repro_torch.core.partition import Partition as TPartition
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

FORMATS = {"e4m3": (JE4M3, E4M3), "e5m2": (JE5M2, E5M2)}
ALGOS = ("gam", "e8m0", "fp32_amax")


def jit_ref(fn):
    """``fn`` compiled by XLA with its excess precision off."""
    return jax.jit(fn, compiler_options={"xla_allow_excess_precision": False})


def to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(a.copy())


def assert_values_equal(j, t, what):
    """Bit for bit, NaNs by position."""
    a = np.asarray(j).astype(np.float32)
    b = t.to(torch.float32).numpy()
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=what)
    ok = ~np.isnan(a)
    np.testing.assert_array_equal(a[ok].view(np.uint32),
                                  b[ok].view(np.uint32), err_msg=what)


def assert_sums_close(j, t, what):
    a, b = np.asarray(j), t.numpy()
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=what)
    ok = ~np.isnan(a)
    np.testing.assert_allclose(b[ok], a[ok], rtol=1e-5, atol=0.0,
                               err_msg=what)


def operand(shape, seed, poison=True):
    """Normal values over +-8 binades, an all-zero bottom stripe, and
    (``poison``) a NaN and an Inf in two other blocks."""
    rng = np.random.default_rng(seed)
    m, k = shape
    x = rng.standard_normal((m, k)) * np.exp2(rng.integers(-8, 8, (m, k)))
    x[-max(m // 5, 1):] = 0.0
    if poison:
        x[3, 5] = np.nan
        x[m // 2, k - 2] = np.inf
    xj = jnp.asarray(x, jnp.bfloat16)
    return xj, to_torch(xj)


CASES = [(f, a, (256, 384)) for f in FORMATS for a in ALGOS] + [
    (f, "gam", (200, 136)) for f in FORMATS]


@pytest.mark.parametrize("fmt,algo,shape", CASES, ids=str)
def test_quant_err_matches_reference(fmt, algo, shape):
    jfmt, tfmt = FORMATS[fmt]
    xj, xt = operand(shape, seed=len(algo) + shape[0])
    q_j = jit_ref(lambda x: jops.quant_err(
        x, JPartition("block", (128, 128)), jfmt, algo, backend="xla"))(xj)
    q_t = tops.quant_err(xt, TPartition("block", (128, 128)), tfmt, algo)
    what = f"{fmt}/{algo}/{shape}"
    assert_values_equal(q_j.y, q_t.y, what + " y")
    assert_sums_close(q_j.err_sums, q_t.err_sums, what + " err_sums")
    np.testing.assert_array_equal(np.asarray(q_j.counts), q_t.counts.numpy())
    assert_values_equal(q_j.group_amax, q_t.group_amax, what + " amax")
    assert_values_equal(q_j.group_mantissa, q_t.group_mantissa, what + " m_g")


@pytest.mark.parametrize("fmt,algo,shape", CASES, ids=str)
def test_gam_quant_matches_reference(fmt, algo, shape):
    """The kernel's own outputs, block exponents included, through its
    plain version (the ref pads a ragged operand to the block grid)."""
    jfmt, tfmt = FORMATS[fmt]
    xj, xt = operand(shape, seed=7 + len(algo) + shape[1])
    xq_j, exp_j, err_j, cnt_j = jit_ref(lambda x: jref.gam_quant_ref(
        x, JPartition("block", (128, 128)), jfmt, algo))(xj)
    xq_t, exp_t, err_t, cnt_t = tops.gam_quant(xt, fmt=tfmt, algo=algo)
    what = f"{fmt}/{algo}/{shape}"
    assert_values_equal(xq_j, xq_t, what + " xq")
    np.testing.assert_array_equal(np.asarray(exp_j), exp_t.numpy(),
                                  err_msg=what + " block_exp")
    assert exp_t.dtype == torch.int32
    assert_sums_close(err_j, err_t, what + " err_sums")
    np.testing.assert_array_equal(np.asarray(cnt_j), cnt_t.numpy())


def tiny_block_operand(seed=0, denormals=False):
    """Normal values, and a first 128x128 block of sign * U(1, 2) * 1e-37:
    its ideal scale q_amax / amax overflows f32 to +Inf (the amax is below
    q_amax / f32max for every format). ``denormals`` adds bf16 denormals
    to that block (the card keeps them; XLA on the CPU flushes them)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((256, 256))
    sign = np.where(rng.standard_normal((128, 128)) > 0, 1.0, -1.0)
    x[:128, :128] = sign * rng.uniform(1, 2, (128, 128)) * 1e-37
    if denormals:
        x[3, :8] = [1e-39, -2e-39, 5e-40, -9e-41, 3e-38, 0.0, 1e-40, -1e-39]
    xj = jnp.asarray(x, jnp.bfloat16)
    return xj, to_torch(xj)


@pytest.mark.parametrize("fmt", tuple(FORMATS))
@pytest.mark.parametrize("algo", ALGOS)
def test_tiny_block_matches_reference(fmt, algo):
    """A block whose ideal scale overflows: the reference splits the Inf
    scale with frexp (exponent -1), so gam scales it by m_g / 2, e8m0 by
    1/2 and fp32_amax by Inf. xq, block_exp and counts bit for bit."""
    jfmt, tfmt = FORMATS[fmt]
    xj, xt = tiny_block_operand()
    xq_j, exp_j, err_j, cnt_j = jit_ref(lambda x: jref.gam_quant_ref(
        x, JPartition("block", (128, 128)), jfmt, algo))(xj)
    xq_t, exp_t, err_t, cnt_t = tops.gam_quant(xt, fmt=tfmt, algo=algo)
    what = f"tiny {fmt}/{algo}"
    assert_values_equal(xq_j, xq_t, what + " xq")
    np.testing.assert_array_equal(np.asarray(exp_j), exp_t.numpy(),
                                  err_msg=what + " block_exp")
    assert int(exp_t[0, 0]) == -1
    assert_sums_close(err_j, err_t, what + " err_sums")
    np.testing.assert_array_equal(np.asarray(cnt_j), cnt_t.numpy())


def test_tensor_and_channel_partitions_take_the_plain_version():
    """The reference's routing: 'tensor' / 'channel' / 'subchannel'
    events never reach the kernel, on any device; a 'block' event on
    the CPU runs the plain version."""
    _, xt = operand((64, 96), seed=3, poison=False)
    for kind in ("tensor", "channel", "subchannel"):
        part = TPartition(kind, (32, 32), sub=32)
        assert tops._kernel_backend("auto", part, xt) == "torch"
        q = tops.quant_err(xt, part, E4M3)
        assert q.y.shape == xt.shape
    calls = tref.gam_quant_ref.calls
    tops.gam_quant(xt, block=(32, 32))
    assert tref.gam_quant_ref.calls == calls + 1
    with pytest.raises(ValueError, match="CUDA"):
        tops.gam_quant(xt, backend="cuda")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU or "
                    "interpret mode (chip_smoke.py runs them on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", tuple(FORMATS))
@pytest.mark.parametrize("algo", ALGOS)
def test_kernel_matches_plain_version_on_card(fmt, algo, cuda_device):
    """The CUDA kernel against its plain version on the same CUDA
    tensors: xq and block_exp bit for bit; the kernel's f64-accumulated
    error sums within 1e-6 of the plain version's f32 sums."""
    _, xt = operand((256, 384), seed=11)
    xt = xt.to(cuda_device)
    tfmt = FORMATS[fmt][1]
    k = tops.gam_quant(xt, fmt=tfmt, algo=algo, backend="cuda")
    t = tops.gam_quant(xt, fmt=tfmt, algo=algo, backend="torch")
    assert torch.equal(k[0].view(torch.int16), t[0].view(torch.int16))
    assert torch.equal(k[1], t[1]) and torch.equal(k[3], t[3])
    torch.testing.assert_close(k[2], t[2], rtol=1e-6, atol=0,
                               equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", tuple(FORMATS))
@pytest.mark.parametrize("algo", ALGOS)
def test_kernel_matches_plain_version_on_tiny_block(fmt, algo, cuda_device):
    """The kernel's Alg. 1 bit arithmetic on an overflowing ideal scale
    (and on bf16 denormals) against the plain version's frexp: xq,
    block_exp and counts bit for bit."""
    _, xt = tiny_block_operand(denormals=True)
    xt = xt.to(cuda_device)
    tfmt = FORMATS[fmt][1]
    k = tops.gam_quant(xt, fmt=tfmt, algo=algo, backend="cuda")
    t = tops.gam_quant(xt, fmt=tfmt, algo=algo, backend="torch")
    assert torch.equal(k[0].view(torch.int16), t[0].view(torch.int16))
    assert torch.equal(k[1], t[1]) and torch.equal(k[3], t[3])
    assert int(k[1][0, 0]) == -1
