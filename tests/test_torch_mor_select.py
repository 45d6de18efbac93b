"""The port's fake-quant MoR selection (``kernels.ops.mor_select``, the
work of the ``mor_select(emit='select')`` kernel) against the JAX
reference run with ``backend='xla'``, for sub2 / sub3 / sub4 and the
three scaling algos, on operands whose blocks hit every tag, plus a
ragged shape and NaN / Inf blocks.

Tolerances: the fake-quant output ``y`` (each block's winner as stored,
the NVFP4 snap included) bit for bit, the per-block tags ``sel`` and
nonzero counts exactly, the group scalars bit for bit, and the per-block
f32 error sums within rtol 1e-5 (the same terms, summed in XLA's and
PyTorch's orders). On the card the CUDA kernel is held against the same
plain version (the ``cuda``-marked test here, and ``chip_smoke.py``).

The reference is compiled whole (``jit_ref``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.partition import Partition as JPartition
from repro.kernels import ops as jops
from repro_torch.core.partition import Partition as TPartition
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

MODES = ("sub2", "sub3", "sub4")
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


def bf16_bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


def mixed_tags(shape, seed=0, poison=False):
    """Blocks that hit every tag: normal rows (E4M3), huge-range (BF16)
    and moderate-range (E5M2) rows, micro-scaled E2M1-grid rows (NVFP4
    under sub4), an all-zero stripe; ``poison`` adds a NaN and an Inf."""
    rng = np.random.default_rng(seed)
    m, k = shape
    kp = -(-k // 16) * 16
    x = rng.standard_normal((m, kp))
    q = max(m // 4, 1)
    h = kp // 2
    x[q:2 * q, :h] *= np.exp2(rng.integers(-20, 20, (q, h)))
    x[q:2 * q, h:] *= np.exp2(rng.integers(-12, 4, (q, kp - h)))
    grid = np.array([0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0])
    mm = grid[rng.integers(0, 7, (q, kp))] * np.exp2(
        rng.integers(-9, 9, (q, kp // 16))).repeat(16, axis=1)
    x[2 * q:3 * q] = mm * np.where(rng.standard_normal((q, kp)) > 0, 1, -1)
    x[-max(m // 8, 1):] = 0.0
    x = x[:, :k]
    if poison:
        x[3, 5] = np.nan
        x[m // 2, k - 3] = np.inf
    xj = jnp.asarray(x, jnp.bfloat16)
    return xj, to_torch(xj)


def assert_select_equal(r_j, r_t, what):
    yj, yt = bf16_bits(r_j.y), bf16_bits(r_t.y)
    assert yj.shape == yt.shape, what
    nan_j = np.isnan(np.asarray(r_j.y, np.float32))
    np.testing.assert_array_equal(nan_j, torch.isnan(r_t.y.float()).numpy(),
                                  err_msg=what + " y NaN")
    np.testing.assert_array_equal(yj[~nan_j], yt[~nan_j], err_msg=what + " y")
    np.testing.assert_array_equal(np.asarray(r_j.sel), r_t.sel.numpy(),
                                  err_msg=what + " sel")
    np.testing.assert_array_equal(np.asarray(r_j.counts), r_t.counts.numpy())
    fields = ["e4_sums", "e5_sums"] + (["nv_sums"] if r_j.nv_sums is not None
                                       else [])
    for f in fields:
        a, b = np.asarray(getattr(r_j, f)), getattr(r_t, f).numpy()
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        ok = ~np.isnan(a)
        np.testing.assert_allclose(b[ok], a[ok], rtol=1e-5, atol=0.0,
                                   err_msg=f"{what} {f}")
    assert (r_t.nv_sums is None) == (r_j.nv_sums is None)
    for f in ("group_amax", "group_mantissa"):
        a = np.asarray(getattr(r_j, f), np.float32)
        b = getattr(r_t, f).numpy()
        assert (np.isnan(a) and np.isnan(b)) or a.view(np.uint32) == \
            b.view(np.uint32), (what, f)


CASES = [(m, a, (256, 384), False) for m in MODES for a in ALGOS] + [
    (m, "gam", (200, 136), True) for m in MODES]


@pytest.mark.parametrize("mode,algo,shape,poison", CASES, ids=str)
def test_mor_select_matches_reference(mode, algo, shape, poison):
    xj, xt = mixed_tags(shape, seed=2, poison=poison)
    align = (2, 16) if mode == "sub4" else (1, 1)
    r_j = jit_ref(lambda x: jops.mor_select(
        x, JPartition("block", (64, 64), align=align), mode, algo,
        backend="xla"))(xj)
    r_t = tops.mor_select(xt, TPartition("block", (64, 64), align=align),
                          mode, algo)
    assert_select_equal(r_j, r_t, f"{mode}/{algo}/{shape}")


def tiny_block_operand(seed=0, denormals=False):
    """Normal values, and a first 128x128 block of sign * U(1, 2) * 1e-37:
    the ideal scale q_amax / amax of every candidate format overflows f32
    to +Inf. ``denormals`` adds bf16 denormals to that block (the card
    keeps them; XLA on the CPU flushes them)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((256, 256))
    sign = np.where(rng.standard_normal((128, 128)) > 0, 1.0, -1.0)
    x[:128, :128] = sign * rng.uniform(1, 2, (128, 128)) * 1e-37
    if denormals:
        x[3, :8] = [1e-39, -2e-39, 5e-40, -9e-41, 3e-38, 0.0, 1e-40, -1e-39]
    xj = jnp.asarray(x, jnp.bfloat16)
    return xj, to_torch(xj)


PACK_LANES = ("payload_q", "payload_bf16", "payload_nib", "micro_scales",
              "tags", "scales")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("algo", ALGOS)
def test_tiny_block_matches_reference(mode, algo):
    """A block whose ideal scales overflow: the reference splits each Inf
    scale with frexp (exponent -1). The selection (y, tags, sums) and the
    packed payload (every lane, the block scales) bit for bit."""
    xj, xt = tiny_block_operand()
    align = (2, 16) if mode == "sub4" else (1, 1)
    jpart = JPartition("block", (128, 128), align=align)
    tpart = TPartition("block", (128, 128), align=align)
    what = f"tiny {mode}/{algo}"
    r_j = jit_ref(lambda x: jops.mor_select(x, jpart, mode, algo,
                                            backend="xla"))(xj)
    assert_select_equal(r_j, tops.mor_select(xt, tpart, mode, algo), what)
    mo_j, _ = jit_ref(lambda x: jops.quantize_pack(x, jpart, mode, algo,
                                                   backend="xla"))(xj)
    mo_t, _ = tops.quantize_pack(xt, tpart, mode, algo)
    for lane in PACK_LANES:
        a, b = getattr(mo_j, lane), getattr(mo_t, lane)
        if b.dtype == torch.bfloat16:
            a, b = bf16_bits(a), bf16_bits(b)
        else:
            a, b = np.asarray(a), b.numpy()
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8),
                                      err_msg=f"{what} {lane}")
    if algo == "e8m0" and int(mo_t.tags[0, 0]) != tref.TAG_BF16:
        assert float(mo_t.scales[0, 0]) == 0.5


def test_every_tag_occurs():
    """The operand exercises every arm of the selection, so the bit
    comparison above covers every candidate's stored value."""
    _, xt = mixed_tags((256, 384), seed=2)
    seen = {}
    for mode in MODES:
        align = (2, 16) if mode == "sub4" else (1, 1)
        r = tops.mor_select(xt, TPartition("block", (64, 64), align=align),
                            mode)
        seen[mode] = set(np.unique(r.sel.numpy()).tolist())
    assert seen == {"sub2": {0, 2}, "sub3": {0, 1, 2}, "sub4": {0, 1, 2, 3}}


def test_sub4_unaligned_block_and_cpu_route():
    """A sub4 contraction block that is not a multiple of 16 takes the
    plain version on any device (the reference's routing); a CPU tensor
    runs the plain version, counted by ``mor_select_ref.calls``."""
    _, xt = mixed_tags((64, 40), seed=4)
    calls = tref.mor_select_ref.calls
    r = tops.mor_select(xt, TPartition("block", (64, 40)), "sub4")
    assert tref.mor_select_ref.calls == calls + 1
    assert r.y.shape == xt.shape
    with pytest.raises(ValueError, match="CUDA"):
        tops.mor_select(xt, TPartition("block", (64, 64)), "sub3",
                        backend="cuda")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU or "
                    "interpret mode (chip_smoke.py runs them on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
def test_kernel_matches_plain_version_on_card(mode, cuda_device):
    """The select kernel against its plain version on the same CUDA
    tensors: y and sel bit for bit."""
    _, xt = mixed_tags((256, 384), seed=7, poison=True)
    xt = xt.to(cuda_device)
    align = (2, 16) if mode == "sub4" else (1, 1)
    part = TPartition("block", (64, 64), align=align)
    k = tops.mor_select(xt, part, mode, backend="cuda")
    t = tops.mor_select(xt, part, mode, backend="torch")
    assert torch.equal(k.y.view(torch.int16), t.y.view(torch.int16))
    assert torch.equal(k.sel, t.sel)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("algo", ALGOS)
def test_kernels_match_plain_versions_on_tiny_block(mode, algo, cuda_device):
    """Both kernels' Alg. 1 bit arithmetic on overflowing ideal scales
    (and on bf16 denormals) against the plain versions' frexp: y, sel and
    every packed lane bit for bit."""
    _, xt = tiny_block_operand(denormals=True)
    xt = xt.to(cuda_device)
    align = (2, 16) if mode == "sub4" else (1, 1)
    part = TPartition("block", (128, 128), align=align)
    k = tops.mor_select(xt, part, mode, algo, backend="cuda")
    t = tops.mor_select(xt, part, mode, algo, backend="torch")
    assert torch.equal(k.y.view(torch.int16), t.y.view(torch.int16))
    assert torch.equal(k.sel, t.sel)
    mo_k, _ = tops.quantize_pack(xt, part, mode, algo, backend="cuda")
    mo_t, _ = tops.quantize_pack(xt, part, mode, algo, backend="torch")
    for lane in PACK_LANES:
        a, b = getattr(mo_k, lane), getattr(mo_t, lane)
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8)), lane
