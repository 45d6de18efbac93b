"""The port's pack-emitting MoR selection (``kernels.ops.quantize_pack``
and ``core.mor.quantize_for_gemm``) against the JAX reference run with
``backend='xla'``: tags, GAM scales and every payload lane byte for byte
(after ``compact()`` too), the per-block f32 error sums within rtol 1e-5
(their summation order may differ), and the stats rows through their
``STAT_*`` names. On the CPU the port runs its plain version; the CUDA
kernel is held against the same plain version by the ``cuda``-marked
test here and by ``chip_smoke.py`` on the card.

The reference is compiled whole (``jit_ref``): run op by op, JAX
compiles every primitive separately, which took most of the time."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mor as jmor
from repro.core.partition import Partition as JPartition
from repro.core.policy import MoRPolicy as JPolicy
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import mor as tmor
from repro_torch.core.partition import Partition as TPartition
from repro_torch.core.policy import MoRPolicy as TPolicy
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

MODES = ("sub2", "sub3", "sub4")
ALGOS = ("gam", "e8m0", "fp32_amax")
LANES = ("payload_q", "payload_bf16", "payload_nib", "micro_scales",
         "tags", "scales")


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


def bits(a) -> np.ndarray:
    """Raw bits of a JAX/numpy array or a torch tensor, for equality."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        a = a.numpy()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16)
    if a.dtype == np.float32:
        return a.view(np.uint32)
    return a


def mixed_tags(shape, seed=0):
    """Blocks that hit every tag (the reference suite's generator plus
    a moderate-range stripe): normal rows (E4M3), huge-range (BF16) and
    moderate-range (E5M2) rows, micro-scaled E2M1-grid rows (NVFP4
    under sub4) and an all-zero stripe."""
    rng = np.random.default_rng(seed)
    m, k = shape
    kp = -(-k // 16) * 16
    x = rng.standard_normal((m, kp))
    q = max(m // 4, 1)
    h = kp // 2  # huge range (BF16) left, moderate range (E5M2) right
    x[q:2 * q, :h] *= np.exp2(rng.integers(-20, 20, (q, h)))
    x[q:2 * q, h:] *= np.exp2(rng.integers(-12, 4, (q, kp - h)))
    grid = np.array([0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0])
    mm = grid[rng.integers(0, 7, (q, kp))] * np.exp2(
        rng.integers(-9, 9, (q, kp // 16))).repeat(16, axis=1)
    x[2 * q:3 * q] = mm * np.where(rng.standard_normal((q, kp)) > 0, 1, -1)
    x[-max(m // 8, 1):] = 0.0
    xj = jnp.asarray(x[:, :k], jnp.bfloat16)
    return xj, to_torch(xj)


def assert_pack_equal(mo_j, mo_t, what=""):
    assert tuple(mo_j.block) == tuple(mo_t.block), what
    assert tuple(mo_j.shape) == tuple(mo_t.shape), what
    assert mo_j.has_nvfp4 == mo_t.has_nvfp4, what
    for lane in LANES:
        a, b = bits(getattr(mo_j, lane)), bits(getattr(mo_t, lane))
        assert a.shape == b.shape, (what, lane, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=f"{what} {lane}")


def assert_select_equal(r_j, r_t, what=""):
    np.testing.assert_array_equal(np.asarray(r_j.sel), r_t.sel.numpy())
    np.testing.assert_array_equal(np.asarray(r_j.counts),
                                  r_t.counts.numpy())
    fields = ["e4_sums", "e5_sums"] + (["nv_sums"] if r_j.nv_sums is not None
                                       else [])
    for f in fields:
        np.testing.assert_allclose(getattr(r_t, f).numpy(),
                                   np.asarray(getattr(r_j, f)), rtol=1e-5,
                                   atol=0.0, err_msg=f"{what} {f}")
    assert (r_t.nv_sums is None) == (r_j.nv_sums is None)
    assert bits(r_j.group_amax) == bits(r_t.group_amax)
    assert bits(r_j.group_mantissa) == bits(r_t.group_mantissa)


CASES = [(m, a, (256, 384)) for m in MODES for a in ALGOS] + [
    (m, "gam", (200, 136)) for m in MODES]


@pytest.mark.parametrize("mode,algo,shape", CASES, ids=str)
def test_quantize_pack_matches_reference(mode, algo, shape):
    xj, xt = mixed_tags(shape, seed=1)
    align = (2, 16) if mode == "sub4" else (1, 1)
    mo_j, r_j = jit_ref(lambda x: jops.quantize_pack(
        x, JPartition("block", (64, 64), align=align), mode, algo,
        backend="xla"))(xj)
    mo_t, r_t = tops.quantize_pack(
        xt, TPartition("block", (64, 64), align=align), mode, algo)
    what = f"{mode}/{algo}/{shape}"
    assert_pack_equal(mo_j, mo_t, what)
    assert_select_equal(r_j, r_t, what)
    assert_pack_equal(mo_j.compact(), mo_t.compact(), what + " compact")
    np.testing.assert_array_equal(bits(jit_ref(lambda m: m.dequant())(mo_j)),
                                  bits(mo_t.dequant()))
    assert r_t.y is None


def test_every_tag_occurs_in_sub4():
    xj, xt = mixed_tags((256, 384), seed=1)
    mo_t, _ = tops.quantize_pack(
        xt, TPartition("block", (64, 64), align=(2, 16)), "sub4")
    assert set(np.unique(mo_t.tags.numpy())) == {0, 1, 2, 3}


@pytest.mark.parametrize("shape", ((200, 136), (30, 18), (2, 16)), ids=str)
def test_default_block_ragged_shapes(shape):
    """128x128 policy blocks on ragged operands: resolve shrinks the
    block to the operand (aligned to (2, 16) under sub4) and pads."""
    xj, xt = mixed_tags(shape, seed=2)
    for mode in MODES:
        pol_j = JPolicy(recipe=mode, backend="xla")
        pol_t = TPolicy(recipe=mode)
        mo_j, s_j = jit_ref(lambda x: jmor.quantize_for_gemm(x, pol_j))(xj)
        mo_t, s_t = tmor.quantize_for_gemm(xt, pol_t)
        assert_pack_equal(mo_j, mo_t, f"{shape} {mode}")


def _assert_stats_equal(s_j, s_t, what=""):
    s_j, s_t = np.asarray(s_j), s_t.numpy()
    assert s_t.shape == (tmor.STATS_WIDTH,) == s_j.shape
    exact = (tmor.STAT_DECISION, tmor.STAT_AMAX, tmor.STAT_FRAC_E4M3,
             tmor.STAT_FRAC_E5M2, tmor.STAT_FRAC_BF16,
             tmor.STAT_NONZERO_FRAC, tmor.STAT_GROUP_MANTISSA,
             tmor.STAT_FRAC_NVFP4, tmor.STAT_MICRO_SCALE_BPE,
             tmor.STAT_EVENT_KIND, tmor.STAT_PAYLOAD_BPE,
             tmor.STAT_GUARD_FLAGS, tmor.STAT_FALLBACK_COUNT)
    for lane in exact:
        np.testing.assert_array_equal(bits(s_j[lane]), bits(s_t[lane]),
                                      err_msg=f"{what} lane {lane}")
    # The global relative error is a ratio of f32 sums over blocks.
    np.testing.assert_allclose(s_t[tmor.STAT_REL_ERR],
                               s_j[tmor.STAT_REL_ERR], rtol=1e-5)


@pytest.mark.parametrize("recipe", MODES + ("off",))
def test_quantize_for_gemm_stats_rows(recipe):
    """Run op by op: compiled whole, XLA reorders the stats means."""
    xj, xt = mixed_tags((256, 384), seed=3)
    mo_j, s_j = jmor.quantize_for_gemm(
        xj, JPolicy(recipe=recipe, block_shape=(64, 64), backend="xla"))
    mo_t, s_t = tmor.quantize_for_gemm(
        xt, TPolicy(recipe=recipe, block_shape=(64, 64)))
    _assert_stats_equal(s_j, s_t, recipe)
    assert_pack_equal(mo_j, mo_t, recipe)
    if recipe == "off":
        assert s_t[tmor.STAT_DECISION] == -1.0  # the disabled sentinel
        assert s_t[tmor.STAT_FRAC_BF16] == 1.0


@pytest.mark.parametrize("recipe", MODES)
def test_nonfinite_block_guard_lanes(recipe):
    """A NaN and an Inf element poison their blocks: those blocks go to
    the BF16 arm, guard lanes 12/13 report them, identically."""
    xj, xt = mixed_tags((256, 384), seed=4)
    xn = np.asarray(xj).copy()
    xn[10, 20] = np.nan
    xn[100, 300] = np.inf
    xj = jnp.asarray(xn)
    xt = to_torch(xj)
    mo_j, s_j = jit_ref(lambda x: jmor.quantize_for_gemm(
        x, JPolicy(recipe=recipe, block_shape=(64, 64), backend="xla")))(xj)
    mo_t, s_t = tmor.quantize_for_gemm(
        xt, TPolicy(recipe=recipe, block_shape=(64, 64)))
    _assert_stats_equal(s_j, s_t, recipe)
    assert_pack_equal(mo_j, mo_t, recipe)
    assert s_t[tmor.STAT_GUARD_FLAGS] == (tmor.GUARD_NONFINITE_AMAX
                                          + tmor.GUARD_BLOCK_FALLBACK)
    assert s_t[tmor.STAT_FALLBACK_COUNT] == 2.0
    assert mo_t.tags[0, 0] == tref.TAG_BF16 == mo_t.tags[1, 4]


def test_pack_mixed_under_given_tags():
    """The packer alone, under arbitrary tags (fp8 bits for NVFP4-capable
    and incapable blocks, the group-amax override)."""
    xj, xt = mixed_tags((128, 192), seed=5)
    rng = np.random.default_rng(5)
    tags = rng.integers(0, 4, (2, 3)).astype(np.int32)
    for with_nv, t in ((True, tags), (False, np.minimum(tags, 2))):
        for g in (None, 3.0):
            mo_j = jit_ref(lambda x, tg: jref.pack_mixed(
                x, tg, (64, 64), "gam",
                group_amax=None if g is None else jnp.float32(g),
                with_nvfp4=with_nv))(xj, jnp.asarray(t))
            mo_t = tref.pack_mixed(
                xt, torch.from_numpy(t), (64, 64), "gam",
                group_amax=None if g is None else torch.tensor(g),
                with_nvfp4=with_nv)
            assert_pack_equal(mo_j, mo_t, f"nv={with_nv} g={g}")


def test_sub4_rejects_incapable_block_and_unported_recipes():
    _, xt = mixed_tags((64, 64), seed=6)
    with pytest.raises(ValueError, match="even-row"):
        tmor.quantize_for_gemm(xt, TPolicy(recipe="sub4",
                                           block_shape=(63, 64)))
    for recipe in ("tensor", "e4m3"):
        # Ported since (decide through gam_quant, then pack; held
        # against the reference in test_torch_mor_dot.py).
        mo, _ = tmor.quantize_for_gemm(xt, TPolicy(recipe=recipe))
        assert set(np.unique(mo.tags.numpy()).tolist()) <= {
            tref.TAG_E4M3, tref.TAG_BF16}
    with pytest.raises(ValueError, match="unknown recipe"):
        tmor.quantize_for_gemm(xt, TPolicy(recipe="e3m4"))
    with pytest.raises(ValueError, match="backend"):
        TPolicy(backend="xla")
    with pytest.raises(ValueError, match="CUDA"):
        tops.quantize_pack(xt, TPartition("block", (64, 64)), "sub3",
                           backend="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
def test_kernel_matches_plain_version_on_card(mode, cuda_device):
    """The CUDA kernel against its plain version on the same CUDA
    tensors (chip_smoke.py runs this at full layer shapes too)."""
    _, xt = mixed_tags((256, 384), seed=7)
    xt = xt.to(cuda_device)
    align = (2, 16) if mode == "sub4" else (1, 1)
    part = TPartition("block", (64, 64), align=align)
    mo_k, r_k = tops.quantize_pack(xt, part, mode, backend="cuda")
    mo_t, r_t = tops.quantize_pack(xt, part, mode, backend="torch")
    for lane in LANES:
        a, b = getattr(mo_k, lane).cpu(), getattr(mo_t, lane).cpu()
        np.testing.assert_array_equal(bits(a), bits(b), err_msg=lane)
    torch.testing.assert_close(r_k.e4_sums, r_t.e4_sums, rtol=1e-5, atol=0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU or "
                    "interpret mode (chip_smoke.py runs them on the card)")
    return torch.device("cuda")
