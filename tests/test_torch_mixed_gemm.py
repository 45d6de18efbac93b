"""The port's mixed-representation GEMM (``kernels.ops.mixed_gemm`` /
``mixed_dot`` / ``serve.quantized.qdot``) and QTensor weights against the
JAX reference (``backend='xla'``), for all four tags and compact lanes.

Tolerance: decoding is exact (every block decodes to the same stored
bf16 values, asserted bit for bit), and a bf16 x bf16 product is exact
in f32, so the only possible difference is the order of the f32 sum:
|C_port - C_ref| <= 1e-6 * sum_k |a_k b_k| for f32 output, plus one
bf16 ulp (<= 2^-7 |C|) for bf16 output. (The plain version sums
each K block in k order, which is what XLA does on the CPU, so in
practice the results agree exactly.)

The reference is compiled whole (``jit_ref``): run op by op, JAX
compiles every primitive separately, which took most of the time."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.policy import MoRPolicy as JPolicy
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.serve import quantized as jq
from repro_torch.core.policy import MoRPolicy as TPolicy
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.serve import quantized as tq

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


def as_f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a).astype(np.float32)


def bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        a = a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def mixed_tags(shape, seed=0):
    """Blocks hitting every tag under sub4 (see test_torch_quantize_pack)."""
    rng = np.random.default_rng(seed)
    m, k = shape
    x = rng.standard_normal((m, k))
    q = max(m // 4, 1)
    h = k // 2
    x[q:2 * q, :h] *= np.exp2(rng.integers(-20, 20, (q, h)))
    x[q:2 * q, h:] *= np.exp2(rng.integers(-12, 4, (q, k - h)))
    grid = np.array([0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0])
    mm = grid[rng.integers(0, 7, (q, k))] * np.exp2(
        rng.integers(-9, 9, (q, k // 16))).repeat(16, axis=1)
    x[2 * q:3 * q] = mm * np.where(rng.standard_normal((q, k)) > 0, 1, -1)
    x[-max(m // 8, 1):] = 0.0
    xj = jnp.asarray(x, jnp.bfloat16)
    return xj, to_torch(xj)


def packs(x_shape, recipe, seed, compact):
    """The same operand packed by both packages (byte-identical lanes are
    asserted in test_torch_quantize_pack)."""
    xj, xt = mixed_tags(x_shape, seed)
    from repro.core.mor import quantize_for_gemm as jqfg
    from repro_torch.core.mor import quantize_for_gemm as tqfg
    mo_j, _ = jit_ref(lambda x: jqfg(x, JPolicy(
        recipe=recipe, block_shape=(64, 64), backend="xla")))(xj)
    mo_t, _ = tqfg(xt, TPolicy(recipe=recipe, block_shape=(64, 64)))
    if compact:
        mo_j, mo_t = mo_j.compact(), mo_t.compact()
    return mo_j, mo_t


def assert_gemm_close(c_j, c_t, a_abs, b_abs, out_dtype):
    cj, ct = as_f32(c_j), as_f32(c_t)
    assert cj.shape == ct.shape
    scale = a_abs.astype(np.float64) @ b_abs.astype(np.float64).T
    tol = 1e-6 * scale
    if out_dtype == "bf16":
        tol = tol + 2.0**-7 * np.abs(cj)  # one bf16 ulp
    assert np.all(np.abs(cj - ct) <= tol), np.abs(cj - ct).max()


@pytest.mark.parametrize("compact", (False, True))
@pytest.mark.parametrize("recipe", ("sub3", "sub4"))
def test_decode_mixed_bit_exact(recipe, compact):
    mo_j, mo_t = packs((256, 384), recipe, 1, compact)
    np.testing.assert_array_equal(bits(jit_ref(jref.decode_mixed_ref)(mo_j)),
                                  bits(tref.decode_mixed_ref(mo_t)))
    np.testing.assert_array_equal(bits(jit_ref(lambda m: m.dequant())(mo_j)),
                                  bits(mo_t.dequant()))


@pytest.mark.parametrize("out_dtype", ("bf16", "f32"))
@pytest.mark.parametrize("compact", (False, True))
@pytest.mark.parametrize("M", (3, 70))
def test_mixed_dot_passthrough_activation(M, compact, out_dtype):
    """Serving shape: an unquantized activation against a weight pack
    that mixes all four tags (sub4), compact lanes or not."""
    mo_j, mo_t = packs((256, 384), "sub4", 2, compact)
    rng = np.random.default_rng(M)
    xj = jnp.asarray(rng.standard_normal((M, 384)), jnp.bfloat16)
    xt = to_torch(xj)
    jd = jnp.bfloat16 if out_dtype == "bf16" else jnp.float32
    td = torch.bfloat16 if out_dtype == "bf16" else torch.float32
    c_j = jit_ref(lambda x, m: jops.mixed_dot(x, m, out_dtype=jd,
                                              backend="xla"))(xj, mo_j)
    c_t = tops.mixed_dot(xt, mo_t, out_dtype=td)
    assert c_t.dtype == td
    assert_gemm_close(c_j, c_t, np.abs(as_f32(xt)),
                      np.abs(as_f32(mo_t.dequant())), out_dtype)


@pytest.mark.parametrize("out_dtype", ("bf16", "f32"))
def test_mixed_gemm_both_operands_mixed(out_dtype):
    """Training shape (both operands packed, sub4 x sub3)."""
    a_j, a_t = packs((128, 384), "sub4", 3, False)
    b_j, b_t = packs((192, 384), "sub3", 4, True)
    jd = jnp.bfloat16 if out_dtype == "bf16" else jnp.float32
    td = torch.bfloat16 if out_dtype == "bf16" else torch.float32
    c_j = jit_ref(lambda a, b: jops.mixed_gemm(a, b, out_dtype=jd,
                                               backend="xla"))(a_j, b_j)
    c_t = tops.mixed_gemm(a_t, b_t, out_dtype=td)
    assert_gemm_close(c_j, c_t, np.abs(as_f32(a_t.dequant())),
                      np.abs(as_f32(b_t.dequant())), out_dtype)


def test_qtensor_quantize_weight_and_qdot():
    """QTensor of a (K, N) weight: the (N, K) view's compacted lanes,
    stats and info match; qdot matches the reference's qdot."""
    rng = np.random.default_rng(5)
    wj = jnp.asarray(rng.standard_normal((384, 200)) * 0.02, jnp.bfloat16)
    wj = wj.at[:, :64].multiply(jnp.bfloat16(1e3))  # a few hot columns
    wt = to_torch(wj)
    pol_j = JPolicy(recipe="sub3", block_shape=(64, 64), backend="xla")
    pol_t = TPolicy(recipe="sub3", block_shape=(64, 64))
    qj, info_j = jq.quantize_weight(wj, pol_j)
    qt, info_t = tq.quantize_weight(wt, pol_t)
    assert qt.shape == qj.shape and not qt.is_stacked
    for lane in LANES:
        np.testing.assert_array_equal(bits(getattr(qj.mo, lane)),
                                      bits(getattr(qt.mo, lane)), lane)
    assert set(info_j) == set(info_t)
    for k in info_j:
        assert info_t[k] == pytest.approx(info_j[k], rel=1e-5), k
    assert qt.nbytes == qj.nbytes
    assert qt.frac_quantized == qj.frac_quantized
    x = jnp.asarray(rng.standard_normal((2, 5, 384)), jnp.bfloat16)
    yj = jit_ref(lambda x, q: jq.qdot(x, q, backend="xla"))(x, qj)
    yt = tq.qdot(to_torch(x), qt)
    assert tuple(yt.shape) == (2, 5, 200)
    assert_gemm_close(yj.reshape(10, 200), yt.reshape(10, 200),
                      np.abs(as_f32(to_torch(x).reshape(10, 384))),
                      np.abs(as_f32(qt.dequant().T)), "bf16")
    np.testing.assert_array_equal(bits(jq.QTensor.dequant(qj)),
                                  bits(qt.dequant()))


def test_qtensor_stacked_layers_match():
    """A layer-stacked (L, K, N) weight: layer l's lanes equal the
    reference's stacked lanes [l]; stats rows and the info summary."""
    rng = np.random.default_rng(6)
    w = rng.standard_normal((3, 192, 128)) * 0.02
    w[1, :, :64] *= np.exp2(rng.integers(-12, 4, (192, 64)))  # E5M2 blocks
    wj = jnp.asarray(w, jnp.bfloat16)
    wt = to_torch(wj)
    pol_j = JPolicy(recipe="sub3", block_shape=(64, 64), backend="xla")
    pol_t = TPolicy(recipe="sub3", block_shape=(64, 64))
    qj, info_j = jq.quantize_weight_stacked(wj, pol_j)
    qt, info_t = tq.quantize_weight_stacked(wt, pol_t)
    assert qt.is_stacked and qt.shape == qj.shape
    for lane in LANES:
        np.testing.assert_array_equal(bits(getattr(qj.mo, lane)),
                                      bits(getattr(qt.mo, lane)), lane)
    for l in range(3):
        mo_l = qt.layer(l).mo
        for lane in LANES:
            np.testing.assert_array_equal(
                bits(getattr(qj.mo, lane)[l]), bits(getattr(mo_l, lane)))
    np.testing.assert_allclose(qt.stats.numpy(), np.asarray(qj.stats),
                               rtol=1e-5)
    for k in info_j:
        assert info_t[k] == pytest.approx(info_j[k], rel=1e-5), k


def test_backend_choice_never_falls_back():
    mo_j, mo_t = packs((64, 128), "sub3", 7, True)
    x = torch.ones(2, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        tops.mixed_dot(x, mo_t, backend="cuda")
    with pytest.raises(ValueError, match="unknown backend"):
        tops.mixed_dot(x, mo_t, backend="xla")
    calls = tref.mixed_gemm_ref.calls
    tops.mixed_dot(x, mo_t, backend="torch")
    assert tref.mixed_gemm_ref.calls == calls + 1


def tiny_packs(recipe, algo):
    """Both packages' sub3 / sub4 pack (64 x 64 blocks) of mixed_tags
    input with block (0, 1) set to sign * U(1, 2) * 1e-37: its ideal GAM
    scale overflows f32 (gam keeps a finite scale, fp32_amax scales by
    Inf). Under gam the block also holds four bf16 denormals; not under
    fp32_amax, where XLA on the CPU reads a denormal as 0 and 0 * Inf is
    NaN, so the reference's payload byte would differ (ROADMAP Queue 3,
    "XLA flushes f32 denormals on the CPU")."""
    rng = np.random.default_rng(11)
    x = np.array(mixed_tags((256, 384), 9)[0].astype(jnp.float32))
    t = np.where(rng.standard_normal((64, 64)) > 0, 1.0, -1.0) * \
        rng.uniform(1, 2, (64, 64)) * 1e-37
    if algo == "gam":
        t[0, :4] = [1e-39, -2e-39, 5e-40, -9e-41]
    x[:64, 64:128] = t
    xj = jnp.asarray(x, jnp.bfloat16)
    from repro.core.mor import quantize_for_gemm as jqfg
    from repro_torch.core.mor import quantize_for_gemm as tqfg
    mo_j, _ = jit_ref(lambda v: jqfg(v, JPolicy(
        recipe=recipe, block_shape=(64, 64), algo=algo, backend="xla")))(xj)
    mo_t, _ = tqfg(to_torch(xj), TPolicy(recipe=recipe, block_shape=(64, 64),
                                         algo=algo))
    return mo_j, mo_t


@pytest.mark.parametrize("algo", ("gam", "fp32_amax"))
@pytest.mark.parametrize("recipe", ("sub3", "sub4"))
def test_fp8_block_tables_equal_decode(recipe, algo):
    """An fp8 block's stored values depend only on its tag, its scale
    and the byte: a 256-entry table round_bf16(fp8(byte) / scale) per
    block, looked up by payload_q, equals the plain version's and JAX's
    decode_mixed_ref bit for bit on every E4M3 and E5M2 block -- the
    tiny block and (under fp32_amax) its Inf scale, which decodes to
    silent zeros, included. (The tensor-core path decodes each element
    once with the same division; the streaming path through an f32
    table of fp8 values.)"""
    from repro_torch.core.formats import true_divide
    from repro_torch.core.partition import Partition, to_blocks
    mo_j, mo_t = tiny_packs(recipe, algo)
    for lane in ("payload_q", "tags", "scales"):
        np.testing.assert_array_equal(bits(getattr(mo_j, lane)),
                                      bits(getattr(mo_t, lane)), lane)
    tags, scales = mo_t.tags, mo_t.scales
    codes = torch.arange(256, dtype=torch.int32).to(torch.uint8)
    v4 = codes.view(torch.float8_e4m3fn).float()
    v5 = codes.view(torch.float8_e5m2).float()
    vals = torch.where((tags == tref.TAG_E5M2)[:, :, None], v5, v4)
    tables = true_divide(vals, scales[:, :, None]).to(torch.bfloat16)
    part = Partition("block", mo_t.block)
    qb = to_blocks(mo_t.payload_q, part)
    nr, nk, br, bk = qb.shape
    looked = torch.gather(tables, 2, qb.reshape(nr, nk, br * bk).long())
    looked = looked.reshape(nr, nk, br, bk)
    fp8 = (tags == tref.TAG_E4M3) | (tags == tref.TAG_E5M2)
    assert {tref.TAG_E4M3, tref.TAG_E5M2} <= set(tags[fp8].tolist())
    for dec in (tref.decode_mixed_ref(mo_t),
                to_torch(jit_ref(jref.decode_mixed_ref)(mo_j))):
        want = to_blocks(dec, part)
        np.testing.assert_array_equal(bits(looked[fp8]), bits(want[fp8]))
    assert bool(fp8[0, 1])  # the tiny block is an fp8 block
    if algo == "fp32_amax":
        assert float(scales[0, 1]) == float("inf")
        assert bool(qb[0, 1].any()) and not bool(looked[0, 1].float().any())


@pytest.mark.parametrize("m, path", [(1, "stream"), (4, "stream"),
                                     (32, "stream"), (64, "stream"),
                                     (65, "tc"), (129, "tc"), (200, "tc"),
                                     (2048, "tc")])
def test_gemm_path_by_rows(m, path):
    """M alone picks the kernel path: decode steps, prefill chunks and
    the head stream; the training GEMMs take the tensor cores."""
    from repro_torch.kernels.mixed_gemm import STREAM_MAX_M, gemm_path
    assert STREAM_MAX_M == 64
    assert gemm_path(m) == path


def test_passthrough_pack_lanes_read_as_all_bf16():
    """The stream kernel reads an activation's bf16 lane as it is where the
    wrapper's lane flags say every tag is BF16: fp8 lane compact, no
    NVFP4 lanes, bf16 lane dense (a lane is compact only where no tag
    names it). ``passthrough_mixed`` packs, ``mixed_dot``'s activations,
    carry those flags and decode to their own values; a quantized pack's
    fp8 lane is dense."""
    from repro_torch.kernels.mixed_gemm import _operand_args
    x = torch.randn(5, 256).to(torch.bfloat16)
    a = tref.passthrough_mixed(x, (tref.activation_row_block(5, 128), 128))
    assert bool((a.tags == tref.TAG_BF16).all())
    assert _operand_args(a, "a", a.tags.device)[-3:] == [0, 1, 0]
    np.testing.assert_array_equal(bits(a.dequant()), bits(x))
    _, mo = packs((128, 128), "sub3", 7, False)
    assert _operand_args(mo, "b", mo.tags.device)[-3] == 1


def test_launch_counters_by_path():
    """The wrapper counts every launch and each path's; a CPU product
    takes the plain version on either path's M and launches nothing."""
    from repro_torch.kernels.mixed_gemm import mixed_gemm_blocks as mgb
    assert set(mgb.launches_by_path) == {"stream", "tc"}
    _, mo_t = packs((128, 128), "sub3", 7, True)
    before = (mgb.launches, dict(mgb.launches_by_path))
    calls = tref.mixed_gemm_ref.calls
    for m in (4, 100):
        tops.mixed_dot(torch.ones(m, 128, dtype=torch.bfloat16), mo_t)
    assert tref.mixed_gemm_ref.calls == calls + 2
    assert (mgb.launches, mgb.launches_by_path) == before


@pytest.mark.parametrize("m, n, kp, splits", [
    (4, 28672, 4096, 5), (32, 28672, 4096, 4), (4, 6144, 4096, 16),
    (4, 4096, 4096, 16), (4, 4096, 14336, 33), (4, 128256, 4096, 2),
    (32, 128256, 4096, 2), (64, 4096, 4096, 2), (1, 4096, 14336, 33),
    (4, 200, 384, 1)])
def test_stream_plan(m, n, kp, splits):
    """The stream path's launch plan on a 132-SM card is a function of the
    shape alone: K splits only while the 128-row strips leave the card
    short of eight thread blocks an SM (four to 64 chunks of 64 a split,
    partials' traffic within a quarter of the weight's fp8 bytes); the
    workspace is the activation decoded to bf16 (rows padded to 8, 16, 32
    or 64, K to 64) plus, when K is split, no more than splits x M x N
    f32 partials. M alone still picks the path."""
    from repro_torch.kernels.mixed_gemm import (gemm_path, stream_plan,
                                                stream_rows)
    got, floats = stream_plan(m, n, kp, 132)
    assert got == splits and stream_plan(m, n, kp, 132) == (got, floats)
    chunks = -(-kp // 64)
    act = stream_rows(m) * chunks * 64 // 2
    assert stream_rows(m) in (8, 16, 32, 64) and stream_rows(m) >= m
    partials = floats - act
    assert partials == (splits * m * n if splits > 1 else 0)
    assert partials <= splits * m * n
    assert 1 <= splits and -(-chunks // splits) <= 64
    assert splits == 1 or splits * m * n * 8 <= n * kp / 4
    assert gemm_path(m) == "stream"


def card_operand(mo, device):
    return tref.MixedOperand(**{
        **mo.__dict__,
        **{lane: getattr(mo, lane).to(device) for lane in LANES}})


@pytest.mark.cuda
@pytest.mark.parametrize("N", (256, 200))
@pytest.mark.parametrize("M", (1, 4, 16, 32, 33, 64, 65, 129, 200))
def test_kernel_matches_plain_version_on_card(M, N, cuda_device):
    from repro_torch.kernels.mixed_gemm import gemm_path, mixed_gemm_blocks
    _, mo_t = packs((N, 384), "sub4", 8, True)
    mo = card_operand(mo_t, cuda_device)
    x = torch.randn(M, 384, device=cuda_device).to(torch.bfloat16)
    path = gemm_path(M)
    n0 = mixed_gemm_blocks.launches_by_path[path]
    ck = tops.mixed_dot(x, mo, out_dtype=torch.float32, backend="cuda")
    assert mixed_gemm_blocks.launches_by_path[path] == n0 + 1
    ct = tops.mixed_dot(x, mo, out_dtype=torch.float32, backend="torch")
    scale = x.double().abs() @ mo.dequant().double().abs().T
    assert bool(torch.all((ck - ct).abs().double() <= 1e-5 * scale))


def card_weight(kind, device):
    """(N, K) weights in 128 x 128 blocks, the stream kernel's table path:
    a ragged all-E4M3 sub3 pack (compact BF16 and NVFP4 lanes), the same
    at unit scale, K = 14336 (the split-K path), a mixed-tag sub3 pack
    (E4M3, E5M2 and BF16 blocks) and a sub4 pack with NVFP4 blocks."""
    from repro_torch.core.mor import quantize_for_gemm
    rng = np.random.default_rng(12)
    if kind in ("e4m3 ragged", "e4m3 unit"):
        w = torch.from_numpy(rng.standard_normal((1000, 4096)) * (
            0.02 if kind == "e4m3 ragged" else 1.0))
        recipe = "sub3"
    elif kind == "K=14336":
        w = torch.from_numpy(rng.standard_normal((384, 14336)) * 0.02)
        recipe = "sub3"
    else:
        w = to_torch(mixed_tags((1024, 1024), 13)[0])
        recipe = "sub3" if kind == "mixed sub3" else "sub4"
    mo, _ = quantize_for_gemm(w.to(torch.bfloat16), TPolicy(recipe=recipe))
    return card_operand(mo.compact(), device)


def tiny_rows(m, k, device, seed=0):
    """(m, k) bf16 activation, tiny in every k block: the first half of
    the rows sign * U(1, 2) * 1e-37 with every eighth element a bf16
    denormal, the rest all bf16 denormals (sign * U(1, 2) * 5e-39).
    Against 0.02-scale weights some results are bf16 denormals, which a
    path that flushed denormals would zero."""
    rng = np.random.default_rng(seed)
    sign = np.where(rng.standard_normal((m, k)) > 0, 1.0, -1.0)
    x = sign * rng.uniform(1, 2, (m, k)) * 1e-37
    x[:, ::8] *= 5e-2
    x[m // 2:] = sign[m // 2:] * rng.uniform(1, 2, (m - m // 2, k)) * 5e-39
    return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16).to(
        device)


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("kind", ("e4m3 ragged", "e4m3 unit", "K=14336",
                                  "mixed sub3", "sub4 nvfp4"))
@pytest.mark.parametrize("act", ("randn", "tiny"))
@pytest.mark.parametrize("M", (1, 4, 16, 32, 64))
def test_stream_path_on_card(M, act, kind, out_dtype, cuda_device):
    """The stream path on 128 x 128 packs against the plain version, on
    normal activations and on tiny rows with bf16 denormals: within
    1e-5 sum |a||b| (+ one bf16 ulp of the result for bf16 output, at
    least 2^-133, the ulp of a bf16 denormal), and a second launch repeats
    the first bit for bit (the split-K sum has a fixed order)."""
    from repro_torch.kernels.mixed_gemm import mixed_gemm_blocks
    mo = card_weight(kind, cuda_device)
    tags = set(mo.tags.reshape(-1).tolist())
    if kind == "mixed sub3":
        assert {tref.TAG_E4M3, tref.TAG_E5M2, tref.TAG_BF16} <= tags
    if kind == "sub4 nvfp4":
        assert tref.TAG_NVFP4 in tags
    if act == "tiny":
        x = tiny_rows(M, mo.shape[1], cuda_device)
    else:
        x = torch.randn(M, mo.shape[1], device=cuda_device).to(
            torch.bfloat16)
    n0 = mixed_gemm_blocks.launches_by_path["stream"]
    ck = tops.mixed_dot(x, mo, out_dtype=out_dtype, backend="cuda")
    again = tops.mixed_dot(x, mo, out_dtype=out_dtype, backend="cuda")
    assert mixed_gemm_blocks.launches_by_path["stream"] == n0 + 2
    assert torch.equal(ck, again)
    ct = tops.mixed_dot(x, mo, out_dtype=out_dtype, backend="torch")
    w = mo.dequant().double()
    tol = 1e-5 * (x.double().abs() @ w.abs().T)
    if out_dtype == torch.bfloat16:
        tol = tol + (2.0**-7 * ct.double().abs()).clamp_min(2.0**-133)
    assert bool(torch.all((ck.double() - ct.double()).abs() <= tol))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU or "
                    "interpret mode (chip_smoke.py runs them on the card)")
    return torch.device("cuda")
