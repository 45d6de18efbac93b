"""The two routes of the MoR selection kernels (``kernels.mor_select``).

On the CPU: the tile route's stored value of an fp8 code -- a per-warp
table of the 128 magnitudes' bf16(value / scale) under the block's
scale, the code's sign bit put on the entry -- emulated in plain
PyTorch and held bit for bit against the reference's IEEE division then
bf16 rounding, for all 256 codes of E4M3 and E5M2, over seeded sweeps of
GAM, fp32_amax and e8m0 scales and the +Inf scale of a tiny block
(quotients that overflow to Inf and quotients that are subnormal
included); then the same emulation fed the codes of the reference's
clip-and-cast of seeded operands. ``mor_select_route`` on every block
and mode.

On the card (``cuda``-marked): both routes on every mode x algo against
the plain versions, on a ragged operand with every tag, NaN, Inf, zero
and tiny (Inf-scale) blocks: every lane, tag, scale, count and ``y`` bit
for bit, the error sums within rtol 1e-5, each launch on the route the
block names, and repeats bit-identical."""
import numpy as np
import pytest
import torch

from repro_torch.core.formats import E4M3, E5M2, cast_to_format, true_divide
from repro_torch.core.partition import Partition
from repro_torch.kernels import ops
from repro_torch.kernels.mor_select import (
    ROUTES, mor_select_pack, mor_select_route, mor_select_select)

MODES = ("sub2", "sub3", "sub4")
ALGOS = ("gam", "e8m0", "fp32_amax")
FMTS = {"e4m3": E4M3, "e5m2": E5M2}
FAMILIES = ("gam", "fp32_amax", "e8m0", "inf")


def code_values(fmt) -> torch.Tensor:
    """The f32 value of every fp8 byte 0..255 of ``fmt``."""
    return torch.arange(256, dtype=torch.uint8).view(fmt.dtype).to(
        torch.float32)


def bf16_bits(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).view(torch.int16).to(torch.int32) & 0xFFFF


def table_stored_bits(codes: torch.Tensor, scales: torch.Tensor,
                      fmt) -> torch.Tensor:
    """The tile route's stored value (bf16 bits) of each code (int64) under
    each scale (one row per scale): the warp's table of the magnitudes
    0..127 through an IEEE division by the scale and RNE to bf16, indexed
    by the code's low 7 bits, with the code's sign bit ORed on."""
    mags = code_values(fmt)[:128]
    table = bf16_bits(true_divide(mags[None, :], scales[:, None]))
    entry = torch.gather(table, 1, (codes & 0x7F).expand(len(scales), -1))
    return entry | ((codes & 0x80) << 8)


def divided_bits(values: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """The reference's stored value: IEEE division, then bf16 (RNE)."""
    return bf16_bits(true_divide(values, scales[:, None]))


def scale_sweep(fmt, family: str) -> torch.Tensor:
    """Seeded f32 block scales of one Alg. 1 family: GAM mantissas in
    [1, 2) at every exponent in [-126, 127]; fp32_amax's q_amax / amax over
    log-uniform amaxes; e8m0's powers of two; the +Inf scale of a block
    whose amax is below q_amax / f32max."""
    rng = np.random.default_rng(19)
    e = np.arange(-126, 128)
    if family == "gam":
        m = rng.uniform(1, 2, (3, e.size)).astype(np.float32)
        m[0] = 1.0
        s = np.ldexp(m, e[None, :]).astype(np.float32).reshape(-1)
    elif family == "fp32_amax":
        amax = np.exp2(rng.uniform(-100, 120, 2000)).astype(np.float32)
        s = (np.float32(fmt.amax) / amax).astype(np.float32)
    elif family == "e8m0":
        s = np.ldexp(np.float32(1.0), e).astype(np.float32)
    else:
        s = np.array([np.inf], np.float32)
    return torch.from_numpy(s)


def assert_bits_equal(got: torch.Tensor, want: torch.Tensor, what: str):
    """bf16 bit patterns equal; NaN only where the reference is NaN."""
    nan_g = (got & 0x7F80 == 0x7F80) & (got & 0x7F != 0)
    nan_w = (want & 0x7F80 == 0x7F80) & (want & 0x7F != 0)
    assert torch.equal(nan_g, nan_w), what + ": NaN positions"
    assert torch.equal(torch.where(nan_w, 0, got),
                       torch.where(nan_w, 0, want)), what


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("fmt", FMTS)
def test_stored_value_table_is_the_division(fmt, family):
    """Every code of the format under every scale of the sweep: the
    table's entry with the code's sign equals the division's bf16."""
    f = FMTS[fmt]
    scales = scale_sweep(f, family)
    codes = torch.arange(256, dtype=torch.int64)[None, :]
    got = table_stored_bits(codes, scales, f)
    want = divided_bits(code_values(f)[None, :], scales)
    assert_bits_equal(got, want, f"{fmt} {family}")
    if family == "gam":
        # The sweep reaches the edges the table must get right.
        assert bool((want & 0x7FFF == 0x7F80).any()), "no quotient overflows"
        sub = (want & 0x7F80 == 0) & (want & 0x7F != 0)
        assert bool(sub.any()), "no quotient is subnormal"
    if family == "inf":
        finite = torch.isfinite(code_values(f))
        assert bool((want[0, finite] & 0x7FFF == 0).all())


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("fmt", FMTS)
def test_table_lookup_matches_reference_candidate(fmt, family):
    """The kernel's pass 2 on seeded operands: the code of x * s (the
    reference's clip and cast) looked up in the table equals the
    reference's candidate, (clip-and-cast(x * s) / s) -> bf16, for normal
    values, values past the format's range, zeros, +-Inf and bf16
    denormals."""
    f = FMTS[fmt]
    scales = scale_sweep(f, family)[::7]
    rng = np.random.default_rng(3)
    x = rng.standard_normal(512) * np.exp2(rng.integers(-40, 40, 512))
    x[:8] = [0.0, -0.0, np.inf, -np.inf, 1e-39, -5e-40, 3e38, -3e38]
    x = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16).to(
        torch.float32)
    xs = x[None, :] * scales[:, None]
    cast = cast_to_format(xs, f)
    codes = cast.to(f.dtype).view(torch.uint8).to(torch.int64)
    got = torch.stack([table_stored_bits(codes[r:r + 1], scales[r:r + 1], f)[0]
                       for r in range(len(scales))])
    want = bf16_bits(true_divide(cast, scales[:, None]))
    assert_bits_equal(got, want, f"{fmt} {family}")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("block,route", [
    ((128, 128), "tile"), ((64, 64), "generic"), ((128, 256), "generic"),
    ((256, 128), "generic"), ((32, 128), "generic"), ((128, 64), "generic"),
])
def test_route_by_block(block, route, mode):
    assert mor_select_route(block, mode) == route
    assert route in ROUTES


@pytest.mark.parametrize("block,mode", [
    ((128, 120), "sub4"), ((127, 128), "sub4"), ((1, 16), "sub4"),
    ((0, 128), "sub3"), ((128, 128), "sub5"),
])
def test_route_refuses(block, mode):
    """sub4 needs even rows and 16-divisible columns; blocks are positive;
    modes are sub2 / sub3 / sub4."""
    with pytest.raises(ValueError):
        mor_select_route(block, mode)


@pytest.mark.parametrize("mode", ["sub2", "sub3"])
def test_route_takes_unaligned_blocks_below_sub4(mode):
    """Without NVFP4 lanes any positive block has a route (generic)."""
    assert mor_select_route((128, 120), mode) == "generic"
    assert mor_select_route((1, 1), mode) == "generic"


@pytest.mark.parametrize("wrapper", [mor_select_pack, mor_select_select])
def test_cpu_tensor_reaches_no_route(wrapper):
    """The kernel wrappers take CUDA tensors only: a CPU operand raises
    before any launch and counts on no route."""
    before = dict(wrapper.launches_by_route)
    with pytest.raises(ValueError, match="CUDA"):
        wrapper(torch.zeros(128, 128, dtype=torch.bfloat16),
                torch.ones(4), block=(128, 128), mode="sub3")
    assert wrapper.launches_by_route == before


def operand(shape, block, seed=0):
    """Blocks of every tag (normal, huge-range, moderate-range and
    E2M1-grid rows), an all-zero stripe, a NaN and an Inf, and block (0, 1)
    tiny: sign * U(1, 2) * 1e-37 with bf16 denormals and a zero, so the
    ideal scale of every format overflows to +Inf."""
    rng = np.random.default_rng(seed)
    m, k = shape
    x = rng.standard_normal((m, k))
    q = m // 4
    x[q:2 * q, :k // 2] *= np.exp2(rng.integers(-20, 20, (q, k // 2)))
    x[q:2 * q, k // 2:] = np.sign(x[q:2 * q, k // 2:]) * rng.uniform(
        1, 2, (q, k - k // 2)) * np.exp2(rng.integers(-12, 4, (q, k - k // 2)))
    grid = np.array([0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0])
    kk = -(-k // 16) * 16
    mm = grid[rng.integers(0, 7, (q, kk))] * np.exp2(
        rng.integers(-9, 9, (q, kk // 16))).repeat(16, axis=1)
    x[2 * q:3 * q] = (mm * np.where(rng.standard_normal((q, kk)) > 0, 1, -1)
                      )[:, :k]
    x[-m // 8:] = 0.0
    bm, bk = block
    t = np.where(rng.standard_normal((bm, bk)) > 0, 1.0, -1.0) * rng.uniform(
        1, 2, (bm, bk)) * 1e-37
    t[0, :6] = [1e-39, -2e-39, 5e-40, -9e-41, 0.0, -1e-38]
    x[:bm, bk:2 * bk] = t[:, :max(0, min(bk, k - bk))]
    x[5, 7] = np.nan
    x[m // 2 + 3, k - 9] = np.inf
    return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU or "
                    "interpret mode (chip_smoke.py runs them on the card)")
    return torch.device("cuda")


def bits(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16)
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    return t


@pytest.mark.cuda
@pytest.mark.parametrize("block", [(64, 64), (128, 128)])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("algo", ALGOS)
def test_both_routes_match_plain_versions_on_card(block, mode, algo,
                                                   cuda_device):
    """Pack and select on the route of ``block`` against the plain
    versions on the same CUDA tensors (ragged 200 x 264 operand), then
    once more: the second run bit-identical to the first."""
    x = operand((200, 264), block, seed=11).to(cuda_device)
    route = mor_select_route(block, mode)
    align = (2, 16) if mode == "sub4" else (1, 1)
    part = Partition("block", block, align=align)
    before = (dict(mor_select_pack.launches_by_route),
              dict(mor_select_select.launches_by_route))
    runs = [(ops.quantize_pack(x, part, mode, algo, backend="cuda"),
             ops.mor_select(x, part, mode, algo, backend="cuda"))
            for _ in range(2)]
    torch.cuda.synchronize()
    for table, was in zip((mor_select_pack.launches_by_route,
                           mor_select_select.launches_by_route), before):
        assert table[route] == was[route] + 2, route
    (mo_t, r_t) = ops.quantize_pack(x, part, mode, algo, backend="torch")
    s_t = ops.mor_select(x, part, mode, algo, backend="torch")
    for (mo_k, r_k), s_k in runs:
        for lane in ("payload_q", "payload_bf16", "payload_nib",
                     "micro_scales", "tags", "scales"):
            a, b = getattr(mo_k, lane), getattr(mo_t, lane)
            assert (a is None) == (b is None), lane
            if a is not None:
                assert torch.equal(bits(a), bits(b)), lane
        assert torch.equal(bits(s_k.y), bits(s_t.y)), "y"
        for r_kk, r_tt in ((r_k, r_t), (s_k, s_t)):
            assert torch.equal(r_kk.sel, r_tt.sel)
            assert torch.equal(r_kk.counts, r_tt.counts)
            for f in ("e4_sums", "e5_sums", "nv_sums"):
                a, b = getattr(r_kk, f), getattr(r_tt, f)
                if a is None and b is None:
                    continue
                assert torch.allclose(a, b, rtol=1e-5, atol=0.0,
                                      equal_nan=True), f
    (mo_1, r_1), s_1 = runs[0]
    (mo_2, r_2), s_2 = runs[1]
    for a, b in ((mo_1.payload_q, mo_2.payload_q), (s_1.y, s_2.y),
                 (r_1.e4_sums, r_2.e4_sums), (r_1.e5_sums, r_2.e5_sums),
                 (s_1.e4_sums, s_2.e4_sums), (s_1.e5_sums, s_2.e5_sums)):
        assert torch.equal(bits(a), bits(b)), "repeat differs"
    if mode == "sub4":
        assert torch.equal(bits(r_1.nv_sums), bits(r_2.nv_sums))


def test_ablation_edit_points_present():
    """``kernels/mor_select_ablation.py`` finds each of its edit points
    exactly once in its file (the kernel's source or the tile route's
    shared header), so every copy differs from ``full``."""
    from repro_torch.kernels import build
    from repro_torch.kernels import mor_select_ablation as ablation
    srcs = {f: (build.CSRC / f).read_text() for f in ablation.SOURCES}
    copies = ablation.edited_sources(srcs)
    assert set(copies) == set(ablation.ABLATIONS)
    for name, texts in copies.items():
        assert (texts == srcs) == (name == "full"), name


@pytest.mark.cuda
@pytest.mark.parametrize("b_exp", [-80, 0, 79])
def test_div_in_range_matches_division_on_card(b_exp, cuda_device):
    """The tile route's Eq. 1 division against the IEEE division, bit for
    bit, on the card: every f32 numerator significand in twelve binades
    (both signs) against every bf16 divisor significand at 2^b_exp."""
    import ctypes
    from repro_torch.kernels import build
    f = build.load("mor_select").mor_select_div_check_launch
    f.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    f.restype = ctypes.c_int
    bad = torch.zeros(1, dtype=torch.int64, device=cuda_device)
    assert f(b_exp, bad.data_ptr(),
             torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    assert int(bad.item()) == 0


# ------------------------------------------ generic routes' shared memory --
# The blocks of the gradient compression's leaves at reduced widths (d 64)
# and the blocks whose dynamic shared memory is exactly 48 KB: with the
# kernels' static scratch the CTA then needs more than the default 48 KB,
# which a launch gets only by opting in.
SMEM_BLOCKS = [((4, 64), torch.float32), ((1, 64), torch.float32),
               ((128, 96), torch.float32), ((128, 64), torch.float32),
               ((128, 192), torch.bfloat16)]


@pytest.mark.parametrize("block,dtype", SMEM_BLOCKS + [
    ((128, 96), torch.bfloat16), ((128, 176), torch.bfloat16)])
@pytest.mark.parametrize("mode", MODES)
def test_generic_smem_bytes(block, dtype, mode):
    """The bytes the generic kernels declare per CTA: the block in x's
    dtype (rounded up to 16 bytes), under sub4 one f32 micro amax per
    micro group, plus a bound on the static scratch (each declared array
    rounded up to 16 bytes: 304 in the selection, 528 in gam_quant; the
    card reports 272 and 528)."""
    from repro_torch.kernels.gam_quant import gam_quant_smem_bytes
    from repro_torch.kernels.mor_select import mor_select_smem_bytes
    bm, bk = block
    size = 4 if dtype == torch.float32 else 2
    dyn = -(-bm * bk * size // 16) * 16
    if mode == "sub4":
        dyn += bm * (bk // 16) * 4
    assert mor_select_smem_bytes(block, mode, dtype) == (dyn, 304)
    assert gam_quant_smem_bytes(block) == (bm * bk * 2, 528)
    if (block, dtype, mode) in (((128, 96), torch.float32, "sub3"),
                                ((128, 192), torch.bfloat16, "sub3")):
        # The failing launches: exactly 48 KB of dynamic memory.
        assert dyn == 48 * 1024
    if (block, mode) == ((128, 176), "sub4"):
        # sub4's micro amaxes move the window: 44 KB + 5.5 KB.
        assert dyn == 128 * 176 * 2 + 128 * 11 * 4


@pytest.mark.parametrize("variant", ["pack", "select", "select_f32",
                                     "gam_quant"])
def test_generic_block_beyond_optin_refused(variant):
    """A block whose CTA would need more shared memory than an sm_90 CTA
    can opt in to (227 KB) is refused by name before any launch (the
    check runs before the operand's device is looked at, so it shows on
    the CPU)."""
    from repro_torch.kernels.gam_quant import gam_quant_blocks
    from repro_torch.kernels.mor_select import SMEM_OPTIN_BYTES
    block = (256, 512)
    dtype = torch.float32 if variant == "select_f32" else torch.bfloat16
    x = torch.zeros(block, dtype=dtype)
    need = 256 * 512 * (4 if variant == "select_f32" else 2)
    assert need > SMEM_OPTIN_BYTES
    with pytest.raises(ValueError, match=r"\(256, 512\).*"
                       + str(need)) as e:
        if variant == "gam_quant":
            gam_quant_blocks(x, torch.zeros(2), block=block)
        elif variant == "pack":
            mor_select_pack(x, torch.zeros(4), block=block)
        else:
            mor_select_select(x, torch.zeros(4), block=block)
    assert str(SMEM_OPTIN_BYTES) in str(e.value)
    # The largest block that fits is accepted by the same check.
    from repro_torch.kernels.mor_select import mor_select_smem_bytes
    dyn, static = mor_select_smem_bytes((128, 448), "sub3", torch.bfloat16)
    assert dyn + static <= SMEM_OPTIN_BYTES


def smem_operand(shape, dtype, seed):
    """N(0, 1) rows with a moderate-range stripe (E5M2 blocks), an
    all-zero row, and in f32 values that are not bf16-exact."""
    rng = np.random.default_rng(seed)
    m, k = shape
    x = rng.standard_normal((m, k))
    x[:, ::3] = np.sign(x[:, ::3]) * rng.uniform(1, 2, (m, len(range(0, k, 3)))
                                                  ) * np.exp2(
        rng.integers(-12, 4, (m, len(range(0, k, 3)))))
    if m > 2:
        x[m // 2] = 0.0
    if dtype == torch.float32:
        x = x * (1 + rng.uniform(0, 2.0**-10, x.shape))
    return torch.from_numpy(x.astype(np.float32)).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("block,dtype", SMEM_BLOCKS + [
    ((128, 96), torch.bfloat16)])
@pytest.mark.parametrize("ragged", [False, True])
def test_generic_routes_launch_at_smem_edges_on_card(block, dtype, ragged,
                                                     cuda_device):
    """Each generic instance (pack, select bf16 and f32, gam_quant; sub3
    and sub4) at the blocks of the gradient compression and at the 48 KB
    boundary, on one row of blocks and on a ragged multi-block operand:
    it launches, and matches its plain version (payloads, tags, scales,
    y and xq bit for bit; the selection's error sums within rtol 1e-5,
    gam_quant's within 1e-6)."""
    from repro_torch.core.formats import E4M3
    from repro_torch.kernels.gam_quant import gam_quant_blocks
    bm, bk = block
    shape = (2 * bm + 3, 2 * bk + 5) if ragged else (bm, 3 * bk)
    x = smem_operand(shape, dtype, seed=bm + bk).to(cuda_device)
    for mode in ("sub3", "sub4"):
        if mode == "sub4" and (bm % 2 or bk % 16):
            continue
        align = (2, 16) if mode == "sub4" else (1, 1)
        part = Partition("block", block, align=align)
        assert mor_select_route(block, mode, dtype) == "generic"
        k = ops.mor_select(x, part, mode, backend="cuda")
        t = ops.mor_select(x, part, mode, backend="torch")
        assert torch.equal(bits(k.y), bits(t.y)) and torch.equal(k.sel, t.sel)
        for f in ("e4_sums", "e5_sums", "nv_sums"):
            a, b = getattr(k, f), getattr(t, f)
            assert a is None or torch.allclose(a, b, rtol=1e-5, atol=0.0,
                                               equal_nan=True), f
        if dtype == torch.bfloat16:
            mo_k, _ = ops.quantize_pack(x, part, mode, backend="cuda")
            mo_t, _ = ops.quantize_pack(x, part, mode, backend="torch")
            for lane in ("payload_q", "payload_bf16", "payload_nib",
                         "micro_scales", "tags", "scales"):
                assert torch.equal(bits(getattr(mo_k, lane)),
                                   bits(getattr(mo_t, lane))), lane
    if dtype == torch.bfloat16:
        before = gam_quant_blocks.launches_by_route["generic"]
        k = ops.gam_quant(x, block=block, fmt=E4M3, backend="cuda")
        t = ops.gam_quant(x, block=block, fmt=E4M3, backend="torch")
        assert gam_quant_blocks.launches_by_route["generic"] == before + 1
        for a, b in ((k[0], t[0]), (k[1], t[1]), (k[3], t[3])):
            assert torch.equal(bits(a), bits(b))
        assert torch.allclose(k[2], t[2], rtol=1e-6, atol=0.0)
    torch.cuda.synchronize()
