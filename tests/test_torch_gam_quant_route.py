"""The two routes of the one-format quantize kernel (``kernels.gam_quant``).

On the CPU: ``gam_quant_route`` on the blocks it takes and refuses; the
wrapper refusing a CPU tensor before any launch; and the ``tile`` route's
arithmetic emulated in plain PyTorch -- each element's fp8 code from the
saturating cast of x * scale (what ``cvt.satfinite`` gives: beyond the
format's max, Inf included, the max; NaN stays NaN), its stored value
from the warp's table of the 128 magnitudes' bf16(value / scale) with the
code's sign bit put on, and the Eq. 1 errors of the nonzero elements
summed in f64 and rounded once -- held against ``kernels.ref.
gam_quant_ref`` on seeded operands with NaN, Inf, zero and tiny
(Inf-scale under fp32_amax) blocks, under every algo and both formats:
the stored values bit for bit (NaN positions compared as positions),
the error sums within 1e-6 relative (the plain version sums in f32 in
PyTorch's order).

On the card (``cuda``-marked): both routes on E4M3 / E5M2 x every algo
against the plain version on a ragged operand with NaN, Inf, zero and
tiny blocks: xq, block_exp and counts bit for bit, the error sums within
1e-6 relative, each launch on the route its block names, and repeats
bit-identical."""
import numpy as np
import pytest
import torch
from test_torch_mor_select_route import (assert_bits_equal, bf16_bits,
                                         operand, table_stored_bits)

from repro_torch.core.formats import E4M3, E5M2
from repro_torch.core.gam import compute_scales
from repro_torch.core.partition import Partition, to_blocks
from repro_torch.kernels import ops
from repro_torch.kernels.gam_quant import (ROUTES, gam_quant_blocks,
                                           gam_quant_route)
from repro_torch.kernels.ref import gam_quant_ref

ALGOS = ("gam", "e8m0", "fp32_amax")
FMTS = {"e4m3": E4M3, "e5m2": E5M2}


@pytest.mark.parametrize("block,route", [
    ((128, 128), "tile"), ((64, 64), "generic"), ((200, 136), "generic"),
    ((1, 128), "generic"), ((128, 256), "generic"), ((256, 128), "generic"),
])
def test_route_by_block(block, route):
    assert gam_quant_route(block) == route
    assert route in ROUTES


@pytest.mark.parametrize("block", [(0, 128), (128, 0), (-1, 16), (0, 0)])
def test_route_refuses(block):
    """Blocks are positive."""
    with pytest.raises(ValueError):
        gam_quant_route(block)


def test_cpu_tensor_reaches_no_route():
    """The kernel wrapper takes CUDA tensors only: a CPU operand raises
    before any launch and counts on no route."""
    before = (gam_quant_blocks.launches,
              dict(gam_quant_blocks.launches_by_route))
    with pytest.raises(ValueError, match="CUDA"):
        gam_quant_blocks(torch.zeros(128, 128, dtype=torch.bfloat16),
                         torch.ones(2), block=(128, 128))
    assert (gam_quant_blocks.launches,
            dict(gam_quant_blocks.launches_by_route)) == before


def tile_route(x: torch.Tensor, fmt, algo: str, block=(128, 128)):
    """The tile route's stored values (bf16 bits, (nm, nk, bm, bk) blocks)
    and f64 Eq. 1 sums of a padded bf16 operand, in plain PyTorch: the
    block scales as the kernel derives them (the plain version's Alg. 1),
    the codes of the saturating cast of x * scale, the table lookup."""
    part = Partition("block", block)
    scales = compute_scales(x, part, fmt, algo).scale
    xb = to_blocks(x.to(torch.float32), part)
    nm, nk, bm, bk = xb.shape
    xs = xb * scales[:, :, None, None]
    sat = torch.clamp(xs, -fmt.amax, fmt.amax)  # NaN stays NaN
    codes = sat.to(fmt.dtype).view(torch.uint8).to(torch.int64)
    per_block = codes.reshape(nm * nk, 1, bm * bk)
    stored = torch.stack([
        table_stored_bits(c, s.reshape(1), fmt)[0]
        for c, s in zip(per_block, scales.reshape(-1))]).reshape(nm, nk, bm, bk)
    st = (stored.to(torch.int32) << 16).view(torch.float32).to(torch.float64)
    x64 = xb.to(torch.float64)
    nz = xb != 0
    # Each Eq. 1 term is an f32 quotient of exact f32 operands (x and its
    # stored value are bf16, so x - st is exact): the f64 quotient
    # rounded to f32 is that term.
    terms = ((x64 - st) / torch.where(nz, x64, torch.ones_like(x64))).to(
        torch.float32).abs().to(torch.float64)
    sums = torch.where(nz, terms, torch.zeros_like(terms)).sum(dim=(2, 3))
    return stored, sums.to(torch.float32)


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("fmt", FMTS)
def test_table_route_matches_plain_version(fmt, algo):
    """A 256 x 384 operand of six 128 x 128 blocks (every sub3 tag's
    kind of block, an all-zero stripe, a NaN, an Inf, and block (0, 1)
    of ~1e-37 values with bf16 denormals, whose ideal scale overflows to
    +Inf) through the emulated tile route and ``gam_quant_ref``."""
    f = FMTS[fmt]
    x = operand((256, 384), (128, 128), seed=20)
    part = Partition("block", (128, 128))
    xq, _, err, _ = gam_quant_ref(x, part, f, algo)
    stored, sums = tile_route(x, f, algo)
    want = bf16_bits(to_blocks(xq.to(torch.float32), part))
    assert_bits_equal(stored.to(torch.int32), want, f"{fmt} {algo}")
    np.testing.assert_array_equal(sums.isnan().numpy(), err.isnan().numpy())
    ok = ~err.isnan()
    rel = (sums[ok] - err[ok]).abs() / err[ok].abs().clamp_min(1e-30)
    assert float(rel.max()) <= 1e-6, (fmt, algo, float(rel.max()))
    if algo == "fp32_amax":
        s = compute_scales(x, part, f, algo).scale
        assert bool(torch.isinf(s[0, 1])), "the tiny block's scale is finite"


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
@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("algo", ALGOS)
def test_both_routes_match_plain_version_on_card(block, fmt, algo,
                                                  cuda_device):
    """``ops.gam_quant`` on the route of ``block`` against the plain
    version on the same CUDA tensors (ragged 200 x 264 operand), twice:
    the second run bit-identical to the first."""
    f = FMTS[fmt]
    x = operand((200, 264), block, seed=11).to(cuda_device)
    route = gam_quant_route(block)
    before = dict(gam_quant_blocks.launches_by_route)
    runs = [ops.gam_quant(x, block=block, fmt=f, algo=algo, backend="cuda")
            for _ in range(2)]
    torch.cuda.synchronize()
    assert gam_quant_blocks.launches_by_route[route] == before[route] + 2
    assert sum(gam_quant_blocks.launches_by_route.values()) == \
        sum(before.values()) + 2
    t = ops.gam_quant(x, block=block, fmt=f, algo=algo, backend="torch")
    for k in runs:
        for i, name in ((0, "xq"), (1, "block_exp"), (3, "counts")):
            assert torch.equal(bits(k[i]), bits(t[i])), name
        assert torch.equal(k[2].isnan(), t[2].isnan()), "NaN error sums"
        ok = ~t[2].isnan()
        rel = (k[2][ok] - t[2][ok]).abs() / t[2][ok].abs().clamp_min(1e-30)
        assert float(rel.max()) <= 1e-6, float(rel.max())
    for a, b in zip(runs[0], runs[1]):
        assert torch.equal(bits(a), bits(b)), "repeat differs"


def test_ablation_edit_points_present():
    """``kernels/gam_quant_ablation.py`` finds each of its edit points
    exactly once in its file (the kernel's source or the tile route's
    shared header), so every copy differs from ``full``."""
    from repro_torch.kernels import build
    from repro_torch.kernels import gam_quant_ablation as ablation
    from repro_torch.kernels.mor_select_ablation import edited_sources
    srcs = {f: (build.CSRC / f).read_text() for f in ablation.SOURCES}
    copies = edited_sources(srcs, ablation.ABLATIONS)
    assert set(copies) == set(ablation.ABLATIONS)
    for name, texts in copies.items():
        assert (texts == srcs) == (name == "full"), name
