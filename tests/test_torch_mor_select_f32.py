"""The select kernel's f32 instance (``kernels.mor_select.
mor_select_select`` on an f32 operand: the gradient compression's views)
against the plain version on the card. It is the generic kernel's, for
every block: 128 x 128 (the blocks that take the tile route in bf16), 64
x 64, and the small blocks a norm scale's view resolves to. Inputs are f32 values that are not
bf16-exact, with blocks that hit every tag, NaN, Inf and zero blocks and
a block whose ideal GAM scale overflows to Inf. y, sel and counts bit for
bit, the error sums within rtol 1e-5 (the same terms summed in the
kernel's order and PyTorch's), repeats bit-identical.

The CPU half checks what the wrapper does before a launch: the dtypes it
takes and the errors it raises. This file imports no JAX (the JAX
comparison of the f32 selection is in ``tests/test_torch_train_state.
py``)."""
import numpy as np
import pytest
import torch

from repro_torch.core.partition import Partition
from repro_torch.kernels import ops
from repro_torch.kernels.mor_select import (SELECT_DTYPES, mor_select_route,
                                            mor_select_select)

MODES = ("sub2", "sub3", "sub4")
ALGOS = ("gam", "e8m0", "fp32_amax")


def f32_operand(shape, block, seed=0):
    """Every tag's rows (normal, huge and moderate range, E2M1-grid rows
    with a 1 + 2^-12 jitter), an all-zero stripe, a NaN, an Inf, and
    block (0, 1) filled with sign * U(1, 2) * 1e-37 (its ideal scales
    overflow f32)."""
    rng = np.random.default_rng(seed)
    m, k = shape
    x = rng.standard_normal((m, k))
    q = m // 4
    x[q:2 * q, :k // 2] *= np.exp2(rng.integers(-20, 20, (q, k // 2)))
    x[q:2 * q, k // 2:] *= np.exp2(rng.integers(-12, 4, (q, k - k // 2)))
    grid = np.array([0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0])
    mm = grid[rng.integers(0, 7, (q, k))] * np.exp2(
        rng.integers(-9, 9, (q, k // 16))).repeat(16, axis=1)
    x[2 * q:3 * q] = mm * np.where(rng.standard_normal((q, k)) > 0, 1, -1) \
        * (1 + rng.uniform(-2**-12, 2**-12, (q, k)))
    x[-(m // 8):] = 0.0
    bm, bk = block
    x[:bm, bk:2 * bk] = np.where(rng.standard_normal((bm, bk)) > 0, 1, -1) \
        * rng.uniform(1, 2, (bm, bk)) * 1e-37
    x[5, 7] = np.nan
    x[m // 2 + 3, k - 9] = np.inf
    return torch.from_numpy(x.astype(np.float32))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU or "
                    "interpret mode (chip_smoke.py runs them on the card)")
    return torch.device("cuda")


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", ("block128", "block64", "norm_scale"))
def test_f32_select_matches_plain_version_on_card(case, mode, cuda_device):
    shape, block = {"block128": ((384, 512), (128, 128)),
                    "block64": ((256, 384), (64, 64)),
                    "norm_scale": ((4, 4096), (128, 128))}[case]
    x = (f32_operand(shape, block) if case != "norm_scale" else
         torch.from_numpy(np.random.default_rng(3).standard_normal(shape)
                          .astype(np.float32))).to(cuda_device)
    align = (2, 16) if mode == "sub4" else (1, 1)
    part = Partition("block", block, align=align)
    route = mor_select_route(part.resolve(shape), mode, torch.float32)
    assert route == "generic"
    for algo in ALGOS:
        by_dtype = mor_select_select.launches_by_dtype["float32"]
        by_route = mor_select_select.launches_by_route[route]
        k = ops.mor_select(x, part, mode, algo, backend="cuda")
        t = ops.mor_select(x, part, mode, algo, backend="torch")
        k2 = ops.mor_select(x, part, mode, algo, backend="cuda")
        torch.cuda.synchronize()
        assert mor_select_select.launches_by_dtype["float32"] == by_dtype + 2
        assert mor_select_select.launches_by_route[route] == by_route + 2
        assert k.y.dtype == torch.float32
        assert torch.equal(_bits(k.y), _bits(t.y)), (case, mode, algo)
        assert torch.equal(k.sel, t.sel) and torch.equal(k.counts, t.counts)
        for f in ("y", "sel", "e4_sums", "e5_sums", "counts", "nv_sums"):
            a, b = getattr(k, f), getattr(k2, f)
            assert a is None or torch.equal(_bits(a), _bits(b)), f
        for f in ("e4_sums", "e5_sums", "nv_sums"):
            a, b = getattr(k, f), getattr(t, f)
            assert a is None or torch.allclose(a, b, rtol=1e-5, atol=0.0,
                                               equal_nan=True), f


def test_select_wrapper_takes_bf16_and_f32_only():
    """The select variant has a bf16 and an f32 instance; the pack
    variant stays bf16 (moments are packed from their bf16 view). A CPU
    tensor never reaches a launch."""
    assert set(SELECT_DTYPES) == {torch.bfloat16, torch.float32}
    mg = torch.ones(4)
    for dt in (torch.float16, torch.float64):
        with pytest.raises(TypeError, match="must be one of"):
            mor_select_select(torch.zeros(128, 128, dtype=dt), mg,
                              block=(128, 128))
    with pytest.raises(ValueError, match="CUDA"):
        mor_select_select(torch.zeros(128, 128), mg, block=(128, 128))
    assert set(mor_select_select.launches_by_dtype) == {"bfloat16",
                                                        "float32"}


@pytest.mark.parametrize("mode", MODES)
def test_f32_operands_take_the_generic_route(mode):
    """An f32 operand selects on the generic kernel's f32 instance at
    every block; bf16 keeps the tile route at 128 x 128."""
    for block in ((128, 128), (64, 64), (2, 4096)):
        assert mor_select_route(block, mode, torch.float32) == "generic"
    assert mor_select_route((128, 128), mode) == "tile"
    assert mor_select_route((128, 128), mode, torch.bfloat16) == "tile"


@pytest.mark.parametrize("finite", (True, False))
@pytest.mark.parametrize("mode", MODES)
def test_plain_select_over_row_stripes_matches_the_whole(mode, finite):
    """The plain version on stripes of whole block rows at the whole
    operand's group amax (``mor_select_ref(group_amax=)``, how the card
    check of the training state holds the kernel on its largest views)
    gives the whole operand's y, sel, counts and error sums bit for
    bit."""
    from repro_torch.kernels.ref import mor_select_ref
    x = f32_operand((384, 512), (128, 128), seed=4)
    if finite:  # the group amax is then a value the stripes do not all hold
        x = torch.nan_to_num(x, nan=0.0, posinf=0.0)
    align = (2, 16) if mode == "sub4" else (1, 1)
    whole = mor_select_ref(x, Partition("block", (128, 128), align=align),
                           mode)
    exact = Partition("block", (128, 128), align=(128, 128))
    for r0 in range(0, 384, 128):
        t = mor_select_ref(x[r0:r0 + 128], exact, mode,
                           group_amax=whole.group_amax)
        i = r0 // 128
        assert torch.equal(_bits(t.y), _bits(whole.y[r0:r0 + 128]))
        for f in ("sel", "counts", "e4_sums", "e5_sums", "nv_sums"):
            a, b = getattr(t, f), getattr(whole, f)
            assert (a is None) == (b is None), f
            assert a is None or torch.equal(_bits(a), _bits(b[i:i + 1])), f
