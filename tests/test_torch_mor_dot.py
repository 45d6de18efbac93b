"""The port's ``mor_dot`` (a ``torch.autograd.Function``) against the JAX
reference's ``custom_vjp``, forward and backward, with the same x, w and
dy handed to both: recipes off / tensor / e4m3 / sub2 / sub3 / sub4, the
fake-quant and fused lowerings on 'block' partitions, and the fake-quant
lowering on 'channel' and 'tensor' partitions. Also
``MixedOperand.transpose()`` (the fused wgrad's pack reuse) against the
reference, NVFP4 refusal included. The JAX side runs ``backend='xla'``,
compiled whole with XLA's excess precision off (``jit_ref``).

Tolerances:
* stats rows (forward stats and the token's gradient, i.e. the four
  backward events): amax, mantissa, event kind and the guard lanes bit
  for bit. The decision and fraction lanes are block counts over a
  constant block count, and sums of those; compiled, XLA multiplies by
  the reciprocal and reorders the sums, which moves them by an f32 ulp
  or two: atol 1e-6, far below one block's share (1 / nblocks >= 1/96
  here), so every decision must still agree -- both sides quantize the
  same operands (dy is given). The global relative error lane is a
  ratio of f32 sums over blocks: rtol 1e-5;
* y, dx and dw: each is one GEMM with bf16 operands and f32
  accumulation, rounded once to bf16; XLA and PyTorch add the K
  products in different orders, so each element may differ by
  1e-5 * sum_k |a||b| (the f32 reordering bound, computed on the
  unquantized operands with a factor 2 for the quantization's change
  of magnitude) plus one bf16 ulp of the result (2^-7 |c|).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import linear as jlin
from repro.core import mor as jmor
from repro.core.partition import Partition as JPartition
from repro.core.policy import MoRDotPolicy as JDotPolicy
from repro.core.policy import MoRPolicy as JPolicy
from repro.kernels import ops as jops
from repro_torch.core import linear as tlin
from repro_torch.core import mor as tmor
from repro_torch.core.partition import Partition as TPartition
from repro_torch.core.policy import MoRDotPolicy, MoRPolicy
from repro_torch.kernels import ops as tops

RECIPES = ("off", "tensor", "e4m3", "sub2", "sub3", "sub4")
BLOCK = (64, 64)


def jit_ref(fn):
    """``fn`` compiled by XLA with its excess precision off."""
    return jax.jit(fn, compiler_options={"xla_allow_excess_precision": False})


def to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(a.copy())


def bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        a = a.detach().numpy()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16)
    if a.dtype == np.float32:
        return a.view(np.uint32)
    return a


def operands(seed=0):
    """x (2, 48, 96), w (96, 80), dy (2, 48, 80) in bf16. x and w are
    normal (the tensor recipe accepts them); dy spans +-20 binades with
    a quiet stripe, so the tensor recipe rejects it and the sub-tensor
    recipes mix their tags."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 48, 96))
    w = rng.standard_normal((96, 80)) * 0.05
    dy = rng.standard_normal((2, 48, 80)) * np.exp2(
        rng.integers(-20, 4, (2, 48, 80)))
    dy[:, :8] = rng.standard_normal((2, 8, 80)) * 1e-3
    return tuple(jnp.asarray(a, jnp.bfloat16) for a in (x, w, dy))


def policies(recipe, partition, fused):
    kw = dict(recipe=recipe, partition=partition, block_shape=BLOCK)
    jp = JPolicy(backend="xla", **kw)
    tp = MoRPolicy(**kw)
    return (JDotPolicy(act=jp, weight=jp, grad=jp, fuse_gemm=fused),
            MoRDotPolicy(act=tp, weight=tp, grad=tp, fuse_gemm=fused))


def run_ref(x, w, dy, pol):
    def fn(x, w, dy):
        (y, st), vjp = jax.vjp(
            lambda a, b, t: jlin.mor_dot(a, b, t, pol), x, w,
            jlin.new_token())
        dx, dw, dtok = vjp((dy, jnp.zeros_like(st)))
        return y, st, dx, dw, dtok
    return jit_ref(fn)(x, w, dy)


def run_port(x, w, dy, pol):
    xt = to_torch(x).requires_grad_(True)
    wt = to_torch(w).requires_grad_(True)
    tok = tlin.new_token(device="cpu")
    y, st = tlin.mor_dot(xt, wt, tok, pol)
    dx, dw, dtok = torch.autograd.grad(y, (xt, wt, tok),
                                       grad_outputs=to_torch(dy))
    return y.detach(), st, dx, dw, dtok


def assert_gemm_close(c_j, c_t, a, b_t, what):
    """|c_t - c_j| <= 2e-5 * |a| @ |b_t|^T + 2^-7 |c_j| (see the module
    docstring)."""
    cj = np.asarray(c_j, np.float32)
    ct = c_t.to(torch.float32).numpy()
    a2 = np.abs(np.asarray(a, np.float64)).reshape(-1, a.shape[-1])
    b2 = np.abs(np.asarray(b_t, np.float64))
    bound = 2e-5 * (a2 @ b2.T).reshape(cj.shape) + 2.0**-7 * np.abs(cj)
    err = np.abs(ct.astype(np.float64) - cj)
    assert cj.shape == ct.shape, (what, cj.shape, ct.shape)
    assert np.all(err <= bound), (what, float(err.max()),
                                  float((err / bound).max()))


def assert_rows_equal(s_j, s_t, what):
    s_j, s_t = np.asarray(s_j), s_t.detach().numpy()
    assert s_j.shape == s_t.shape, (what, s_j.shape, s_t.shape)
    exact = (tmor.STAT_AMAX, tmor.STAT_GROUP_MANTISSA, tmor.STAT_EVENT_KIND,
             tmor.STAT_GUARD_FLAGS, tmor.STAT_FALLBACK_COUNT)
    fracs = [i for i in range(tmor.STATS_WIDTH)
             if i != tmor.STAT_REL_ERR and i not in exact]
    np.testing.assert_array_equal(bits(s_j[:, exact]), bits(s_t[:, exact]),
                                  err_msg=what)
    np.testing.assert_allclose(s_t[:, fracs], s_j[:, fracs], rtol=0,
                               atol=1e-6, err_msg=what + " fractions")
    np.testing.assert_allclose(s_t[:, tmor.STAT_REL_ERR],
                               s_j[:, tmor.STAT_REL_ERR], rtol=1e-5,
                               err_msg=what + " rel_err")


CASES = ([(r, "block", False) for r in RECIPES]
         + [(r, "block", True) for r in RECIPES if r != "off"]
         + [(r, p, False) for p in ("channel", "tensor")
            for r in ("tensor", "sub3")])


@pytest.mark.parametrize("recipe,partition,fused", CASES, ids=str)
def test_mor_dot_forward_and_backward(recipe, partition, fused):
    x, w, dy = operands()
    jpol, tpol = policies(recipe, partition, fused)
    y_j, st_j, dx_j, dw_j, dtok_j = run_ref(x, w, dy, jpol)
    y_t, st_t, dx_t, dw_t, dtok_t = run_port(x, w, dy, tpol)
    what = f"{recipe}/{partition}/{'fused' if fused else 'fake'}"
    assert y_t.dtype == dx_t.dtype == dw_t.dtype == torch.bfloat16
    assert_rows_equal(st_j, st_t, what + " fwd stats")
    assert_rows_equal(dtok_j, dtok_t, what + " bwd stats")
    assert_gemm_close(y_j, y_t, x, np.asarray(w, np.float32).T, what + " y")
    assert_gemm_close(dx_j, dx_t, dy, np.asarray(w, np.float32),
                      what + " dx")
    x2 = np.asarray(x, np.float32).reshape(-1, 96)
    dy2 = np.asarray(dy, np.float32).reshape(-1, 80)
    assert_gemm_close(dw_j, dw_t, x2.T, dy2.T, what + " dw")


def test_tensor_recipe_takes_both_branches():
    """The operands drive the tensor recipe's Eq. 2 gate both ways: x
    and w are accepted (E4M3), dy is rejected (BF16)."""
    x, w, dy = operands()
    _, tpol = policies("tensor", "block", False)
    _, st, _, _, dtok = run_port(x, w, dy, tpol)
    assert st[:, tmor.STAT_DECISION].tolist() == [1.0, 1.0]
    assert dtok[:, tmor.STAT_DECISION].tolist() == [0.0, 1.0, 1.0, 0.0]


def test_quantize_for_gemm_tensor_and_e4m3_match_reference():
    """The one-format recipes' real packs (decide, then pack under the
    decided tags) against the reference, lane for lane."""
    x, _, dy = operands()
    for recipe in ("tensor", "e4m3"):
        for a in (x.reshape(-1, 96), dy.reshape(-1, 80)):
            mo_j, st_j = jit_ref(lambda v: jmor.quantize_for_gemm(
                v, JPolicy(recipe=recipe, block_shape=BLOCK,
                           backend="xla")))(a)
            mo_t, st_t = tmor.quantize_for_gemm(
                to_torch(a), MoRPolicy(recipe=recipe, block_shape=BLOCK))
            for lane in ("payload_q", "payload_bf16", "tags", "scales"):
                np.testing.assert_array_equal(
                    bits(getattr(mo_j, lane)), bits(getattr(mo_t, lane)),
                    err_msg=f"{recipe} {lane}")
            assert_rows_equal(np.asarray(st_j)[None], st_t[None], recipe)


@pytest.mark.parametrize("mode", ("sub3", "sub4"))
def test_mixed_operand_transpose(mode):
    """transpose() permutes tags, scales and the fp8 / BF16 lanes with
    the blocks, as the reference does; a pack with NVFP4 lanes is
    refused by both."""
    x, _, _ = operands(seed=3)
    x2 = x.reshape(-1, 96)
    align = (2, 16) if mode == "sub4" else (1, 1)
    mo_j, _ = jit_ref(lambda v: jops.quantize_pack(
        v, JPartition("block", BLOCK, align=align), mode,
        backend="xla"))(x2)
    mo_t, _ = tops.quantize_pack(
        to_torch(x2), TPartition("block", BLOCK, align=align), mode)
    if mode == "sub4":
        with pytest.raises(AssertionError, match="NVFP4"):
            mo_j.transpose()
        with pytest.raises(ValueError, match="NVFP4"):
            mo_t.transpose()
        return
    tj, tt = mo_j.transpose(), mo_t.transpose()
    assert tuple(tj.block) == tuple(tt.block) == BLOCK[::-1]
    assert tuple(tj.shape) == tuple(tt.shape) == (96, 96)
    for lane in ("payload_q", "payload_bf16", "tags", "scales",
                 "payload_nib", "micro_scales"):
        a, b = getattr(tj, lane), getattr(tt, lane)
        np.testing.assert_array_equal(bits(a), bits(b), err_msg=lane)
        assert b.is_contiguous(), lane
    np.testing.assert_array_equal(bits(jit_ref(lambda m: m.dequant())(tj)),
                                  bits(tt.dequant()))


def test_fusable_checks_and_serving_token():
    """fuse_gemm refuses non-block partitions and mixed block shapes, as
    the reference does; a None token runs the forward with no stats
    channel (serving)."""
    x, w, _ = operands()
    xt, wt = to_torch(x), to_torch(w)
    p = MoRPolicy(recipe="sub3", partition="channel")
    with pytest.raises(ValueError, match="partition='block'"):
        tlin.mor_dot(xt, wt, None, MoRDotPolicy(p, p, p, fuse_gemm=True))
    a, b = MoRPolicy(recipe="sub3"), MoRPolicy(recipe="sub3",
                                               block_shape=(32, 32))
    with pytest.raises(ValueError, match="block_shape"):
        tlin.mor_dot(xt, wt, None, MoRDotPolicy(a, b, a, fuse_gemm=True))
    y, st = tlin.mor_dot(xt, wt, None, MoRDotPolicy(a, a, a))
    assert y.shape == (2, 48, 80) and st.shape == (2, tmor.STATS_WIDTH)


def test_new_token_defaults_to_cuda(monkeypatch):
    """new_token runs on the card unless the caller asks for the CPU, as
    every entry point of the port does; without CUDA the default raises
    resolve_device's error rather than building a CPU token."""
    import inspect
    assert inspect.signature(tlin.new_token).parameters[
        "device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        tlin.new_token()
    tok = tlin.new_token(device="cpu", requires_grad=False)
    assert tok.device.type == "cpu" and not tok.requires_grad
    assert tuple(tok.shape) == (tlin.N_BWD_EVENTS, tmor.STATS_WIDTH)
    assert not bool(tok.any())
