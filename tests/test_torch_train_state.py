"""The port's compressed training state against the JAX reference on the
CPU: the three dense configs it registers, packed Adam moments
(``optim.moments``), gradient compression with error feedback
(``optim.compress``), the select kernel's work on f32 operands
(``ops.mor_select``), AdamW with packed moments and the skip-step guard,
the guard's re-encode ladder (``robust.guard``), and one train step of
reduced nemotron3-8b with all three.

The JAX side runs ``backend='xla'``, compiled with XLA's excess
precision off (``jit_ref``), but the optimizer runs op by op, as the
decay-mask test of ``tests/test_torch_repairs.py`` does, for bit-exact
masters. Inputs come from numpy and are f32 values that are
not bf16-exact, kept clear of f32 denormals (XLA on the CPU flushes
them).

Tolerances, and why:
* payload lanes, tags, scales, fake-quant values, EF residuals, masters
  and the stats lanes: bit for bit (the same IEEE operations), but
* the stats rows' relative-error lane (STAT_REL_ERR) and the per-block
  error sums: rtol 1e-5 (ratios of f32 sums, summed in XLA's order and
  PyTorch's), and where the reference is compiled the lanes that are
  means (the tag fractions, the nonzero fraction, the payload B/param,
  so the logical B/param too): within 1e-6 (XLA reorders their sums);
* the train step: the loss within rtol 1e-5, block fractions within
  1e-6, mean relative errors and the grad norm within rtol 1e-5, lr and
  the guard counters exactly, as ``tests/test_torch_train.py`` states
  them; with the clip norm far above the gradients' norm (so the
  norm's summation order cannot reach the update), the EF residuals,
  the packed moments' lanes and the dense moments bit for bit on every
  leaf: against the reference's whole step where the leaf's gradient is
  bit for bit the reference's (the layers' GEMM weights and the
  embedding; asserted), and on the others (the norm scales and the
  head, whose f32 gradients sum in another order) against the
  reference's compression and update fed the port's own gradient, with
  the stats rows' relative-error lane there within rtol 1e-4 (the
  head's 32768-element error sums part by ~1.04e-5); the masters within
  1e-5 (compiled whole, XLA rounds the update's last bit otherwise on a
  few percent of the elements).
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core import mor as jmor
from repro.core.partition import Partition as JPartition
from repro.core.policy import MoRPolicy as JPolicy
from repro.core.policy import paper_default as jpaper_default
from repro.kernels import ops as jops
from repro.models import init_params as jinit_params
from repro.optim import adamw as jadamw
from repro.optim import compress as jcompress
from repro.optim import moments as jmoments
from repro.robust import guard as jguard
from repro.train import TrainConfig as JTrainConfig
from repro.train import make_train_step as jmake_train_step
from repro_torch.configs import get_config, list_archs, reduced
from repro_torch.convert import params_from_jax
from repro_torch.core import mor as tmor
from repro_torch.core.partition import Partition as TPartition
from repro_torch.core.policy import MoRPolicy, paper_default
from repro_torch.kernels import ops as tops
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import compress as tcompress
from repro_torch.optim import moments as tmoments
from repro_torch.robust import guard as tguard
from repro_torch.train import TrainConfig, make_train_step

MODES = ("sub2", "sub3", "sub4")
LANES = ("payload_q", "payload_bf16", "payload_nib", "micro_scales",
         "tags", "scales")
CONFIGS = ("nemotron3-8b", "minitron-4b", "deepseek-coder-33b")


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
        a = a.detach()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        a = a.numpy()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16)
    if a.dtype == np.float32:
        return a.view(np.uint32)
    return a


def jpol(recipe, **kw):
    return JPolicy(recipe=recipe, backend="xla", **kw)


def jmoment_policy(tpol: tmoments.MomentPolicy):
    return jmoments.MomentPolicy(
        m=jpol(tpol.m.recipe, threshold=tpol.m.threshold),
        v=jpol(tpol.v.recipe, threshold=tpol.v.threshold),
        min_leaf=tpol.min_leaf)


def f32_values(shape, seed, spread=8):
    """f32 values that are not bf16-exact: N(0, 1) times powers of two in
    [2^-spread, 2^spread), a zero stripe along the first axis."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * np.exp2(
        rng.integers(-spread, spread, shape))
    x = x.astype(np.float32)
    x.reshape(-1)[: max(x.size // 16, 1)] = 0.0
    return x


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", CONFIGS)
def test_config_matches_reference(name):
    """Field for field, and reduced() alike."""
    got, want = get_config(name), jget_config(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(reduced(got)) == dataclasses.asdict(
        jreduced(want))
    assert name in list_archs()


# ---------------------------------------------------------------------------
# Packed moments
# ---------------------------------------------------------------------------

MOMENT_POLICIES = {
    "fp8_m": (tmoments.FP8_MOMENTS, tmor.EVENT_MOMENT_M),
    "wide_range_v": (tmoments.MomentPolicy(v=tmoments.WIDE_RANGE_V),
                     tmor.EVENT_MOMENT_V),
    "sub4_v": (tmoments.SUB4_V_MOMENTS, tmor.EVENT_MOMENT_V),
}
LEAF_SHAPES = {"1d": (3000,), "2d": (160, 96), "3d": (2, 72, 48),
               "small": (16, 32)}


# Stats lanes that are means (over the block grid, or the nonzero
# fraction): compiled whole, XLA may reorder a sum or divide by a
# constant through its reciprocal (one ulp).
MEAN_LANES = (tmor.STAT_DECISION, tmor.STAT_FRAC_E4M3, tmor.STAT_FRAC_E5M2,
              tmor.STAT_FRAC_BF16, tmor.STAT_NONZERO_FRAC, tmor.STAT_FRAC_NVFP4,
              tmor.STAT_MICRO_SCALE_BPE, tmor.STAT_PAYLOAD_BPE)


def assert_stats_equal(s_j, s_t, what, compiled=False, rel_err_rtol=1e-5):
    """A stats row (or rows) bit for bit; the relative-error lane within
    ``rel_err_rtol``; with ``compiled`` the mean lanes within 1e-6."""
    s_j, s_t = np.asarray(s_j), s_t.numpy()
    assert s_j.shape == s_t.shape, what
    for lane in range(tmor.STATS_WIDTH):
        if lane == tmor.STAT_REL_ERR:
            np.testing.assert_allclose(s_t[..., lane], s_j[..., lane],
                                       rtol=rel_err_rtol, err_msg=what)
        elif compiled and lane in MEAN_LANES:
            np.testing.assert_allclose(s_t[..., lane], s_j[..., lane],
                                       rtol=0, atol=1e-6, err_msg=what)
        else:
            np.testing.assert_array_equal(
                bits(s_j[..., lane]), bits(s_t[..., lane]),
                err_msg=f"{what} lane {lane}")


def assert_packed_equal(pm_j, pm_t, what, compiled=False, rel_err_rtol=1e-5):
    """Every lane of the port's pack (stored compact) and the reference's
    after compact(), its stats row, shape, decode and B/param (the
    logical one, a mean lane plus the block overhead, within 1e-6 when
    the reference was ``compiled``)."""
    assert isinstance(pm_t, tmoments.PackedMoment), what
    mo_j = pm_j.mo.compact()
    for lane in LANES:
        a, b = getattr(mo_j, lane), getattr(pm_t.mo, lane)
        assert tuple(a.shape) == tuple(b.shape), (what, lane)
        np.testing.assert_array_equal(bits(a), bits(b),
                                      err_msg=f"{what} {lane}")
    assert tuple(pm_t.shape) == tuple(pm_j.shape)
    assert_stats_equal(pm_j.stats, pm_t.stats, what, compiled, rel_err_rtol)
    np.testing.assert_array_equal(bits(jit_ref(jmoments.decode_moment)(pm_j)),
                                  bits(tmoments.decode_moment(pm_t)),
                                  err_msg=f"{what} decode")
    lj = float(jmoments.logical_bytes_per_param(pm_j))
    lt = float(tmoments.logical_bytes_per_param(pm_t))
    assert lt == lj if not compiled else abs(lt - lj) <= 1e-6, (what, lt, lj)
    assert jmoments.physical_bytes_per_param(pm_j) == \
        tmoments.physical_bytes_per_param(pm_t)


@pytest.mark.parametrize("leaf", LEAF_SHAPES)
@pytest.mark.parametrize("policy", MOMENT_POLICIES)
def test_encode_decode_moment_matches_reference(policy, leaf):
    tpol, kind = MOMENT_POLICIES[policy]
    shape = LEAF_SHAPES[leaf]
    x = f32_values(shape, seed=len(policy) + len(leaf))
    if kind == tmor.EVENT_MOMENT_V:
        x = x * x  # a second moment: non-negative, wide range
    jm = jmoment_policy(tpol)
    pm_j = jit_ref(lambda a: jmoments.maybe_encode_moment(a, jm, kind))(
        jnp.asarray(x))
    pm_t = tmoments.maybe_encode_moment(torch.from_numpy(x), tpol, kind)
    if leaf == "small":  # below min_leaf: dense f32, unchanged
        assert not isinstance(pm_j, jmoments.PackedMoment)
        assert torch.equal(pm_t, torch.from_numpy(x))
        return
    assert_packed_equal(pm_j, pm_t, f"{policy} {leaf}", compiled=True)


def _nvfp4_exact(shape, seed=3):
    """E2M1 grid values times power-of-two micro scales shared by each
    16-element group (the reference suite's fully-NVFP4 leaf)."""
    rng = np.random.default_rng(seed)
    m, k = shape
    grid = np.array([0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0])
    micro = np.exp2(rng.integers(-6, 6, (m, k // 16)).astype(np.float64))
    x = grid[rng.integers(0, 7, (m, k))] * np.repeat(micro, 16, axis=1)
    return x.astype(np.float32)


@pytest.mark.parametrize("which", ("fp8", "nvfp4"))
def test_moment_budget(which):
    """The reference's budgets on its 1024 x 1024 leaves: <= 1.05
    B/param fully fp8, <= 0.65 for a fully-NVFP4 sub4 second moment,
    logical and physical, equal to the reference's."""
    if which == "fp8":
        x, recipe, kind, cap = np.ones((1024, 1024), np.float32), "sub3", \
            tmor.EVENT_MOMENT_M, 1.05
    else:
        x, recipe, kind, cap = _nvfp4_exact((1024, 1024)), "sub4", \
            tmor.EVENT_MOMENT_V, 0.65
    pm_j = jit_ref(lambda a: jmoments.encode_moment(a, jpol(recipe), kind))(
        jnp.asarray(x))
    pm_t = tmoments.encode_moment(torch.from_numpy(x),
                                  MoRPolicy(recipe=recipe), kind)
    assert_packed_equal(pm_j, pm_t, which, compiled=True)
    assert float(tmoments.logical_bytes_per_param(pm_t)) <= cap
    assert tmoments.physical_bytes_per_param(pm_t) <= cap
    # The port stores the pack compact: its own tensors hold the budget.
    held = sum(getattr(pm_t.mo, l).numel() * getattr(pm_t.mo, l)
               .element_size() for l in LANES) / x.size
    assert held == tmoments.physical_bytes_per_param(pm_t)


# ---------------------------------------------------------------------------
# Gradient compression
# ---------------------------------------------------------------------------


def grad_tree(seed):
    return {"w": f32_values((160, 96), seed), "b": f32_values((96,), seed + 1),
            "s": f32_values((2, 72, 48), seed + 2)}


@pytest.mark.parametrize("mode", jcompress.GRAD_COMPRESS_MODES)
def test_compress_grads_matches_reference(mode):
    """Values, EF residuals and stats rows, on f32 leaves."""
    g = grad_tree(11)
    ef = {k: v * np.float32(2**-7) for k, v in grad_tree(21).items()} \
        if mode.endswith("_ef") else None
    to_j = (lambda t: None if t is None else
            {k: jnp.asarray(v) for k, v in t.items()})
    to_t = (lambda t: None if t is None else
            {k: torch.from_numpy(v.copy()) for k, v in t.items()})
    gj, ej, sj = jit_ref(lambda a, b: jcompress.compress_grads(
        a, mode, b, policy=jpol("sub3")))(to_j(g), to_j(ef))
    gt, et, st = tcompress.compress_grads(to_t(g), mode, to_t(ef),
                                          policy=MoRPolicy(recipe="sub3"))
    for k in g:
        np.testing.assert_array_equal(bits(gj[k]), bits(gt[k]),
                                      err_msg=f"{mode} grad {k}")
        if ef is not None:
            np.testing.assert_array_equal(bits(ej[k]), bits(et[k]),
                                          err_msg=f"{mode} ef {k}")
        if mode.startswith("mor"):
            assert_stats_equal(sj[k], st[k], f"{mode} stats {k}",
                               compiled=True)
            assert float(st[k][tmor.STAT_EVENT_KIND]) == tmor.EVENT_GRAD
    if ef is None:
        assert et is None and ej is None
    if mode.startswith("fp8"):
        assert st is None and sj is None
    # The reference's errors.
    with pytest.raises(ValueError):
        tcompress.compress_grads(to_t(g), "gzip")
    with pytest.raises(ValueError):
        tcompress.compress_grads(to_t(g), "mor_ef", ef_state=None)
    # The single-pod compressed sum (the local pack / decode round trip;
    # its four-rank mesh is tests/test_torch_sharded.py's) bit for bit.
    pol = None if mode.startswith("fp8") else "sub3"
    want = jit_ref(jcompress.make_pod_compressed_psum(
        None, None if pol is None else jpol(pol)))(jnp.asarray(g["w"]))
    got = tcompress.make_pod_compressed_psum(
        None, None if pol is None else MoRPolicy(recipe=pol))(
            torch.from_numpy(g["w"].copy()))
    np.testing.assert_array_equal(bits(want), bits(got))


# ---------------------------------------------------------------------------
# The select kernel's work on f32 operands
# ---------------------------------------------------------------------------


def mixed_f32(shape, seed, poison=True):
    """f32 blocks that hit every tag (not bf16-exact): normal rows, huge-
    and moderate-range rows, E2M1-grid rows with a 1 + 2^-12 jitter that
    keeps them NVFP4 winners, an all-zero stripe; a NaN and an Inf."""
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
    if poison:
        x[3, 5] = np.nan
        x[m // 2, k - 3] = np.inf
    return x.astype(np.float32)


@pytest.mark.parametrize("mode", MODES)
def test_mor_select_f32_matches_reference(mode):
    """y (f32 stored values), sel and counts bit for bit, the error sums
    within rtol 1e-5."""
    x = mixed_f32((256, 384), seed=9)
    assert not np.array_equal(
        x, np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32))
    align = (2, 16) if mode == "sub4" else (1, 1)
    r_j = jit_ref(lambda a: jops.mor_select(
        a, JPartition("block", (64, 64), align=align), mode, "gam",
        backend="xla"))(jnp.asarray(x))
    r_t = tops.mor_select(torch.from_numpy(x),
                          TPartition("block", (64, 64), align=align), mode)
    assert r_t.y.dtype == torch.float32
    nan = np.isnan(np.asarray(r_j.y))
    np.testing.assert_array_equal(nan, torch.isnan(r_t.y).numpy())
    np.testing.assert_array_equal(bits(r_j.y)[~nan], bits(r_t.y)[~nan])
    np.testing.assert_array_equal(np.asarray(r_j.sel), r_t.sel.numpy())
    np.testing.assert_array_equal(np.asarray(r_j.counts), r_t.counts.numpy())
    for f in ("e4_sums", "e5_sums", "nv_sums"):
        a, b = getattr(r_j, f), getattr(r_t, f)
        if a is None:
            assert b is None
            continue
        a, b = np.asarray(a), b.numpy()
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        ok = ~np.isnan(a)
        np.testing.assert_allclose(b[ok], a[ok], rtol=1e-5, atol=0.0)
    want = {"sub2": {0, 2}, "sub3": {0, 1, 2}, "sub4": {0, 1, 2, 3}}[mode]
    assert set(np.unique(r_t.sel.numpy()).tolist()) == want


# ---------------------------------------------------------------------------
# AdamW with packed moments and the guard
# ---------------------------------------------------------------------------

OPT_SHAPES = {"w": (64, 48), "s": (48,)}


def _opt_inputs(seed, nan=False):
    rng = np.random.default_rng(seed)
    params = {k: rng.standard_normal(s).astype(np.float32) * 0.02
              for k, s in OPT_SHAPES.items()}
    grads = [{k: f32_values(s, seed + 1 + i * 7, spread=4) * np.float32(1e-3)
              for k, s in OPT_SHAPES.items()} for i in range(2)]
    if nan:
        grads[1]["w"][3, 4] = np.nan
    return params, grads


def _state_equal(js, ts, what):
    """Masters and dense moments bit for bit, packed moments as
    assert_packed_equal (the reference run op by op)."""
    for name in ("master", "m", "v"):
        jt, tt = getattr(js, name), getattr(ts, name)
        for k in OPT_SHAPES:
            a, b = jt[k], tt[k]
            if isinstance(a, jmoments.PackedMoment):
                assert_packed_equal(a, b, f"{what} {name} {k}")
            else:
                assert not isinstance(b, tmoments.PackedMoment)
                np.testing.assert_array_equal(bits(a), bits(b),
                                              err_msg=f"{what} {name} {k}")
    assert int(js.step) == int(ts.step)


def test_adamw_packed_moments_match_reference():
    """Two steps under SUB4_V_MOMENTS (m sub3, v sub4; FP8_MOMENTS in the
    train step below) with warm-up and a clip norm far above the grads'
    norm, the reference op by op: master weights, packed lanes, params
    and the moment metrics bit for bit."""
    tpol = tmoments.SUB4_V_MOMENTS
    jm = jmoment_policy(tpol)
    params, grads = _opt_inputs(4)
    kw = dict(warmup_steps=10, clip_norm=1e9)
    jcfg, tcfg = jadamw.AdamWConfig(**kw), tadamw.AdamWConfig(**kw)
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in params.items()}
    tp = {k: to_torch(v) for k, v in jp.items()}
    js = jadamw.init_opt_state(jp, moments=jm)
    ts = tadamw.init_opt_state(tp, moments=tpol)
    _state_equal(js, ts, "init")
    for i, g in enumerate(grads):
        jp, js, jmet = jadamw.adamw_update(
            jcfg, {k: jnp.asarray(v) for k, v in g.items()}, js, moments=jm,
            guard=jguard.GuardPolicy())
        tp, ts, tmet = tadamw.adamw_update(
            tcfg, {k: torch.from_numpy(v) for k, v in g.items()}, ts,
            moments=tpol, guard=tguard.GuardPolicy())
        _state_equal(js, ts, f"step {i}")
        for k in OPT_SHAPES:
            np.testing.assert_array_equal(bits(jp[k]), bits(tp[k]))
        for name in ("m", "v"):
            assert_stats_equal(jmet[f"moment_stats_{name}"],
                               tmet[f"moment_stats_{name}"], name)
            assert float(tmet[f"moment_bpe_{name}"]) == pytest.approx(
                float(jmet[f"moment_bpe_{name}"]), rel=1e-6)
        assert float(tmet["guard_skip"]) == float(jmet["guard_skip"]) == 0.0


def test_adamw_nonfinite_grads_skip_the_step():
    """A NaN gradient under the guard: master, both packed moments (every
    lane) and the step come back bit for bit as they were, the params
    are the old master re-cast, guard_skip is 1, as the reference's."""
    tpol = tmoments.FP8_MOMENTS
    jm = jmoment_policy(tpol)
    params, grads = _opt_inputs(5, nan=True)
    cfg = dict(warmup_steps=10, clip_norm=1e9)
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in params.items()}
    tp = {k: to_torch(v) for k, v in jp.items()}
    js = jadamw.init_opt_state(jp, moments=jm)
    ts = tadamw.init_opt_state(tp, moments=tpol)
    outs = []
    for g in grads:
        before = copy.deepcopy(ts)
        jp, js, jmet = jadamw.adamw_update(
            jadamw.AdamWConfig(**cfg), {k: jnp.asarray(v)
                                        for k, v in g.items()}, js,
            moments=jm, guard=jguard.GuardPolicy())
        tp, ts, tmet = tadamw.adamw_update(
            tadamw.AdamWConfig(**cfg), {k: torch.from_numpy(v)
                                        for k, v in g.items()}, ts,
            moments=tpol, guard=tguard.GuardPolicy())
        outs.append((before, float(tmet["guard_skip"])))
        assert float(tmet["guard_skip"]) == float(jmet["guard_skip"])
        _state_equal(js, ts, "after")
    (_, skip0), (before, skip1) = outs
    assert (skip0, skip1) == (0.0, 1.0)
    for name in ("master", "m", "v"):
        for k in OPT_SHAPES:
            a, b = getattr(before, name)[k], getattr(ts, name)[k]
            if isinstance(a, tmoments.PackedMoment):
                for lane in LANES:
                    assert torch.equal(getattr(a.mo, lane),
                                       getattr(b.mo, lane)), (name, k, lane)
                assert torch.equal(a.stats, b.stats)
            else:
                assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert int(ts.step) == int(before.step) == 1
    for k in OPT_SHAPES:
        assert torch.equal(tp[k], before.master[k].to(torch.bfloat16))


def test_adamw_failed_encode_leaves_every_leaf_whole(monkeypatch):
    """An encode that raises inside the walk (out of memory on the card,
    say): the error says the state is partly updated, and no leaf of the
    state is left without its moments. The leaf before holds its new
    packs, the failing leaf its old packs (every lane) beside its
    updated master, and the step counter has not moved."""
    tpol = tmoments.FP8_MOMENTS
    rng = np.random.default_rng(7)
    params = {k: torch.from_numpy(rng.standard_normal((64, 48)).astype(
        np.float32) * 0.02).to(torch.bfloat16) for k in ("a", "b")}
    grads = {k: torch.from_numpy(f32_values((64, 48), 8 + i, spread=4)
                                 * np.float32(1e-3))
             for i, k in enumerate(("a", "b"))}
    ts = tadamw.init_opt_state(params, moments=tpol)
    before = copy.deepcopy(ts)
    encode, calls = tmoments.maybe_encode_moment, []

    def failing(x, moments, kind):
        calls.append(kind)
        if len(calls) == 4:  # leaf b's v, after its m was encoded
            raise torch.cuda.OutOfMemoryError("out of memory")
        return encode(x, moments, kind)

    monkeypatch.setattr(tmoments, "maybe_encode_moment", failing)
    with pytest.raises(RuntimeError, match="partly updated") as err:
        tadamw.adamw_update(tadamw.AdamWConfig(warmup_steps=1), grads, ts,
                            moments=tpol, guard=tguard.GuardPolicy())
    assert isinstance(err.value.__cause__, torch.cuda.OutOfMemoryError)
    assert "'b'" in str(err.value)
    assert int(ts.step) == int(before.step) == 0

    def same(x, y):
        return all(torch.equal(getattr(x.mo, lane), getattr(y.mo, lane))
                   for lane in LANES) and torch.equal(x.stats, y.stats)

    for name in ("m", "v"):
        now, old = getattr(ts, name), getattr(before, name)
        assert all(isinstance(now[k], tmoments.PackedMoment) for k in now)
        assert not same(now["a"], old["a"]), name
        assert same(now["b"], old["b"]), name
    for k in ("a", "b"):  # both masters took the step
        assert not torch.equal(ts.master[k], before.master[k]), k


def test_tree_select_keeps_the_old_state():
    """tree_select(False, new, old) returns the old leaves bit for bit,
    packed lanes included; (True, ...) the new ones."""
    pm = tmoments.encode_moment(torch.from_numpy(f32_values((64, 48), 3)),
                                MoRPolicy(recipe="sub3"),
                                tmor.EVENT_MOMENT_M)
    pm2 = tmoments.encode_moment(torch.from_numpy(f32_values((64, 48), 4)),
                                 MoRPolicy(recipe="sub3"),
                                 tmor.EVENT_MOMENT_M)
    old = {"a": torch.arange(6, dtype=torch.float32), "p": pm}
    new = {"a": torch.full((6,), float("nan")), "p": pm2}
    got = tguard.tree_select(torch.tensor(False), new, old)
    assert torch.equal(got["a"], old["a"]) and got["p"] is pm
    got = tguard.tree_select(torch.tensor(True), new, old)
    assert got["p"] is pm2 and torch.isnan(got["a"]).all()


REQUANT_CASES = {"covered": 1.0, "two_doublings": 0.3, "uncovered": 0.1,
                 "nan_stale": float("nan"), "zero_stale": 0.0}


@pytest.mark.parametrize("case", list(REQUANT_CASES) + ["poisoned_data"])
def test_requantize_with_backoff_matches_reference(case):
    """y, the stats row and the attempts, bit for bit; the docstring's
    linspace cases give 0 and 2 doublings."""
    x = np.linspace(-1.0, 1.0, 64, dtype=np.float32).reshape(8, 8)
    stale = REQUANT_CASES.get(case, 1.0)
    if case == "poisoned_data":
        x[2, 3] = np.inf
    yj, sj, aj = jguard.requantize_with_backoff(jnp.asarray(x),
                                                jnp.float32(stale))
    yt, st, at = tguard.requantize_with_backoff(torch.from_numpy(x), stale)
    np.testing.assert_array_equal(bits(yj), bits(yt))
    np.testing.assert_array_equal(bits(sj), bits(st))
    assert int(aj) == int(at)
    if case in ("covered", "two_doublings"):
        assert int(at) == {"covered": 0, "two_doublings": 2}[case]
    flags = st[tmor.STAT_GUARD_FLAGS]
    assert bool(tguard.guard_flag_set(flags, tmor.GUARD_STALE_SCALE)) == \
        (case not in ("covered", "two_doublings"))
    assert bool(tguard.guard_flag_set(flags, tmor.GUARD_NONFINITE_AMAX)) == \
        (case in ("nan_stale", "poisoned_data"))


# ---------------------------------------------------------------------------
# One train step of reduced nemotron3-8b with the compressed state
# ---------------------------------------------------------------------------


def _leaf(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


def jax_state(topt, like):
    """The reference's OptState holding the port's initial state, laid
    out as ``like`` (the reference's init, from jax.eval_shape), so both
    steps start from the same state without a compile of the reference's
    init (init itself is held against the reference in the AdamW tests
    above). A lane the port stores compact and the reference in full is
    all zeros in a zero moment's pack: it becomes the full zeros."""
    def arr(t):  # a copy: the port's step updates its state in place
        return jnp.asarray((bits(t).view(jnp.bfloat16)
                            if t.dtype == torch.bfloat16 else t.numpy())
                           .copy())

    def lane(t, want):
        if tuple(t.shape) == tuple(want.shape):
            return arr(t)
        assert not bool(t.any()), "a compact lane of a zero moment"
        return jnp.zeros(want.shape, want.dtype)

    def leaf(x, want):
        if isinstance(x, dict):
            return {k: leaf(x[k], want[k]) for k in x}
        if not isinstance(x, tmoments.PackedMoment):
            return arr(x)
        mo, wmo = x.mo, want.mo
        return jmoments.PackedMoment(
            mo=type(wmo)(**{
                f: lane(getattr(mo, f), getattr(wmo, f)) for f in LANES},
                block=wmo.block, shape=wmo.shape, has_nvfp4=wmo.has_nvfp4),
            stats=arr(x.stats), shape=tuple(x.shape))

    return like._replace(**{k: leaf(getattr(topt, k), getattr(like, k))
                            for k in ("master", "m", "v", "ef")},
                         step=arr(topt.step))


def test_train_step_compressed_state_matches_reference(monkeypatch):
    """FP8_MOMENTS, 'mor_ef' and GuardPolicy() on reduced nemotron3-8b
    (relu2, MHA), sub3 GEMMs, one step from the JAX draw with a nonzero
    EF state. Both sides without the layer remat (it changes memory, not
    values: tests/test_torch_train.py runs it), which halves the
    reference's compile.

    Two comparisons. The whole step against the reference's: metrics at
    the module's tolerances, every master within 1e-5; the gradients of
    the GEMM weights and the embedding equal the reference's, so their
    EF residuals are bit for bit (asserted), and on those leaves the
    moments (every packed lane) are too. Then the other leaves (the head
    and the norm scales, whose f32 gradients sum in another order): the
    port's own raw gradients (captured where the step hands them to
    compress_grads) through the reference's compress_grads and
    adamw_update, compiled, from the same state: EF residuals and
    moments bit for bit (the relative-error lane within rtol 1e-4),
    masters within 1e-5. Both steps start from the port's initial
    state (jax_state)."""
    from repro_torch.train import train_step as ttrain_step
    jcfg, cfg = jreduced(jget_config("nemotron3-8b")), \
        reduced(get_config("nemotron3-8b"))
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    rng = np.random.default_rng(12)
    batch = {k: rng.integers(0, cfg.vocab, (2, 32)) for k in
             ("tokens", "labels")}
    ef = jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 1e-4)
                      .astype(np.float32), jparams)
    jm = jmoment_policy(tmoments.FP8_MOMENTS)
    jopt_cfg = jadamw.AdamWConfig(warmup_steps=1, clip_norm=1e9)
    jpol_ = jpaper_default("sub3")
    jpol_ = jpol_.replace(act=jpol_.act.replace(backend="xla"),
                          weight=jpol_.weight.replace(backend="xla"),
                          grad=jpol_.grad.replace(backend="xla"))
    jstep = jit_ref(jmake_train_step(jcfg, jpol_, JTrainConfig(
        optimizer=jopt_cfg, moments=jm, compress_grads="mor_ef",
        grad_policy=jpol("sub3"), guard=jguard.GuardPolicy(), remat=False)))
    topt = tadamw.init_opt_state(tparams, moments=tmoments.FP8_MOMENTS,
                                 ef=True)
    topt = topt._replace(ef=params_from_jax(ef, device="cpu"))
    jopt0 = jax_state(topt, jax.eval_shape(
        lambda p: jadamw.init_opt_state(p, moments=jm, ef=True), jparams))
    _, jopt, jmet = jstep(jparams, jopt0,
                          {k: jnp.asarray(v) for k, v in batch.items()})

    raw = []  # the port's raw gradients, in tree_leaves order

    def spy(grads, mode, ef_state, policy):
        raw.extend(g.clone() for g in grads.values())
        return tcompress.compress_grads(grads, mode, ef_state, policy)

    monkeypatch.setattr(ttrain_step, "compress_grads", spy)
    tstep = make_train_step(cfg, paper_default("sub3"), TrainConfig(
        optimizer=tadamw.AdamWConfig(warmup_steps=1, clip_norm=1e9),
        moments=tmoments.FP8_MOMENTS, compress_grads="mor_ef",
        guard=tguard.GuardPolicy(), remat=False))
    _, topt, tmet = tstep(tparams, topt, {k: torch.from_numpy(v) for k, v
                                          in batch.items()})

    jmet = {k: float(v) for k, v in jmet.items()}
    tmet = {k: float(v) for k, v in tmet.items()}
    assert set(tmet) == set(jmet)
    assert tmet["loss"] == pytest.approx(jmet["loss"], rel=1e-5)
    for k in ("fwd_frac_bf16", "bwd_frac_bf16", "opt_frac_bf16",
              "opt_payload_bpe", "moment_bpe_m", "moment_bpe_v"):
        assert tmet[k] == pytest.approx(jmet[k], abs=1e-6), k
    for k in ("fwd_rel_err", "bwd_rel_err", "opt_rel_err", "grad_norm",
              "ef_norm"):
        assert tmet[k] == pytest.approx(jmet[k], rel=1e-5), k
    for k in ("guard_flag_events", "guard_fallback_blocks", "lr",
              "guard_skip"):
        assert tmet[k] == jmet[k], k

    def moments_equal(ref, path, what, rel_err_rtol=1e-5):
        """The reference's new moments of a leaf (``ref``: name -> leaf)
        against the port's."""
        for name in ("m", "v"):
            a, b = ref[name], _leaf(getattr(topt, name), path)
            if isinstance(a, jmoments.PackedMoment):
                assert_packed_equal(a, b, f"{name} {what}",
                                    rel_err_rtol=rel_err_rtol)
            else:  # below min_leaf: dense f32
                np.testing.assert_array_equal(bits(a), bits(b),
                                              err_msg=f"{name} {what}")

    def master_close(ref, path, what):
        assert np.abs(np.asarray(ref) - _leaf(topt.master, path).numpy()
                      ).max() <= 1e-5, what

    flat, _ = jax.tree_util.tree_flatten_with_path(jopt.master)
    assert len(raw) == len(flat)
    exact, fed = [], {}
    for (path, _), g in zip(flat, raw):
        what = "/".join(k.key for k in path)
        master_close(_leaf(jopt.master, path), path, what)
        if np.array_equal(bits(_leaf(jopt.ef, path)),
                          bits(_leaf(topt.ef, path))):
            exact.append(what)
            moments_equal({n: _leaf(getattr(jopt, n), path)
                           for n in ("m", "v")}, path, what)
        else:
            fed[what] = (path, g)
    for must in ("blocks/dense/wqkv", "blocks/dense/wo",
                 "blocks/dense/mlp/wi", "blocks/dense/mlp/wo", "embed"):
        assert must in exact, (must, exact)

    # The other leaves' raw gradients from the port through the
    # reference's compression and update (their clip scale is 1 either
    # way, so the leaves need no company).
    def update(g, opt):
        gq, new_ef, _ = jcompress.compress_grads(g, "mor_ef", opt.ef,
                                                 policy=jpol("sub3"))
        _, new, _ = jadamw.adamw_update(jopt_cfg, gq, opt, moments=jm,
                                        guard=jguard.GuardPolicy())
        return new._replace(ef=new_ef)

    def pick(tree):
        return {w: _leaf(tree, p) for w, (p, _) in fed.items()}

    jfed = jit_ref(update)(
        {w: jnp.asarray(bits(g).view(jnp.bfloat16)
                        if g.dtype == torch.bfloat16 else g.numpy())
         for w, (_, g) in fed.items()},
        jopt0._replace(master=pick(jopt0.master), m=pick(jopt0.m),
                       v=pick(jopt0.v), ef=pick(jopt0.ef)))
    for what, (path, _) in fed.items():
        np.testing.assert_array_equal(bits(jfed.ef[what]),
                                      bits(_leaf(topt.ef, path)),
                                      err_msg=f"ef {what}")
        # The relative-error lane at rtol 1e-4: on the head's 32768
        # elements the reference's and the port's f32 sums of the
        # per-element errors part by ~1.04e-5 of the sum.
        moments_equal({"m": jfed.m[what], "v": jfed.v[what]}, path,
                      f"{what} (port's gradient)", rel_err_rtol=1e-4)
        master_close(jfed.master[what], path, what)
    assert "lm_head" in fed, sorted(fed)
    assert int(topt.step) == int(jopt.step) == int(jfed.step) == 1
