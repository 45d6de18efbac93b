"""The port's configs (``repro_torch.configs``: the three new architectures
and the rest of ``configs.base``) and its MoE sublayer
(``models.blocks.moe_sublayer``) against the JAX reference on the CPU.

``moe_sublayer`` runs on reduced granite-moe-1b-a400m (d 64, 4 experts,
top-2, d_ff 96) with the same numpy weights and inputs on both sides;
the reference is compiled with XLA's excess precision off (``jit_ref``)
and its routing read through ``jax.debug.callback`` on the dispatch and
combine einsums' operands. Tolerances, and why:

* routing ids, slots and ``keep``: exact. The router product and the
  softmax sum in different orders and XLA's exp differs from torch's in
  the last bit (a few ulps of the probabilities), so every test asserts
  that each token's first K + 1 probabilities are more than GAP
  relative apart (a near-tie could otherwise flip an expert);
* gates (in [0, 1]): within 1e-6 absolute. The router's f32 product
  sums in another order than XLA's dot, which moves the logits by a few
  ulps, and the renormalisation over K carries that into the gates
  (~1.3e-7 seen);
* ``dropped``: bit for bit (``jnp.mean`` is the sum times the f32
  reciprocal of the count, and XLA fuses ``1 - mean`` into one
  multiply-add: ``blocks._dropped``);
* ``aux_loss``: within rtol 1e-6. Its mean router probability sums
  B * t f32 values, which XLA adds in a vectorised order that neither
  a left-to-right fold nor ``torch.sum`` reproduces: on the reference's
  own probabilities either order is up to 2 ulps off;
* the w1 / w2 stats rows: amax, mantissa, event kind and guard lanes bit
  for bit; the other fraction lanes within 1e-6 and the relative error
  within rtol 1e-5 (``tests/test_torch_mor_dot.py``'s rule: XLA reorders
  the block sums);
* the output y: every expert GEMM sums its bf16 products in another
  order than XLA, so an expert's bf16 output may flip by one ulp, and y
  (the f32 sum of K gated copies, rounded to bf16) by one more; each
  element within 2^-6 |y| + 2^-10 max|y|, and at least 99% bit for bit.

``core.linear.mor_dot_experts`` (the sublayer's expert stack) is held
bit for bit against ``mor_dot`` on each expert's slice, forward and
backward, under every lowering.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.configs import base as jbase
from repro.core.policy import MoRDotPolicy as JDotPolicy
from repro.core.policy import MoRPolicy as JPolicy
from repro.core.policy import paper_default as jpaper_default
from repro.models import blocks as jB
from repro_torch import configs as tconfigs
from repro_torch.configs import base as tbase
from repro_torch.convert import params_from_jax
from repro_torch.core import mor as tmor
from repro_torch.core.policy import (BF16_BASELINE, paper_default)
from repro_torch.models import blocks as tB

NOEX = {"xla_allow_excess_precision": False}
GAP = 1e-5
ARCH = "granite-moe-1b-a400m"
NEW = ("gemma-2b", "granite-moe-1b-a400m", "moonshot-v1-16b-a3b")


def jit_ref(fn):
    return jax.jit(fn, compiler_options=NOEX)


# ----------------------------------------------------------------- configs --
@pytest.mark.parametrize("name", NEW)
def test_new_configs_field_for_field(name):
    j, t = jconfigs.get_config(name), tconfigs.get_config(name)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.n_units == j.n_units and t.mamba_d_inner == j.mamba_d_inner


def test_config_arithmetic_and_shapes_match():
    assert tconfigs.list_archs() == sorted(jconfigs.list_archs())
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    for name in tconfigs.list_archs():
        j, t = jconfigs.get_config(name), tconfigs.get_config(name)
        for jc, tc in ((j, t), (jconfigs.reduced(j), tconfigs.reduced(t))):
            assert dataclasses.asdict(tc) == dataclasses.asdict(jc), name
            assert tc.param_count() == jc.param_count(), name
            assert tc.active_param_count() == jc.active_param_count(), name
        for s in jconfigs.SHAPES:
            assert tconfigs.cell_is_runnable(t, tconfigs.SHAPES[s]) == \
                jconfigs.cell_is_runnable(j, jconfigs.SHAPES[s]), (name, s)


def _port_cfg(jcfg):
    """The reference's config as the port's dataclass (every family)."""
    return tbase.ArchConfig(**dataclasses.asdict(jcfg))


@pytest.mark.parametrize("family_arch", ("llama3-8b", "granite-moe-1b-a400m",
                                         "whisper-tiny", "paligemma-3b",
                                         "hymba-1.5b", "xlstm-350m"))
def test_input_specs_match(family_arch):
    """Every shape kind, frontends included; the arithmetic of families
    not ported yet (param_count, active_param_count) too."""
    jcfg = jconfigs.get_config(family_arch)
    tcfg = _port_cfg(jcfg)
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()
    assert tcfg.mamba_d_inner == jcfg.mamba_d_inner
    dt = {jnp.int32: torch.int32, jnp.bfloat16: torch.bfloat16}
    for name, shape in jconfigs.SHAPES.items():
        js = jconfigs.input_specs(jcfg, shape)
        ts = tconfigs.input_specs(tcfg, tconfigs.SHAPES[name])
        assert list(ts) == list(js), (family_arch, name)
        for k, spec in js.items():
            assert ts[k] == (tuple(spec.shape), dt[spec.dtype.type]), \
                (family_arch, name, k)
    with pytest.raises(ValueError):
        tconfigs.input_specs(tcfg, tconfigs.ShapeConfig("x", 8, 1, "eval"))


# ------------------------------------------------------------ moe_sublayer --
def jax_policy(name):
    if name == "off":
        p = JPolicy(recipe="off", backend="xla")
        return JDotPolicy(act=p, weight=p, grad=p)
    pol = jpaper_default("tensor" if name == "tensor" else "sub3")
    pol = pol.replace(act=pol.act.replace(backend="xla"),
                      weight=pol.weight.replace(backend="xla"),
                      grad=pol.grad.replace(backend="xla"))
    return pol.replace(fuse_gemm=(name == "fused"))


def port_policy(name):
    if name == "off":
        return BF16_BASELINE
    pol = paper_default("tensor" if name == "tensor" else "sub3")
    return pol.replace(fuse_gemm=(name == "fused"))


@pytest.fixture(scope="module")
def moe():
    jcfg = jconfigs.reduced(jconfigs.get_config(ARCH))
    cfg = tconfigs.reduced(tconfigs.get_config(ARCH))
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    rng = np.random.default_rng(0)
    p = {"router": (rng.standard_normal((d, E)) * 0.3).astype(np.float32),
         "w1": (rng.standard_normal((E, d, 2 * f)) * 0.1).astype(
             jnp.bfloat16),
         "w2": (rng.standard_normal((E, f, d)) * 0.1).astype(jnp.bfloat16)}
    return jcfg, cfg, p


def bits(a):
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        a = a.detach().numpy()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16)
    return a.view(f"u{a.dtype.itemsize}")


def reference_run(jcfg, p, x, pol):
    """The reference's (y, stats) and its routing, chunk by chunk: [(ids,
    slot one-hot, keep, gates)] read from the dispatch and combine
    einsums' operands."""
    seen = {"dispatch": [], "combine": []}
    einsum = jnp.einsum

    def spy(spec, *ops, **kw):
        if spec == "bse,bsc,bsd->ebcd":
            jax.debug.callback(lambda oh, so: seen["dispatch"].append(
                (np.asarray(oh), np.asarray(so))), ops[0], ops[1],
                ordered=True)
        elif spec == "bse,bsc,bs,ebcd->bsd":
            jax.debug.callback(lambda g: seen["combine"].append(
                np.asarray(g)), ops[2], ordered=True)
        return einsum(spec, *ops, **kw)

    E = jcfg.n_experts
    tok = {"w1": jnp.zeros((E, 4, tmor.STATS_WIDTH)),
           "w2": jnp.zeros((E, 4, tmor.STATS_WIDTH))}
    jnp.einsum = spy
    try:
        y, st = jit_ref(lambda p, x, t: jB.moe_sublayer(
            p, x, t, pol, jcfg))(p, x, tok)
        jax.effects_barrier()
    finally:
        jnp.einsum = einsum
    routes = [(oh.argmax(-1), so, so.sum(-1), g) for (oh, so), g in
              zip(seen["dispatch"], seen["combine"])]
    return np.asarray(y, np.float32), jax.tree.map(np.asarray, st), routes


def port_run(cfg, p, x, pol):
    seen = {"route": [], "slots": []}
    route, slots = tB._route, tB._slots

    def spy_route(*a):
        out = route(*a)
        seen["route"].append([t.detach() for t in out])
        return out

    def spy_slots(ids, E, C):
        out = slots(ids, E, C)
        seen["slots"].append((ids, out))
        return out

    tB._route, tB._slots = spy_route, spy_slots
    try:
        y, st = tB.moe_sublayer(params_from_jax(p, "cpu"),
                                params_from_jax({"x": x}, "cpu")["x"], None,
                                pol, cfg)
    finally:
        tB._route, tB._slots = route, slots
    routes = [(ids.numpy(), so.numpy(), keep.numpy(),
               r[1].reshape(ids.shape).numpy(), r[0].numpy())
              for (ids, (_, so, keep)), r in zip(seen["slots"],
                                                 seen["route"])]
    return y, st, routes


def assert_rows_equal(s_j, s_t, what):
    s_t = s_t.detach().numpy()
    assert s_j.shape == s_t.shape, what
    s_j, s_t = s_j.reshape(-1, s_j.shape[-1]), s_t.reshape(-1, s_t.shape[-1])
    exact = (tmor.STAT_AMAX, tmor.STAT_GROUP_MANTISSA, tmor.STAT_EVENT_KIND,
             tmor.STAT_GUARD_FLAGS, tmor.STAT_FALLBACK_COUNT)
    fracs = [i for i in range(tmor.STATS_WIDTH)
             if i != tmor.STAT_REL_ERR and i not in exact]
    np.testing.assert_array_equal(bits(s_j[:, exact]), bits(s_t[:, exact]),
                                  err_msg=what)
    np.testing.assert_allclose(s_t[:, fracs], s_j[:, fracs], rtol=0,
                               atol=1e-6, err_msg=what)
    np.testing.assert_allclose(s_t[:, tmor.STAT_REL_ERR],
                               s_j[:, tmor.STAT_REL_ERR], rtol=1e-5,
                               err_msg=what)


def check_against_reference(jcfg, cfg, p, x, name):
    yj, sj, rj = reference_run(jcfg, p, x, jax_policy(name))
    yt, st, rt = port_run(cfg, p, x, port_policy(name))
    K = cfg.top_k
    assert len(rj) == len(rt) == x.shape[1] // tB.pick_chunk(x.shape[1],
                                                             256)
    for (ids_j, so_j, keep_j, g_j), (ids_t, so_t, keep_t, g_t, probs) in \
            zip(rj, rt):
        finite = np.isfinite(probs).all(-1)
        top = -np.sort(-probs[finite], axis=-1)[:, :K + 1]
        assert (np.diff(-top, axis=-1) > GAP * top[:, :-1]).all(), \
            "near-tied routing"
        rows = np.repeat(finite, K, axis=1)
        np.testing.assert_array_equal(ids_t[rows], ids_j[rows])
        np.testing.assert_array_equal(so_t, so_j)
        np.testing.assert_array_equal(keep_t, keep_j)
        np.testing.assert_allclose(g_t[rows], g_j[rows], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(bits(st["dropped"]), bits(sj["dropped"]))
    np.testing.assert_allclose(float(st["aux_loss"]), sj["aux_loss"],
                               rtol=1e-6)
    for k in ("w1", "w2"):
        assert_rows_equal(sj[k], st[k], f"{name} {k}")
    y = yt.float().numpy()
    assert y.shape == yj.shape and yt.dtype == torch.bfloat16
    nan = np.isnan(yj)
    np.testing.assert_array_equal(np.isnan(y), nan)
    yj, y = yj[~nan], y[~nan]
    if yj.size:
        tol = 2.0**-6 * np.abs(yj) + 2.0**-10 * np.abs(yj).max()
        assert (np.abs(y - yj) <= tol).all(), float(np.abs(y - yj).max())
        assert (y == yj).mean() >= 0.99
    return sj, st


@pytest.mark.parametrize("name", ("off", "tensor", "sub3", "fused"))
def test_moe_sublayer_matches_reference(moe, name):
    """2 x 64 tokens: one 64-token chunk, C = int(2 * 64 / 4 * 1.25)."""
    jcfg, cfg, p = moe
    x = np.random.default_rng(1).standard_normal(
        (2, 64, cfg.d_model)).astype(jnp.bfloat16)
    check_against_reference(jcfg, cfg, p, x, name)


@pytest.mark.parametrize("name", ("tensor", "fused"))
def test_moe_sublayer_chunked_and_decode_shapes(moe, name):
    """S = 600 (not a multiple of 256): pick_chunk picks 200, so three
    chunks and the stats averaged over them; the decode shape (4 slots,
    S = 1, C = 1)."""
    jcfg, cfg, p = moe
    rng = np.random.default_rng(2)
    for shape in ((1, 600, cfg.d_model), (4, 1, cfg.d_model)):
        x = rng.standard_normal(shape).astype(jnp.bfloat16)
        check_against_reference(jcfg, cfg, p, x, name)


def test_moe_sublayer_capacity_drops(moe):
    """Inputs shifted by +1 against a router whose expert-0 column is
    raised by 0.05: ~3 more logit for expert 0, which most tokens then
    pick, and the copies past its C = 40 slots drop."""
    jcfg, cfg, p = moe
    p = dict(p, router=p["router"] + np.array([0.05, 0, 0, 0], np.float32))
    x = (np.random.default_rng(3).standard_normal((2, 64, cfg.d_model))
         + 1.0).astype(jnp.bfloat16)
    sj, st = check_against_reference(jcfg, cfg, p, x, "sub3")
    assert float(st["dropped"]) > 0.05


def test_moe_sublayer_nan_row_poisons_like_reference(moe):
    """A NaN token row: through the one-hot contractions (0 * NaN) every
    token of its example turns NaN, in both packages; the other example
    stays finite."""
    jcfg, cfg, p = moe
    x = np.random.default_rng(4).standard_normal(
        (2, 64, cfg.d_model)).astype(jnp.bfloat16)
    x[0, 5] = np.nan
    _, st = check_against_reference(jcfg, cfg, p, x, "tensor")
    yt, _ = tB.moe_sublayer(params_from_jax(p, "cpu"),
                            params_from_jax({"x": x}, "cpu")["x"], None,
                            port_policy("off"), cfg)
    assert torch.isnan(yt[0]).all() and torch.isfinite(yt[1]).all()
    assert np.isnan(float(st["aux_loss"]))


def test_moe_sublayer_backward_tokens(moe):
    """Under remat-free autograd each expert's token collects its own
    four backward events; an expert that received no copy reports its
    zero buffers' rows."""
    _, cfg, p = moe
    tp = params_from_jax(p, "cpu")
    x = params_from_jax({"x": np.random.default_rng(5).standard_normal(
        (2, 16, cfg.d_model)).astype(jnp.bfloat16)}, "cpu")["x"]
    x.requires_grad_(True)
    for k in ("router", "w1", "w2"):
        tp[k].requires_grad_(True)
    E = cfg.n_experts
    tok = {n: torch.zeros((E, 4, tmor.STATS_WIDTH), requires_grad=True)
           for n in ("w1", "w2")}
    y, st = tB.moe_sublayer(tp, x, tok, port_policy("sub3"), cfg)
    (y.float().sum() + st["aux_loss"]).backward()
    assert tp["router"].grad.dtype == torch.float32
    assert torch.isfinite(tp["router"].grad).all()
    assert tp["router"].grad.abs().sum() > 0
    for n in ("w1", "w2"):
        g = tok[n].grad
        assert g.shape == (E, 4, tmor.STATS_WIDTH)
        assert (g[:, :, tmor.STAT_EVENT_KIND] == 0).all()
        assert (g[:, :, tmor.STAT_DECISION] >= 0).all()


@pytest.mark.parametrize("name", ("off", "tensor", "sub3", "fused", "sub4"))
def test_mor_dot_experts_equals_per_expert_mor_dot(name):
    """The expert-stack lowering (one prologue and stats pass for the
    stack, one kernel launch an expert) gives each expert exactly what
    ``mor_dot`` on its own slice gives: outputs, forward stats, dx, dw
    and the tokens' backward stats, bit for bit. Ragged rows (B * C =
    40) and a zero expert buffer (an expert no copy reached) included."""
    from repro_torch.core.linear import mor_dot, mor_dot_experts
    pol = (paper_default("sub4") if name == "sub4" else port_policy(name))
    rng = np.random.default_rng(7)
    E, M, K, N = 3, 40, 64, 96
    x = torch.from_numpy(rng.standard_normal((E, M, K)).astype(
        np.float32)).to(torch.bfloat16)
    x[1] = 0
    w = torch.from_numpy((rng.standard_normal((E, K, N)) * 0.1).astype(
        np.float32)).to(torch.bfloat16)
    dy = torch.from_numpy(rng.standard_normal((E, M, N)).astype(
        np.float32)).to(torch.bfloat16)

    def run(fn):
        xs, ws = x.clone().requires_grad_(True), w.clone().requires_grad_(
            True)
        tok = torch.zeros((E, 4, tmor.STATS_WIDTH), requires_grad=True)
        y, st = fn(xs, ws, tok)
        y.backward(dy)
        return y.detach(), st, xs.grad, ws.grad, tok.grad

    got = run(lambda a, b, t: mor_dot_experts(a, b, t, pol))
    want = run(lambda a, b, t: [torch.stack(v) for v in zip(*(
        mor_dot(a[e], b[e], t[e], pol) for e in range(E)))])
    for g, r in zip(got, want):
        np.testing.assert_array_equal(bits(g), bits(r))


def test_slab_pointers_address_each_expert():
    """The stacked quantizer launches address expert e's slab of every
    stacked operand and output (a null lane stays null)."""
    from repro_torch.kernels.mor_select import slab_pointers
    a = torch.zeros((3, 4, 8), dtype=torch.bfloat16)
    b = torch.zeros((3, 2), dtype=torch.float32)
    ptrs = slab_pointers((a, b, None), 3)
    assert ptrs == [(a[e].data_ptr(), b[e].data_ptr(), None)
                    for e in range(3)]
    assert slab_pointers((a[0], None), 1) == [(a[0].data_ptr(), None)]


def test_kernel_prologue_amax_over_row_stripes(monkeypatch):
    """The kernels' prologue takes each stacked operand's group amax over
    row stripes where an operand is large (the stripe is shrunk here):
    max |x| of each operand exactly, a NaN kept."""
    from repro_torch.kernels import ops as tops
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (3, 40, 16)).astype(np.float32)).to(torch.bfloat16)
    x[2, 17, 3] = float("nan")
    want = x.float().abs().amax(dim=(1, 2))
    monkeypatch.setattr(tops, "_AMAX_STRIPE", 64)
    got = tops._amax_abs(x)
    assert got.dtype == torch.float32
    assert torch.equal(got[:2], want[:2]) and torch.isnan(got[2])
    _, g_amax, mg = tops._kernel_inputs(x, (16, 16), tops.SELECT_FORMATS,
                                        "gam")
    assert torch.equal(g_amax[:2], want[:2]) and torch.isnan(g_amax[2])
    assert float(mg[2, -1]) == 1.0  # the guarded amax of the NaN operand
