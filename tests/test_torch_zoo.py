"""The port's MoE family and gemma-2b (models, train step, serving engine)
against the JAX reference on the CPU: reduced granite-moe-1b-a400m and
moonshot-v1-16b-a3b (d 64, 4 experts, top-2, d_ff 96, vocab 512, 2
layers) and reduced gemma-2b (one KV head, geglu, tied head), with the
JAX ``init_params`` draw carried across by ``repro_torch.convert``. The
reference is compiled with XLA's excess precision off (``jit_ref``) on
``backend='xla'``; the port runs its plain versions.

Tolerances, and why:
* loss and total: rtol 1e-5, ``aux_loss`` rtol 1e-6
  (``tests/test_torch_moe.py``: its mean probability sums in another
  order);
* gradients: the bf16 weight gradients within one bf16 ulp (2^-7 |g|)
  plus 1e-5 max|g|, at least 99.9% bit for bit (all of them but the
  tied embedding's are, which sums the head's and the gather's parts);
  the f32 ones (norm scales, router) within 1e-5 max|g| (f32 sums in
  another order);
* the backward stats (token gradients) through ``summarize_mor_stats``:
  block fractions within 1e-6, mean relative errors rtol 1e-5
  (``tests/test_torch_train.py``);
* logits: TOL = 2e-3 (``tests/test_torch_serve.py``), and every sampled
  token's top two logits equal on both sides or more than 10 TOL apart;
* after one AdamW step the f32 master within 1e-5
  (``tests/test_torch_train.py``);
* engines: token for token.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core.policy import MoRDotPolicy as JDotPolicy
from repro.core.policy import MoRPolicy as JPolicy
from repro.core.policy import paper_default as jpaper_default
from repro.models import cache_specs as jcache_specs
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit_params
from repro.models import make_decode_fn as jmake_decode_fn
from repro.models import make_loss_fn as jmake_loss_fn
from repro.models import make_prefill_fn as jmake_prefill_fn
from repro.models import make_tokens as jmake_tokens
from repro.models import transformer as jT
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import init_opt_state as jinit_opt_state
from repro.robust import get_fault as jget_fault
from repro.serve import Engine as JEngine
from repro.serve import PagedKVPool as JPool
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import quantized as jquantized
from repro.train import TrainConfig as JTrainConfig
from repro.train import make_train_step as jmake_train_step
from repro_torch.configs import base as tbase
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.core.policy import MoRDotPolicy, MoRPolicy, paper_default
from repro_torch.models import (cache_specs, init_cache, init_params,
                                make_decode_fn, make_prefill_fn)
from repro_torch.models import transformer as tT
from repro_torch.models.api import make_loss_fn, make_tokens
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.robust import get_fault
from repro_torch.serve import Engine, PagedKVPool, Request, ServeConfig
from repro_torch.serve.quantized import QTensor, quantize_params
from repro_torch.train import TrainConfig, make_train_step
from repro_torch.train.train_step import summarize_mor_stats

NOEX = {"xla_allow_excess_precision": False}
TOL = 2e-3
GRANITE, MOONSHOT, GEMMA = ("granite-moe-1b-a400m", "moonshot-v1-16b-a3b",
                            "gemma-2b")
J_DOT = JDotPolicy(act=JPolicy(backend="xla"), weight=JPolicy(backend="xla"),
                   grad=JPolicy(backend="xla"))
J_QUANT = JPolicy(recipe="sub3", backend="xla")
T_QUANT = MoRPolicy(recipe="sub3")


def jit_ref(fn, **kw):
    return jax.jit(fn, compiler_options=NOEX, **kw)


def jax_tensor_policy():
    pol = jpaper_default("tensor")
    return pol.replace(act=pol.act.replace(backend="xla"),
                       weight=pol.weight.replace(backend="xla"),
                       grad=pol.grad.replace(backend="xla"))


_MODELS = {}


def model(name, **over):
    """(jcfg, cfg, jparams, tparams) of the reduced arch, drawn once."""
    key = (name, tuple(sorted(over.items())))
    if key not in _MODELS:
        jcfg = dataclasses.replace(jreduced(jget_config(name)), **over)
        cfg = dataclasses.replace(reduced(get_config(name)), **over)
        jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
        tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                                  device="cpu")
        _MODELS[key] = (jcfg, cfg, jparams, tparams)
    return _MODELS[key]


def _flat(tree, prefix=""):
    """{key path: leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, name) if isinstance(v, dict) else {name: v})
    return out


def _jflat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(k.key) for k in path): leaf for path, leaf in flat}


def _dtype_name(dt):
    return str(dt).replace("torch.", "")


def batch_of(seed, B=2, S=32, vocab=512):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (B, S)),
            "labels": rng.integers(0, vocab, (B, S))}


# ------------------------------------------------------------- structure --
@pytest.mark.parametrize("name", (GRANITE, MOONSHOT, GEMMA))
def test_params_tokens_cache_specs_match_reference(name):
    jcfg, cfg, jparams, _ = model(name)
    tp = _flat(init_params(cfg, seed=0, device="cpu"))
    jp = _jflat(jparams)
    assert sorted(tp) == sorted(jp)
    for k, leaf in jp.items():
        assert tuple(tp[k].shape) == leaf.shape, k
        assert _dtype_name(tp[k].dtype) == str(leaf.dtype), k
    tt, jt = _flat(make_tokens(cfg, device="cpu")), _jflat(
        jmake_tokens(jcfg))
    assert sorted(tt) == sorted(jt)
    for k, leaf in jt.items():
        assert tuple(tt[k].shape) == leaf.shape and tt[k].requires_grad, k
    for tier in ({}, {"kv_fp8": True}, {"kv_mor": True}):
        ts = _flat(cache_specs(cfg, 3, 16, **tier))
        js = _jflat(jcache_specs(jcfg, 3, 16, **tier))
        assert sorted(ts) == sorted(js), tier
        for k, spec in js.items():
            assert ts[k] == (tuple(spec.shape), getattr(
                torch, str(spec.dtype))), (tier, k)


@pytest.mark.parametrize("arch,family", [("whisper-tiny", "audio"),
                                         ("paligemma-3b", "vlm"),
                                         ("xlstm-350m", "ssm"),
                                         ("hymba-1.5b", "hybrid")])
def test_unported_families_raise_by_name(arch, family):
    """Every family is ported now: the frontend families (audio, vlm;
    ``tests/test_torch_frontends.py``) and the recurrent ones (ssm,
    hybrid; ``tests/test_torch_recurrent.py``). init_params, make_tokens,
    cache_specs and a train forward run and give the reference's key
    paths and shapes."""
    jcfg = jreduced(jget_config(arch))
    cfg = tbase.ArchConfig(**dataclasses.asdict(jcfg))
    assert cfg.family == family
    jp = _jflat(jax.eval_shape(lambda: jinit_params(
        jcfg, jax.random.PRNGKey(0))))
    tp = _flat(init_params(cfg, device="cpu"))
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: v.shape for k, v in jp.items()}
    jt = _jflat(jax.eval_shape(lambda: jmake_tokens(jcfg)))
    assert {k: tuple(v.shape) for k, v in _flat(make_tokens(
        cfg, device="cpu")).items()} == {k: v.shape for k, v in jt.items()}
    js = _jflat(jcache_specs(jcfg, 1, 8))
    assert _flat(cache_specs(cfg, 1, 8)) == {
        k: (tuple(v.shape), getattr(torch, str(v.dtype)))
        for k, v in js.items()}
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, 512, (1, 8)))}
    front = {"audio": ("frames", cfg.enc_seq),
             "vlm": ("patches", cfg.img_tokens)}.get(family)
    if front:
        batch[front[0]] = torch.from_numpy(rng.normal(
            size=(1, front[1], cfg.d_model))).to(torch.bfloat16)
    logits, _, _ = tT.forward(cfg, MoRDotPolicy(),
                              init_params(cfg, device="cpu"), batch,
                              mode="train", remat=False)
    extra = cfg.img_tokens if family == "vlm" else 0
    assert logits.shape == (1, 8 + extra, 512)
    assert torch.isfinite(logits).all()


# ---------------------------------------------------------------- models --
def _port_forward_train(cfg, tparams, tokens):
    logits, _, _ = tT.forward(cfg, MoRDotPolicy(), tparams,
                              {"tokens": torch.from_numpy(tokens)},
                              mode="train", remat=False)
    return logits.numpy()


@pytest.mark.parametrize("name", (GRANITE, GEMMA))
def test_train_logits_match_reference(name):
    """Reduced granite (family 'moe', tied head): the reference scales
    the embedding by sqrt(d) only for the dense and vlm families, so
    granite's is not scaled (the port once scaled every tied one).
    Reduced gemma (dense, tied): scaled in both."""
    jcfg, cfg, jparams, tparams = model(name)
    toks = batch_of(1)["tokens"]
    lj = np.asarray(jit_ref(lambda p, t, b: jT.forward(
        jcfg, J_DOT, p, t, b, mode="train", remat=False)[0])(
        jparams, jmake_tokens(jcfg), {"tokens": jnp.asarray(toks,
                                                           jnp.int32)}))
    lt = _port_forward_train(cfg, tparams, toks)
    np.testing.assert_allclose(lt[..., :cfg.vocab], lj[..., :cfg.vocab],
                               atol=TOL, rtol=0)
    assert (lt[..., cfg.vocab:] == -1e30).all()


def _req_grad(tree):
    if isinstance(tree, dict):
        return {k: _req_grad(v) for k, v in tree.items()}
    return tree.detach().requires_grad_(True)


def test_loss_and_gradients_match_reference():
    """make_loss_fn under the tensor recipe: loss, aux_loss (the MoE
    load-balance terms summed over layers) and total, then the gradients
    of every parameter and the backward stats through the tokens."""
    jcfg, cfg, jparams, tparams = model(GRANITE)
    b = batch_of(2)
    f = jit_ref(jax.value_and_grad(jmake_loss_fn(jcfg, jax_tensor_policy()),
                                   argnums=(0, 1), has_aux=True))
    (tot_j, aux_j), (gp_j, gt_j) = f(
        jparams, jmake_tokens(jcfg),
        {k: jnp.asarray(v, jnp.int32) for k, v in b.items()})
    p = _req_grad(tparams)
    toks = make_tokens(cfg, device="cpu")
    tot_t, aux_t = make_loss_fn(cfg, paper_default("tensor"))(
        p, toks, {k: torch.from_numpy(v) for k, v in b.items()})
    tot_t.backward()
    tot_t = tot_t.detach()
    aux_t = {k: v.detach() if torch.is_tensor(v) else v
             for k, v in aux_t.items()}
    assert float(aux_t["aux_loss"]) > 0
    assert float(aux_t["loss"]) == pytest.approx(float(aux_j["loss"]),
                                                 rel=1e-5)
    assert float(aux_t["aux_loss"]) == pytest.approx(
        float(aux_j["aux_loss"]), rel=1e-6)
    assert float(tot_t) == pytest.approx(float(tot_j), rel=1e-5)
    assert float(tot_t) == float(aux_t["loss"] + 0.01 * aux_t["aux_loss"])
    fwd = aux_t["mor_fwd"]["blocks"]["moe"]
    assert fwd["aux_loss"].shape == fwd["dropped"].shape == (2,)
    assert fwd["w1"].shape == (2, 4, 2, 14)
    gp_t = _flat(p)
    for k, gj in _jflat(gp_j).items():
        gj = np.asarray(gj, np.float32)
        g = gp_t[k].grad
        assert g is not None and str(g.dtype).endswith(
            "bfloat16" if gp_t[k].dtype == torch.bfloat16 else "float32"), k
        g = g.float().numpy()
        err, scale = np.abs(g - gj), np.abs(gj).max()
        if gp_t[k].dtype == torch.bfloat16:
            assert (err <= 2.0**-7 * np.abs(gj) + 1e-5 * scale).all(), k
            assert (g == gj).mean() >= 0.999, k
        else:
            assert err.max() <= 1e-5 * scale, (k, err.max(), scale)
    mt = summarize_mor_stats(aux_t["mor_fwd"], {"blocks": {
        t: {n: v.grad for n, v in d.items()}
        for t, d in toks["blocks"].items()}})
    from repro.train.train_step import summarize_mor_stats as jsummarize
    mj = jsummarize(aux_j["mor_fwd"], gt_j)
    for k in ("fwd_frac_bf16", "bwd_frac_bf16"):
        assert float(mt[k]) == pytest.approx(float(mj[k]), abs=1e-6), k
    for k in ("fwd_rel_err", "bwd_rel_err"):
        assert float(mt[k]) == pytest.approx(float(mj[k]), rel=1e-5), k


def _assert_logits(lt, lj, vocab):
    lt, lj = lt.numpy()[..., :vocab], np.asarray(lj)[..., :vocab]
    np.testing.assert_allclose(lt, lj, atol=TOL, rtol=0)
    for a, b in zip(lj.reshape(-1, vocab), lt.reshape(-1, vocab)):
        top2 = np.sort(a)[-2:]
        assert a.argmax() == b.argmax() and (
            np.array_equal(a, b) or top2[1] - top2[0] >= 10 * TOL)


def test_prefill_and_decode_match_reference():
    """make_prefill_fn on a 12-token prompt, its cache into a 32-position
    decode cache, then a decode step (S = 1) and a prefill chunk (S = 4)
    against it; reduced granite, the tensor recipe."""
    jcfg, cfg, jparams, tparams = model(GRANITE)
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, 512, (1, 12))
    jtoks = jmake_tokens(jcfg)
    lj, jpc, _ = jit_ref(jmake_prefill_fn(jcfg, J_DOT))(
        jparams, jtoks, {"tokens": jnp.asarray(prompt, jnp.int32)})
    lt, tpc, st = make_prefill_fn(cfg, MoRDotPolicy())(
        tparams, {"tokens": torch.from_numpy(prompt)})
    _assert_logits(lt, lj, 512)
    assert set(tpc) == {"moe"} and st["blocks"]["moe"]["w1"].shape[:2] == \
        (2, 4)
    np.testing.assert_array_equal(
        np.asarray(jpc["moe"]["k"]).view(np.uint16),
        tpc["moe"]["k"].view(torch.int16).numpy().view(np.uint16))
    jc = jinit_cache(jcfg, 1, 32)
    jc = {"moe": {k: v.at[:, :, :12].set(jpc["moe"][k])
                  for k, v in jc["moe"].items()}}
    tc = init_cache(cfg, 1, 32, device="cpu")
    for k in ("k", "v"):
        tc["moe"][k][:, :, :12] = tpc["moe"][k]
    jdec = jit_ref(jmake_decode_fn(jcfg, J_DOT))
    tdec = make_decode_fn(cfg, MoRDotPolicy())
    for tok, cur in ((rng.integers(0, 512, (1, 1)), 12),
                     (rng.integers(0, 512, (1, 4)), 16)):
        lj, jc, _ = jdec(jparams, jtoks, jc, jnp.asarray(tok, jnp.int32),
                         jnp.asarray([cur], jnp.int32))
        lt, tc, _ = tdec(tparams, tc, torch.from_numpy(tok),
                         torch.tensor([cur]))
        _assert_logits(lt, lj, 512)


def test_train_step_matches_reference():
    """One make_train_step step (AdamW, warmup_steps=1) of reduced
    granite under sub3; the router is bf16 after it in both packages
    (the reference's AdamW returns every leaf bf16)."""
    jcfg, cfg, jparams, tparams = model(GRANITE)
    b = batch_of(4)
    pol = jpaper_default("sub3")
    pol = pol.replace(act=pol.act.replace(backend="xla"),
                      weight=pol.weight.replace(backend="xla"),
                      grad=pol.grad.replace(backend="xla"))
    jstep = jit_ref(jmake_train_step(jcfg, pol, JTrainConfig(
        optimizer=JAdamWConfig(warmup_steps=1))))
    jnew, jopt, jm = jstep(jparams, jinit_opt_state(jparams),
                           {k: jnp.asarray(v, jnp.int32)
                            for k, v in b.items()})
    tstep = make_train_step(cfg, paper_default("sub3"), TrainConfig(
        optimizer=AdamWConfig(warmup_steps=1)))
    tnew, topt, tm = tstep(tparams, init_opt_state(tparams),
                           {k: torch.from_numpy(v) for k, v in b.items()})
    for k in ("loss", "total_loss"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-5), k
    assert float(tm["aux_loss"]) == pytest.approx(float(jm["aux_loss"]),
                                                  rel=1e-6)
    assert float(tm["aux_loss"]) > 0
    for k in ("fwd_frac_bf16", "bwd_frac_bf16"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), abs=1e-6), k
    for k in ("fwd_rel_err", "bwd_rel_err", "grad_norm"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-5), k
    master = _flat(topt.master)
    for k, leaf in _jflat(jopt.master).items():
        err = np.abs(np.asarray(leaf) - master[k].numpy()).max()
        assert err <= 1e-5, (k, err)
    router_j = jnew["blocks"]["moe"]["moe"]["router"]
    router_t = tnew["blocks"]["moe"]["moe"]["router"]
    assert router_j.dtype == jnp.bfloat16 and router_t.dtype == \
        torch.bfloat16
    assert tnew["blocks"]["moe"]["moe"]["w1"].ndim == 4
    # A second step runs the bf16 router product.
    _, _, tm2 = tstep(tnew, topt, {k: torch.from_numpy(v)
                                   for k, v in batch_of(5).items()})
    assert np.isfinite(float(tm2["loss"])) and float(tm2["aux_loss"]) > 0


# ---------------------------------------------------------------- engine --
def _quantized(name, **over):
    """Both packages' trees quantized with sub3, min_size 1024: the 4-D
    expert stacks and the routers stay dense, as in the reference."""
    jcfg, cfg, jparams, tparams = model(name, **over)
    qfg = jquantized.quantize_for_gemm
    jquantized.quantize_for_gemm = lambda w, pol: jit_ref(
        lambda x: qfg(x, pol))(w)
    try:
        jq, jst = jquantized.quantize_params(jparams, J_QUANT, min_size=1024)
    finally:
        jquantized.quantize_for_gemm = qfg
    tq, tst = quantize_params(tparams, T_QUANT, min_size=1024)
    assert sorted(tst) == sorted(jst)
    return jcfg, cfg, jq, tq, tst


def _staggered(E, R, SC, cfg, params, vocab, **kw):
    """tests/test_serve_engine.py's staggered trace: six prompts, three
    slots, two requests submitted mid-stream."""
    eng = E(cfg, J_DOT if E is JEngine else MoRDotPolicy(), params,
            SC(slots=3, max_seq=64, page_size=16, prefill_chunk=8), **kw)
    if E is JEngine:
        eng._step_fn = jit_ref(eng._step_fn.__wrapped__,
                               donate_argnums=(2,))
    rng = np.random.default_rng(7)
    reqs = [R(i, rng.integers(0, vocab, L).astype(np.int32), max_tokens=5)
            for i, L in enumerate((3, 17, 9, 26, 5, 12))]
    for r in reqs[:4]:
        eng.submit(r)
    steps = 0
    while eng.step() and steps < 200:
        steps += 1
        if steps == 3:
            eng.submit(reqs[4])
        if steps == 5:
            eng.submit(reqs[5])
    return reqs, eng


@pytest.mark.parametrize("tier", ("bf16", "kv_mor"))
def test_granite_engine_matches_reference(tier):
    jcfg, cfg, jq, tq, tst = _quantized(GRANITE)
    assert set(tst) == {"blocks/moe/wqkv", "blocks/moe/wo"}
    moe = tq["blocks"]["moe"]["moe"]
    assert not any(isinstance(v, QTensor) for v in moe.values())
    assert moe["w1"].ndim == 4 and moe["router"].dtype == torch.float32
    kw = {"kv_mor": True} if tier == "kv_mor" else {}
    jreqs, jeng = _staggered(
        JEngine, JRequest,
        lambda **a: JServeConfig(**a, **kw), jcfg, jq, 512)
    treqs, teng = _staggered(
        Engine, Request, lambda **a: ServeConfig(**a, **kw), cfg, tq, 512,
        device="cpu")
    for rj, rt in zip(jreqs, treqs):
        assert rt.done and rt.error is None
        assert rt.out == rj.out, (rt.rid, rt.out, rj.out)
    assert teng.pool.bytes_per_token() == jeng.pool.bytes_per_token()


def test_gemma_engine_matches_reference():
    """Reduced gemma with the reference engine test's vocab of 128,
    unquantized weights, a bf16 pool."""
    jcfg, cfg, jparams, tparams = model(GEMMA, vocab=128)
    jreqs, jeng = _staggered(JEngine, JRequest, JServeConfig, jcfg,
                             jparams, 128)
    treqs, teng = _staggered(Engine, Request, ServeConfig, cfg, tparams,
                             128, device="cpu")
    for rj, rt in zip(jreqs, treqs):
        assert rt.done and rt.error is None
        assert rt.out == rj.out, (rt.rid, rt.out, rj.out)
    assert teng.pool.bytes_per_token() == jeng.pool.bytes_per_token()


@pytest.mark.parametrize("name,tier,want", [
    (GRANITE, {}, 2 * 2 * 2 * 16 * 2),
    (GRANITE, {"kv_mor": True}, 2 * 2 * (2 * 16 + 2 + 4 * 2)),
    (GEMMA, {"kv_fp8": True}, 2 * 2 * (16 + 4))])
def test_pool_bytes_and_guard_match_reference(name, tier, want):
    """bytes_per_token and the full-depth figures; a page trashed by
    ``kv_page_trash`` named by the same ``moe/...`` / ``dense/...`` lane,
    the first bad one in sorted key order."""
    jcfg, cfg, _, _ = model(name)
    jp = JPool(jcfg, 2, 32, page_size=8, **tier)
    tp = PagedKVPool(cfg, 2, 32, page_size=8, device="cpu", **tier)
    assert tp.bytes_per_token() == jp.bytes_per_token() == want
    assert list(jp._keys) == [k for k, _ in tp._by_key()]
    for p in (jp, tp):
        assert p.alloc(0, 20) and p.alloc(1, 9)
    assert jp.guard_check(0) is tp.guard_check(0) is None
    page = tp._owned[0][1]
    jget_fault("kv_page_trash").inject(jp, page)
    get_fault("kv_page_trash").inject(tp, page)
    msg = tp.guard_check(0)
    assert msg is not None and msg == jp.guard_check(0)
    prefix = "moe" if name == GRANITE else "dense"
    assert f"'{prefix}/k" in msg
    assert jp.guard_check(1) is tp.guard_check(1) is None
    full = {GRANITE: {(): 49152, ("kv_mor",): 26496},
            GEMMA: {(): 18432, ("kv_mor",): 9396}}
    for arch, by_tier in full.items():
        for t, n in by_tier.items():
            pool = PagedKVPool(get_config(arch), 1, 64, device="meta",
                               **{k: True for k in t})
            assert pool.bytes_per_token() == n, (arch, t)
    assert PagedKVPool(get_config(MOONSHOT), 1, 64, device="meta"
                       ).bytes_per_token() == 2 * 48 * 16 * 128 * 2


@pytest.mark.parametrize("arch", ("whisper-tiny", "paligemma-3b",
                                  "xlstm-350m", "hymba-1.5b"))
def test_engine_refuses_unported_families(arch):
    """The engine refuses the frontend families (audio, vlm) with the
    reference's message, as the reference's engine does; the recurrent
    families (ssm, hybrid) are ported: the engine builds, with one-shot
    prefill and the reference pool's key paths (the state slot-dense)."""
    jcfg = jreduced(jget_config(arch))
    cfg = tbase.ArchConfig(**dataclasses.asdict(jcfg))
    if cfg.family in ("audio", "vlm"):
        with pytest.raises(NotImplementedError) as te:
            Engine(cfg, MoRDotPolicy(), {}, device="cpu")
        with pytest.raises(NotImplementedError) as je:
            JEngine(jcfg, J_DOT, {})
        assert str(te.value) == str(je.value)
        return
    eng = Engine(cfg, MoRDotPolicy(), init_params(cfg, device="cpu"),
                 ServeConfig(slots=2, max_seq=32, page_size=8,
                             prefill_chunk=8), device="cpu")
    jp = JPool(jcfg, 2, 32, page_size=8)
    assert not eng.chunked_prefill
    assert list(jp._keys) == [k for k, _ in eng.pool._by_key()]
    assert eng.pool.bytes_per_token() == jp.bytes_per_token()
