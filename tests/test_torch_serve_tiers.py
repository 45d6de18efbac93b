"""The serving tiers of the port (``serve.paged.PagedKVPool``'s fp8 and
MoR lanes, ``splice``, ``recompress_pages``, ``guard_check`` and its
accounting; ``serve.Engine`` under ``kv_fp8``, ``kv_mor``,
``kv_mor_cold``, ``kv_guard`` and the one-shot ``_full_prefill``)
against the JAX reference on reduced llama3 (vocab 512, head dim 16) on
the CPU, with the JAX ``init_params`` draw carried across by
``repro_torch.convert`` and both params trees quantized with sub3.

Pool lanes, stats rows and guard messages are held bit for bit; engine
runs token for token, on the staggered traces of
``tests/test_serve_engine.py``. The reference engines are compiled with
XLA's excess precision off (``jit_ref``) and share their compiled step
and prefill functions across engines of one configuration."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core import MoRDotPolicy as JDotPolicy
from repro.core import MoRPolicy as JPolicy
from repro.models import attention as jatt
from repro.models import make_decode_fn as jmake_decode_fn
from repro.models import make_tokens
from repro.models import init_params as jinit_params
from repro.robust import get_fault as jget_fault
from repro.serve import Engine as JEngine
from repro.serve import PagedKVPool as JPool
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import quantized as jquantized
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.core.policy import MoRDotPolicy, MoRPolicy
from repro_torch.kernels.ref import TAG_E5M2, TAG_NVFP4
from repro_torch.models import make_decode_fn
from repro_torch.models import attention as tatt
from repro_torch.robust import get_fault
from repro_torch.serve import Engine, PagedKVPool, Request, ServeConfig
from repro_torch.serve.quantized import quantize_params

TOL = 2e-3  # logits (tests/test_torch_serve.py)
NOEX = {"xla_allow_excess_precision": False}
VOCAB = 512
J_QUANT = JPolicy(recipe="sub3", backend="xla")
J_DOT = JDotPolicy(act=JPolicy(backend="xla"), weight=JPolicy(backend="xla"),
                   grad=JPolicy(backend="xla"))
T_QUANT = MoRPolicy(recipe="sub3")
TIERS = {"bf16": {}, "fp8": {"kv_fp8": True}, "mor": {"kv_mor": True}}


def jit_ref(fn, **kw):
    return jax.jit(fn, compiler_options=NOEX, **kw)


# repro.models.attention's quantizers compiled (one compile per shape).
jquantize_kv = jit_ref(jatt.quantize_kv)
jquantize_kv_mor = jit_ref(jatt.quantize_kv_mor)


def bits(t):
    """Raw bits of a torch or JAX lane as an unsigned numpy array."""
    if isinstance(t, torch.Tensor):
        if t.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
            t = t.view(torch.uint8)
        elif t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        a = t.numpy()
    else:
        a = np.asarray(t)
    return a.view(f"u{a.dtype.itemsize}")


def _nan_code(a, tags):
    """Where a MoR payload byte is a NaN code of its row's format."""
    a, t = a & 0x7F, tags[..., None]
    return np.where(t == TAG_E5M2, a > 0x7C, (t != TAG_NVFP4) & (a == 0x7F))


def assert_pools_equal(jpool, tpool, what=""):
    """Every lane bit for bit, but a MoR payload byte that is a NaN code
    (a NaN K/V element) only as NaN on both sides: ml_dtypes and PyTorch
    write different NaN codes (tests/test_torch_kv_tiers.py)."""
    tl = dict(tpool._by_key())
    jl = dict(zip(jpool._keys, jpool._leaves))
    assert list(jpool._keys) == list(tl), what
    for key, leaf in jl.items():
        a, b = bits(leaf), bits(tl[key])
        if key + "_tags" in jl:
            tags = bits(jl[key + "_tags"])
            nan_a, nan_b = _nan_code(a, tags), _nan_code(b, tags)
            np.testing.assert_array_equal(nan_a, nan_b,
                                          err_msg=f"{what} {key} NaN")
            a, b = np.where(nan_a, 0, a), np.where(nan_b, 0, b)
        np.testing.assert_array_equal(a, b, err_msg=f"{what} {key}")


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jreduced(jget_config("llama3-8b")),
                               vocab=VOCAB)
    cfg = dataclasses.replace(reduced(get_config("llama3-8b")), vocab=VOCAB)
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    qfg = jquantized.quantize_for_gemm
    jquantized.quantize_for_gemm = lambda w, pol: jit_ref(
        lambda x: qfg(x, pol))(w)
    try:
        jq, _ = jquantized.quantize_params(jparams, J_QUANT, min_size=1024)
    finally:
        jquantized.quantize_for_gemm = qfg
    tq, _ = quantize_params(tparams, T_QUANT, min_size=1024)
    return jcfg, cfg, jq, tq


# ------------------------------------------------------------------ pool --
def _pools(model, tier, slots=2, max_seq=32, page_size=8):
    jcfg, cfg, _, _ = model
    return (JPool(jcfg, slots, max_seq, page_size=page_size, **tier),
            PagedKVPool(cfg, slots, max_seq, page_size=page_size,
                        device="cpu", **tier))


def _prefill_lanes(cfg, tier, P, seed):
    """A (n_units, 1, P, Hkv, dh) bf16 K/V pair quantized to ``tier`` by
    each package: ({key: jax lane}, {key: torch lane})."""
    rng = np.random.default_rng(seed)
    shape = (cfg.n_units, 1, P, cfg.n_kv, cfg.head_dim)
    raw = {k: np.array(jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
                       .astype(jnp.float32)) for k in ("k", "v")}
    jd, td = {}, {}
    for k, x in raw.items():
        jx, tx = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(
            torch.bfloat16)
        key = f"dense/{k}"
        if tier.get("kv_fp8"):
            jd[key], jd[key + "_scale"] = jquantize_kv(jx)
            td[key], td[key + "_scale"] = tatt.quantize_kv(tx)
        elif tier.get("kv_mor"):
            # One layer at a time (quantize_kv_mor takes 4-D rows).
            jl = [jquantize_kv_mor(a) for a in jx]
            tl = [tatt.quantize_kv_mor(a) for a in tx]
            for i, suffix in enumerate(("", "_tags", "_scale")):
                jd[key + suffix] = jnp.stack([q[i] for q in jl])
                td[key + suffix] = torch.stack([q[i] for q in tl])
        else:
            jd[key], td[key] = jx, tx
    return jd, td


@pytest.mark.parametrize("tier", list(TIERS))
def test_bytes_per_token_matches_reference(model, tier):
    jcfg, cfg, _, _ = model
    jp, tp = _pools(model, TIERS[tier])
    assert tp.bytes_per_token() == jp.bytes_per_token()
    L, hkv, dh = cfg.n_units, cfg.n_kv, cfg.head_dim
    want = {"bf16": 2 * L * hkv * dh * 2, "fp8": 2 * L * (hkv * dh + 4 * hkv),
            "mor": 2 * L * (hkv * dh + hkv + 4 * hkv)}[tier]
    assert tp.bytes_per_token() == want
    # llama3-8b at full depth: 131,072 / 67,584 / 68,096 bytes a token.
    full = PagedKVPool(get_config("llama3-8b"), 1, 64, device="meta",
                       **TIERS[tier])
    assert full.bytes_per_token() == {"bf16": 131072, "fp8": 67584,
                                      "mor": 68096}[tier]


@pytest.mark.parametrize("tier", list(TIERS))
def test_splice_then_decode_matches_reference(model, tier):
    """A 13-position prefill cache spliced into slot 1 of each pool (the
    lanes equal bit for bit afterwards), then one decode step of that
    slot through gather + the decode function + scatter: logits within
    TOL, the pools bit for bit."""
    jcfg, cfg, jq, tq = model
    jp, tp = _pools(model, TIERS[tier])
    P = 13
    for p in (jp, tp):
        assert p.alloc(1, P + 1)
    jd, td = _prefill_lanes(cfg, TIERS[tier], P, seed=2)
    jp.splice(1, jd, P)
    tp.splice(1, td, P)
    assert_pools_equal(jp, tp, "after splice")

    tok, cur = np.array([[17]]), np.array([P])
    jbt = jp.table_rows([1])
    jcache = jp.gather(jp.tree, jbt)
    lj, jcache, _ = jit_ref(jmake_decode_fn(jcfg, J_DOT))(
        jq, make_tokens(jcfg), jcache, jnp.asarray(tok, jnp.int32),
        jnp.asarray(cur, jnp.int32))
    jp.update(jp.scatter(jp.tree, jcache, jbt, jnp.asarray(cur)[:, None]))
    tbt = tp.table_rows([1])
    tcache = tp.gather(tbt)
    lt, tcache, _ = make_decode_fn(cfg, MoRDotPolicy())(
        tq, tcache, torch.from_numpy(tok), torch.from_numpy(cur))
    tp.scatter(tcache, tbt, torch.from_numpy(cur)[:, None])
    np.testing.assert_allclose(lt.numpy()[..., :VOCAB],
                               np.asarray(lj)[..., :VOCAB], atol=TOL, rtol=0)
    assert_pools_equal(jp, tp, "after decode")


def _mor_pools_filled(model, seed=4):
    """kv_mor pools of 2 slots x 4 pages, slot 0 holding 29 written
    positions and slot 1 eleven, the same lanes in both."""
    jcfg, cfg, _, _ = model
    jp, tp = _pools(model, {"kv_mor": True})
    for slot, P in ((0, 29), (1, 11)):
        for p in (jp, tp):
            assert p.alloc(slot, P)
        jd, td = _prefill_lanes(cfg, {"kv_mor": True}, P, seed + slot)
        jp.splice(slot, jd, P)
        tp.splice(slot, td, P)
    return jp, tp


def test_recompress_pages_matches_reference(model):
    """Slot 0's first two pages and the trash page recompressed in both
    pools: every lane bit for bit, only the selected pages changed, and
    the count of pages recompressed returned."""
    jp, tp = _mor_pools_filled(model)
    before = {k: v.clone() for k, v in tp._by_key()}
    pages = list(tp._owned[0][:2]) + [tp.trash]
    assert jp.recompress_pages(pages) == tp.recompress_pages(pages) == 2
    assert_pools_equal(jp, tp, "after recompress")
    sel = torch.zeros(tp.n_pages + 1, dtype=torch.bool)
    sel[pages[:2]] = True
    for key, leaf in tp._by_key():
        assert torch.equal(leaf[:, ~sel], before[key][:, ~sel]), key
        if key.endswith("_tags"):
            assert (leaf[:, sel] == TAG_NVFP4).all()
    bf = PagedKVPool(model[1], 1, 32, page_size=8, device="cpu")
    with pytest.raises(ValueError, match="kv_mor"):
        bf.recompress_pages([0])


def test_kv_cache_stats_free_pages_and_stats_match_reference(model):
    jp, tp = _mor_pools_filled(model)
    for p in (jp, tp):
        p.recompress_pages(p._owned[0][:1])
    js, ts = jp.kv_cache_stats(), tp.kv_cache_stats()
    assert set(js) == set(ts)
    for key in js:
        if key == "stats_row":
            np.testing.assert_array_equal(bits(js[key]), bits(ts[key]))
        else:
            assert ts[key] == js[key], key
    assert 0 < ts["frac_nvfp4"] < 1
    assert tp.free_pages() == jp.free_pages() == 2
    assert tp.stats() == jp.stats()
    for p in (jp, tp):
        p.release(0)
        p.release(1)
    assert tp.kv_cache_stats() == jp.kv_cache_stats() == {"written": 0}
    assert tp.stats() == jp.stats() and tp.free_pages() == 8
    jf, tf = _pools(model, {"kv_fp8": True})
    assert tf.kv_cache_stats() == jf.kv_cache_stats() == {}


@pytest.mark.parametrize("tier,lane", [("bf16", None), ("fp8", None),
                                       ("mor", None), ("mor", "dense/v_scale"),
                                       ("fp8", "dense/v")])
def test_guard_check_matches_reference(model, tier, lane):
    """A clean slot passes; a page trashed by ``kv_page_trash`` (or NaN
    written into one lane only) is reported with the reference's message,
    naming the first bad lane in key order; other slots stay clean."""
    jcfg, cfg, _, _ = model
    jp, tp = _pools(model, TIERS[tier])
    for slot, P in ((0, 20), (1, 9)):
        jd, td = _prefill_lanes(cfg, TIERS[tier], P, seed=7 + slot)
        for p, d in ((jp, jd), (tp, td)):
            assert p.alloc(slot, P)
            p.splice(slot, d, P)
    assert jp.guard_check(0) is tp.guard_check(0) is None
    page = tp._owned[0][1]
    if lane is None:
        jget_fault("kv_page_trash").inject(jp, page)
        get_fault("kv_page_trash").inject(tp, page)
    else:
        i = jp._keys.index(lane)
        bad = jnp.asarray(np.nan, jnp.float32).astype(jp._leaves[i].dtype)
        jp._leaves[i] = jp._leaves[i].at[:, page, 3].set(bad)
        dict(tp._by_key())[lane][:, page, 3] = float("nan")
    msg = tp.guard_check(0)
    assert msg is not None and msg == jp.guard_check(0)
    assert repr(lane or ("dense/k_scale" if tier == "mor" else "dense/k")) \
        in msg
    assert jp.guard_check(1) is tp.guard_check(1) is None


# ---------------------------------------------------------------- engine --
_COMPILED = {}


def _jengine(jcfg, jq, scfg):
    """A reference Engine whose step and prefill functions are compiled
    with ``jit_ref``, shared by every engine of the same config (the
    pools of one config differ only in their buffers)."""
    eng = JEngine(jcfg, J_DOT, jq, scfg)
    if scfg not in _COMPILED:
        _COMPILED[scfg] = jit_ref(eng._step_fn.__wrapped__,
                                  donate_argnums=(2,))
    if "prefill" not in _COMPILED:  # the same function under every tier
        _COMPILED["prefill"] = jit_ref(eng._prefill.__wrapped__)
    eng._step_fn, eng._prefill = _COMPILED[scfg], _COMPILED["prefill"]
    return eng


def _tengine(cfg, tq, scfg):
    return Engine(cfg, MoRDotPolicy(), tq, scfg, device="cpu")


def _trace(E, R, eng_args, lengths, n_tok, seed, submit_late=True,
           full_prefill=False, on_step=None):
    """Staggered traffic: the first four prompts at once, the rest two
    and four steps later. Returns (requests, engine)."""
    eng = E(*eng_args)
    if full_prefill:
        eng.chunked_prefill = False
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, VOCAB, L).astype(np.int32) for L in lengths]
    reqs = [R(i, p, max_tokens=n_tok) for i, p in enumerate(prompts)]
    for r in reqs[:4]:
        eng.submit(r)
    steps = 0
    while eng.step() and steps < 300:
        steps += 1
        if submit_late and steps == 2 and len(reqs) > 4:
            eng.submit(reqs[4])
        if submit_late and steps == 4 and len(reqs) > 5:
            eng.submit(reqs[5])
        if on_step is not None:
            on_step(eng)
    return reqs, eng


def _both(model, scfg_kw, lengths, n_tok, seed, **kw):
    jcfg, cfg, jq, tq = model
    jscfg = JServeConfig(**scfg_kw)
    tscfg = ServeConfig(**scfg_kw)
    jr, je = _trace(_jengine, JRequest, (jcfg, jq, jscfg), lengths, n_tok,
                    seed, **kw)
    tr, te = _trace(_tengine, Request, (cfg, tq, tscfg), lengths, n_tok,
                    seed, **kw)
    return jr, je, tr, te


def _assert_same_tokens(jr, tr):
    for a, b in zip(jr, tr):
        assert b.done and b.error == a.error, (b.rid, b.error, a.error)
        assert b.out == a.out, (b.rid, b.out, a.out)


@pytest.mark.parametrize("tier", ["fp8", "mor"])
def test_engine_tier_matches_reference(model, tier):
    """kv_fp8 and kv_mor engines (3 slots, pages of 8, chunks of 8) on
    six staggered mixed-length prompts: token for token, and the pools
    bit for bit at the end."""
    kw = dict(slots=3, max_seq=64, page_size=8, prefill_chunk=8,
              **TIERS[tier])
    jr, je, tr, te = _both(model, kw, (3, 17, 9, 26, 5, 12), 5, seed=11)
    _assert_same_tokens(jr, tr)
    assert all(len(r.out) == 5 for r in tr)
    assert te.pool.free_pages() == je.pool.free_pages() == te.pool.n_pages
    assert_pools_equal(je.pool, te.pool, tier)


def test_engine_cold_sealing_matches_reference(model):
    """kv_mor with kv_mor_cold=2 (one slot, pages of 8, 24 tokens after a
    10-token prompt): token for token, the same census (stats row
    included) every third step, NVFP4 above half the written rows at
    some step, and the sealed set cleared when the request finishes."""
    kw = dict(slots=1, max_seq=64, page_size=8, prefill_chunk=8,
              kv_mor=True, kv_mor_cold=2)
    seen = {"j": [], "t": []}

    def census(which):
        def on_step(eng):
            if eng.steps % 3 == 0:
                st = eng.kv_cache_stats()
                row = st.pop("stats_row", None)
                seen[which].append((st, None if row is None
                                    else bits(row).tolist()))
        return on_step

    jcfg, cfg, jq, tq = model
    jr, je = _trace(_jengine, JRequest, (jcfg, jq, JServeConfig(**kw)),
                    (10,), 24, 12, on_step=census("j"))
    tr, te = _trace(_tengine, Request, (cfg, tq, ServeConfig(**kw)), (10,),
                    24, 12, on_step=census("t"))
    _assert_same_tokens(jr, tr)
    assert seen["t"] == seen["j"]
    assert max(st.get("frac_nvfp4", 0.0) for st, _ in seen["t"]) > 0.5
    assert not te._sealed and not je._sealed
    assert te.pool.free_pages() == te.pool.n_pages


def _per_layer_kv_mor(x):
    """The reference's quantize_kv_mor over a stacked (n_units, 1, P, H,
    dh) prefill leaf one layer at a time."""
    out = [jquantize_kv_mor(a) for a in x]
    return tuple(jnp.stack([q[i] for q in out]) for i in range(3))


@pytest.mark.parametrize("tier", list(TIERS))
def test_full_prefill_matches_reference(model, tier, monkeypatch):
    """The one-shot prefill (``chunked_prefill = False`` on both engines:
    make_prefill_fn, the tier's quantizer at the splice, PagedKVPool
    .splice) on three prompts of two lengths: token for token, the pools
    bit for bit.

    Under kv_mor the reference's ``_full_prefill`` hands the stacked
    5-D prefill leaf to ``quantize_kv_mor``, which unpacks four axes and
    raises; the port quantizes it one layer at a time. The reference run
    here is given that per-layer quantizer (the engine module's name is
    patched for this test), after checking that it raises without."""
    import repro.serve.engine as jengine_mod
    kw = dict(slots=2, max_seq=64, page_size=8, prefill_chunk=8,
              **TIERS[tier])
    if tier == "mor":
        eng = _jengine(model[0], model[2], JServeConfig(**kw))
        eng.chunked_prefill = False
        eng.submit(JRequest(0, np.arange(21, dtype=np.int32), max_tokens=2))
        with pytest.raises(ValueError, match="unpack"):
            eng.step()
        monkeypatch.setattr(jengine_mod, "quantize_kv_mor", _per_layer_kv_mor)
    jr, je, tr, te = _both(model, kw, (9, 21, 9), 4, seed=13,
                           full_prefill=True)
    _assert_same_tokens(jr, tr)
    assert te.prefill_chunks == je.prefill_chunks == 0
    assert_pools_equal(je.pool, te.pool, tier)


def test_kv_guard_quarantine_matches_reference(model):
    """The mirror of tests/test_robust_chaos.py's kv_guard case on the
    MoR tier: slot 1's last reserved page (beyond its write frontier)
    trashed after five steps; the victim is quarantined with the
    reference's error (the guard's message naming the lane), the other
    requests' tokens equal the reference's and (at this size) a clean
    run's, and the pools are the reference's bit for bit."""
    jcfg, cfg, jq, tq = model
    kw = dict(slots=3, max_seq=64, page_size=8, prefill_chunk=8,
              kv_mor=True, kv_guard=True)

    def run(E, R, args, fault, inject):
        eng = E(*args)
        rng = np.random.default_rng(11)
        reqs = [R(i, rng.integers(0, VOCAB, L).astype(np.int32),
                  max_tokens=8) for i, L in enumerate((3, 17, 9))]
        for r in reqs:
            eng.submit(r)
        if inject:
            for _ in range(5):
                eng.step()
            assert eng.slot_state[1] == "decode"
            fault.inject(eng.pool, eng.pool._owned[1][-1])
        eng.run_to_completion()
        return reqs, eng

    jargs = (jcfg, jq, JServeConfig(**kw))
    targs = (cfg, tq, ServeConfig(**kw))
    jclean, _ = run(_jengine, JRequest, jargs, None, False)
    jr, je = run(_jengine, JRequest, jargs, jget_fault("kv_page_trash"),
                 True)
    tr, te = run(_tengine, Request, targs, get_fault("kv_page_trash"), True)
    v = tr[1]
    assert v.error == jr[1].error and v.out == jr[1].out
    assert v.error.startswith("quarantined: KV-page guard")
    assert "'dense/k_scale'" in v.error and v in te.quarantined
    for a, b, c in zip(jr[::2], tr[::2], jclean[::2]):
        assert b.error is None and b.out == a.out == c.out
    assert te.pool.free_pages() == te.pool.n_pages
    # Every lane as the reference leaves it, the other slots' MoR scales
    # of the catching step included (one GAM group a quantize_kv_mor
    # call: the victim's NaN row moves them in both packages).
    assert_pools_equal(je.pool, te.pool, "after the quarantine")


def test_config_errors_match_reference(model):
    jcfg, cfg, jq, tq = model
    for kw, match in ((dict(kv_fp8=True, kv_mor=True), "mutually exclusive"),
                      (dict(kv_mor_cold=4), "kv_mor_cold")):
        scfg = dict(slots=1, max_seq=32, page_size=8, **kw)
        with pytest.raises(ValueError, match=match) as ej:
            JEngine(jcfg, J_DOT, jq, JServeConfig(**scfg))
        with pytest.raises(ValueError, match=match) as et:
            Engine(cfg, MoRDotPolicy(), tq, ServeConfig(**scfg),
                   device="cpu")
        assert str(et.value) == str(ej.value)
