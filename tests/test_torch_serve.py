"""The port's quantized serving slice against the JAX reference on
reduced llama3 (vocab 512), with the JAX ``init_params`` draw carried
across by ``repro_torch.convert.params_from_jax``.

Every GEMM weight (the untied head included) becomes a QTensor: both
packages quantize with sub3 and ``quantize_min_size=1024``; the JAX side
runs ``backend='xla'`` on every policy. The port runs on the CPU, i.e.
its plain versions.

Tolerance TOL on logits: the port follows the reference op for op
(GEMM sums in k order, silu as XLA lowers it), so most logits agree
exactly; where XLA and PyTorch round an f32 op (the attention einsums,
the softmax exp) differently, a bf16 activation may flip by one ulp.
The reference is compiled with XLA's excess precision off
(``jit_ref``): with it on, XLA fuses the residual add into the next norm
and skips that bf16 rounding, which moves every logit by ~1e-3 -- the
port implements the op-by-op semantics. (Run op by op instead, JAX
compiles every primitive separately, which took most of the time.)"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core import BF16_BASELINE as J_BF16
from repro.core import MoRDotPolicy as JDotPolicy
from repro.core import MoRPolicy as JPolicy
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit_params
from repro.models import make_decode_fn as jmake_decode_fn
from repro.models import make_tokens
from repro.serve import Engine as JEngine
from repro.serve import PromptTooLongError as JPromptTooLong
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import quantized as jquantized
from repro.serve.quantized import quantize_params as jquantize_params
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.core.policy import BF16_BASELINE, MoRDotPolicy, MoRPolicy
from repro_torch.models import init_cache, make_decode_fn
from repro_torch.serve import Engine, PromptTooLongError, Request, ServeConfig
from repro_torch.serve.quantized import QTensor, quantize_params

TOL = 2e-3
NOEX = {"xla_allow_excess_precision": False}
VOCAB = 512
J_QUANT = JPolicy(recipe="sub3", backend="xla")
J_DOT = JDotPolicy(act=JPolicy(backend="xla"), weight=JPolicy(backend="xla"),
                   grad=JPolicy(backend="xla"))
T_QUANT = MoRPolicy(recipe="sub3")


def jit_ref(fn, **kw):
    """``fn`` compiled by XLA with its excess precision off, so every
    bf16 op rounds as written (as in the port)."""
    return jax.jit(fn, compiler_options=NOEX, **kw)


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jreduced(jget_config("llama3-8b")),
                               vocab=VOCAB)
    cfg = dataclasses.replace(reduced(get_config("llama3-8b")), vocab=VOCAB)
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return jcfg, cfg, jparams, tparams


def test_params_from_jax_bit_exact(model):
    _, _, jparams, tparams = model
    flat, _ = jax.tree_util.tree_flatten_with_path(jparams)
    for path, leaf in flat:
        t = tparams
        for k in path:
            t = t[k.key]
        a = np.asarray(leaf)
        b = (t.view(torch.int16).numpy().view(np.uint16)
             if t.dtype == torch.bfloat16 else t.numpy())
        np.testing.assert_array_equal(
            a.view(np.uint16) if a.dtype.name == "bfloat16" else a, b)


@pytest.fixture(scope="module")
def quantized(model):
    """Both params trees quantized once: (jq, jst, tq, tst)."""
    _, _, jparams, tparams = model
    # quantize_params reads its stats back to floats, so only the
    # per-matrix quantization inside it is compiled.
    qfg = jquantized.quantize_for_gemm
    jquantized.quantize_for_gemm = lambda w, pol: jit_ref(
        lambda x: qfg(x, pol))(w)
    try:
        jq, jst = jquantize_params(jparams, J_QUANT, min_size=1024)
    finally:
        jquantized.quantize_for_gemm = qfg
    tq, tst = quantize_params(tparams, T_QUANT, min_size=1024)
    return jq, jst, tq, tst


def test_quantize_params_stats_match(quantized):
    jq, jst, tq, tst = quantized
    assert set(tst) == set(jst) == {
        "blocks/dense/wqkv", "blocks/dense/wo", "blocks/dense/mlp/wi",
        "blocks/dense/mlp/wo", "lm_head"}
    for name, st in jst.items():
        assert set(tst[name]) == set(st)
        for k, v in st.items():
            assert tst[name][k] == pytest.approx(v, rel=1e-5), (name, k)
    assert isinstance(tq["lm_head"], QTensor)
    assert tq["blocks"]["dense"]["wqkv"].is_stacked
    assert not isinstance(tq["embed"], QTensor)


def test_prefill_chunk_and_decode_step_logits(model, quantized):
    jcfg, cfg, _, _ = model
    jq, _, tq, _ = quantized
    jdec, tdec = jit_ref(jmake_decode_fn(jcfg, J_DOT)), make_decode_fn(
        cfg, MoRDotPolicy())
    toks = make_tokens(jcfg)
    jc, tc = jinit_cache(jcfg, 2, 64), init_cache(cfg, 2, 64, device="cpu")
    rng = np.random.default_rng(0)
    steps = [(rng.integers(0, VOCAB, (2, 8)), np.array([7, 12])),
             (rng.integers(0, VOCAB, (2, 1)), np.array([8, 13]))]
    for tok, cur in steps:
        lj, jc, _ = jdec(jq, toks, jc, jnp.asarray(tok, jnp.int32),
                         jnp.asarray(cur, jnp.int32))
        lt, tc, _ = tdec(tq, tc, torch.from_numpy(tok), torch.from_numpy(cur))
        lj = np.asarray(lj)
        assert lt.shape == lj.shape and lt.dtype == torch.float32
        np.testing.assert_allclose(lt.numpy()[..., :VOCAB],
                                   lj[..., :VOCAB], atol=TOL, rtol=0)
        assert (lt.numpy()[..., VOCAB:] == -1e30).all()
    np.testing.assert_array_equal(
        np.asarray(jc["dense"]["k"]).view(np.uint16),
        tc["dense"]["k"].view(torch.int16).numpy().view(np.uint16))


def exact_steps(eng):
    """Recompile a reference Engine's step with ``jit_ref``."""
    eng._step_fn = jit_ref(eng._step_fn.__wrapped__, donate_argnums=(2,))
    return eng


def _staggered(E, R, SC, cfg, policy, params, **kw):
    """The staggered trace of tests/test_serve_engine.py: six prompts,
    three slots, two requests submitted mid-stream. Records the logits
    row of every sampled token."""
    eng = E(cfg, policy, params,
            SC(slots=3, max_seq=64, page_size=16, prefill_chunk=8), **kw)
    if E is JEngine:
        exact_steps(eng)
    rows = []
    sample = eng._sample

    def recording_sample(req, row):
        rows.append((req.rid, np.asarray(row[:VOCAB], np.float32).copy()))
        return sample(req, row)

    eng._sample = recording_sample
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, VOCAB, L).astype(np.int32)
               for L in (3, 17, 9, 26, 5, 12)]
    reqs = [R(i, p, max_tokens=5) for i, p in enumerate(prompts)]
    for r in reqs[:4]:
        eng.submit(r)
    steps = 0
    while eng.step() and steps < 200:
        steps += 1
        if steps == 3:
            eng.submit(reqs[4])
        if steps == 5:
            eng.submit(reqs[5])
    return reqs, rows


def test_engine_tokens_match_staggered_trace(model, quantized):
    """The port's Engine quantizes its weights itself (quantize=sub3);
    the reference Engine gets the tree the fixture already quantized
    with the same quantize_params call its constructor would make."""
    jcfg, cfg, _, tparams = model
    jq = quantized[0]
    jreqs, jrows = _staggered(JEngine, JRequest, JServeConfig, jcfg,
                              J_DOT, jq)
    treqs, trows = _staggered(Engine, Request, ServeConfig, cfg,
                              MoRDotPolicy(), tparams, quantize=T_QUANT,
                              quantize_min_size=1024, device="cpu")
    for rj, rt in zip(jreqs, treqs):
        assert rt.done and rt.error is None
        assert rt.out == rj.out, (rt.rid, rt.out, rj.out)
    assert [r for r, _ in trows] == [r for r, _ in jrows]
    exact = 0
    for (rid, a), (_, b) in zip(jrows, trows):
        diff = np.abs(a - b).max()
        assert diff <= TOL, (rid, diff)
        if diff == 0.0:
            exact += 1  # identical logits: the argmax cannot flip
            continue
        top2 = np.sort(a)[-2:]
        assert top2[1] - top2[0] >= 10 * TOL, (rid, top2, diff)
    assert exact >= len(jrows) // 2


def test_prompt_limits_and_rejection_match(model):
    """Admission edges against the reference on the disabled-policy
    (plain bf16 dot) path: the max_seq - 1 limit, truncation, and the
    rejection of an unsatisfiable page reservation."""
    jcfg, cfg, jparams, tparams = model
    outs = []
    for E, R, SC, c, pol, params, too_long, kw in (
            (JEngine, JRequest, JServeConfig, jcfg, J_BF16, jparams,
             JPromptTooLong, {}),
            (Engine, Request, ServeConfig, cfg, BF16_BASELINE, tparams,
             PromptTooLongError, {"device": "cpu"})):
        make = (lambda *a: exact_steps(E(*a))) if E is JEngine else E
        eng = make(c, pol, params, SC(slots=1, max_seq=32, prefill_chunk=8),
                   **kw)
        with pytest.raises(too_long):
            eng.submit(R(9, np.arange(32) % VOCAB))
        ok = R(0, np.arange(31, dtype=np.int32) % VOCAB, max_tokens=2)
        eng.submit(ok)
        trunc_eng = make(c, pol, params,
                         SC(slots=1, max_seq=32, prefill_chunk=8,
                            on_long_prompt="truncate"), **kw)
        long_req = R(1, np.arange(37, dtype=np.int32) % VOCAB, max_tokens=2)
        trunc_eng.submit(long_req)
        rej_eng = make(c, pol, params,
                       SC(slots=2, max_seq=64, page_size=8, prefill_chunk=8,
                          pool_pages=3), **kw)
        hog = R(2, np.arange(16, dtype=np.int32) % VOCAB, max_tokens=30)
        small = R(3, np.arange(5, dtype=np.int32) % VOCAB, max_tokens=4)
        rej_eng.submit(hog)
        rej_eng.submit(small)
        eng.run_to_completion()
        trunc_eng.run_to_completion()
        rej_eng.run_to_completion()
        assert ok.done and ok.error is None and len(ok.out) == 2
        assert len(long_req.prompt) == 31 and "truncated" in long_req.error
        assert hog.done and not hog.out and hog in rej_eng.rejected
        assert small.done and small.error is None
        outs.append((ok.out, long_req.out, long_req.error, hog.error,
                     small.out))
    assert outs[0] == outs[1]


def test_unported_options_raise(model):
    """A mesh that is not a ``Mesh`` raises a TypeError; tensor-parallel
    serving of the MoE and recurrent families raises, naming its ROADMAP
    item."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.collectives import Mesh

    _, cfg, _, tparams = model
    with pytest.raises(TypeError, match="Mesh"):
        Engine(cfg, BF16_BASELINE, tparams, mesh=object(), device="cpu")
    mesh = Mesh((1, 1), ("data", "model"), "cpu", 0, {})
    for arch in ("granite-moe-1b-a400m", "hymba-1.5b", "xlstm-350m"):
        with pytest.raises(NotImplementedError, match="item 1d"):
            Engine(reduced(get_config(arch)), BF16_BASELINE, tparams,
                   mesh=mesh, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Engine(cfg, BF16_BASELINE, tparams)  # the default is the card
