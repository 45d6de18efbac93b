"""The KV cache tiers of the port's models against the JAX reference on
the CPU: ``models.attention``'s quantizers (``quantize_kv``,
``quantize_kv_mor``, ``recompress_kv_nvfp4``), their byte and stats
accounting and ``decode_attention`` over fp8, MoR and cold NVFP4 caches;
then, on reduced llama3 (vocab 512, head dim 16) with the JAX
``init_params`` draw carried across by ``repro_torch.convert``, the
cache lanes of ``cache_specs`` / ``init_cache``, full-sequence prefill
(``make_prefill_fn``) and decode steps against fp8 and MoR caches.

Inputs are numpy draws from a seed, rounded to bf16 as the model's K/V
are, kept away from f32 denormals (XLA on the CPU flushes them).
Quantized lanes (payload bytes, tags, scales, stats rows) are held bit
for bit, with one exception: where an element is NaN its payload byte
is a NaN code on both sides, but not the same one (ml_dtypes writes
0x7E for an E5M2 NaN, PyTorch 0x7F, each with the sign its arithmetic
gave the NaN), so those bytes are held to decoding to NaN. Attention
outputs are held within RTOL / ATOL and logits within TOL: XLA and
PyTorch round the f32 einsums (over values up to ~1e3 here) and the
softmax's exp differently in the last bit, and a logit carries such a
flip through the model (TOL is ``tests/test_torch_serve.py``'s)."""
import dataclasses
import types

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
from repro.models import attention as jatt
from repro.models import cache_specs as jcache_specs
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit_params
from repro.models import make_decode_fn as jmake_decode_fn
from repro.models import make_prefill_fn as jmake_prefill_fn
from repro.models import make_tokens
from repro.serve import quantized as jquantized
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.core.policy import BF16_BASELINE, MoRDotPolicy, MoRPolicy
from repro_torch.kernels.ref import TAG_E4M3, TAG_E5M2, TAG_NVFP4
from repro_torch.models import (cache_specs, init_cache, make_decode_fn,
                                make_prefill_fn)
from repro_torch.models import attention as tatt
from repro_torch.serve.quantized import quantize_params

TOL = 2e-3    # logits (tests/test_torch_serve.py)
RTOL, ATOL = 1e-4, 1e-5   # f32 attention outputs
NOEX = {"xla_allow_excess_precision": False}
VOCAB = 512
J_QUANT = JPolicy(recipe="sub3", backend="xla")
J_DOT = JDotPolicy(act=JPolicy(backend="xla"), weight=JPolicy(backend="xla"),
                   grad=JPolicy(backend="xla"))
T_QUANT = MoRPolicy(recipe="sub3")


def jit_ref(fn, **kw):
    return jax.jit(fn, compiler_options=NOEX, **kw)


# repro.models.attention's functions compiled (one compile per input
# shape) in place of op-by-op dispatch.
jatt_c = types.SimpleNamespace(
    quantize_kv=jit_ref(jatt.quantize_kv),
    quantize_kv_mor=jit_ref(jatt.quantize_kv_mor,
                            static_argnames="with_stats"),
    recompress_kv_nvfp4=jit_ref(jatt.recompress_kv_nvfp4),
    decode_attention=jit_ref(jatt.decode_attention))


def np_of(t):
    """numpy view of a torch or JAX array, fp8 / bf16 as raw bits."""
    if isinstance(t, torch.Tensor):
        if t.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
            return t.view(torch.uint8).numpy()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    a = np.asarray(t)
    if a.dtype.name in ("float8_e4m3fn", "float8_e5m2"):
        return a.view(np.uint8)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16)
    return a


def assert_bits(a, b, what=""):
    a, b = np_of(a), np_of(b)
    assert a.shape == b.shape and a.dtype.itemsize == b.dtype.itemsize, what
    if a.dtype.kind == "f":
        a = a.view(f"u{a.dtype.itemsize}")
        b = b.view(f"u{b.dtype.itemsize}")
    np.testing.assert_array_equal(a, b, err_msg=what)


def assert_payload_bits(a, b, tags, what=""):
    """MoR payload bytes bit for bit, but NaN elements only as NaN on
    both sides (each package writes its own NaN code)."""
    a, b, tags = np_of(a), np_of(b), np_of(tags)[..., None]
    e5 = tags == TAG_E5M2
    nan_a = np.where(e5, (a & 0x7F) > 0x7C, (a & 0x7F) == 0x7F)
    nan_b = np.where(e5, (b & 0x7F) > 0x7C, (b & 0x7F) == 0x7F)
    np.testing.assert_array_equal(nan_a, nan_b, err_msg=what)
    np.testing.assert_array_equal(np.where(nan_a, 0, a), np.where(nan_b, 0, b),
                                  err_msg=what)


def assert_within_bf16_ulp(a, b, what=""):
    """bf16 arrays at most one ulp apart (same sign, adjacent codes)."""
    a = np_of(a).astype(np.int32)
    b = np_of(b).astype(np.int32)
    assert ((a >> 15) == (b >> 15)).all(), what
    assert (np.abs((a & 0x7FFF) - (b & 0x7FFF)) <= 1).all(), what


def kv_rows(shape, seed, nan_row=True):
    """(B, S, H, dh) bf16-exact f32 KV rows: N(0, 1) rows, rows of wide
    dynamic range (E5M2 wins), rows with a single outlier, all-zero rows
    and (``nan_row``) a NaN row."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    B, S, H, dh = shape
    x[:, 1::4] = np.sign(x[:, 1::4]) * rng.uniform(
        1, 2, x[:, 1::4].shape) * np.exp2(
        rng.integers(-12, 4, x[:, 1::4].shape))
    x[:, 2::4, :, 3] *= 300.0
    x[:, 3::5] = 0.0
    if nan_row:
        x[0, 0, 0, 5] = np.nan
    return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def both(x):
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(
        torch.bfloat16)


# ------------------------------------------------------------ functions --
def test_quantize_kv_bit_exact():
    jx, tx = both(kv_rows((2, 9, 3, 32), 0, nan_row=False))
    jp, js = jatt_c.quantize_kv(jx)
    tp, ts = tatt.quantize_kv(tx)
    assert tp.dtype == torch.float8_e4m3fn and ts.dtype == torch.float32
    assert_bits(jp, tp, "payload")
    assert_bits(js, ts, "scales")


@pytest.mark.parametrize("nan_row", [False, True])
def test_quantize_kv_mor_bit_exact(nan_row):
    """Payload, tags, scales and stats row bit for bit, on rows that pick
    E4M3 and E5M2, all-zero rows and (one case) a NaN row."""
    jx, tx = both(kv_rows((2, 12, 2, 32), 1, nan_row))
    jout = jatt_c.quantize_kv_mor(jx, with_stats=True)
    tout = tatt.quantize_kv_mor(tx, with_stats=True)
    assert_payload_bits(jout[0], tout[0], tout[1], "payload")
    for name, a, b in zip(("tags", "scales", "stats"), jout[1:], tout[1:]):
        assert_bits(a, b, name)
    tags = tout[1].numpy()
    assert (tags == TAG_E4M3).any() and (tags == TAG_E5M2).any()
    assert tout[0].dtype == tout[1].dtype == torch.uint8


def _mor_lanes(seed, shape=(3, 8, 2, 32)):
    jx, tx = both(kv_rows(shape, seed, nan_row=False))
    return jatt_c.quantize_kv_mor(jx), tatt.quantize_kv_mor(tx)


def test_recompress_kv_nvfp4_bit_exact():
    (jp, jt, js), (tp, tt, ts) = _mor_lanes(2)
    # Unwritten rows (scale 0) are recompressed too, as in the reference.
    js, ts = js.at[:, -1].set(0.0), ts.clone()
    ts[:, -1] = 0.0
    jout = jatt_c.recompress_kv_nvfp4(jp, jt, js)
    tout = tatt.recompress_kv_nvfp4(tp, tt, ts)
    for name, a, b in zip(("payload", "tags", "scales"), jout, tout):
        assert_bits(a, b, name)
    assert (tout[1].numpy() == TAG_NVFP4).all()
    with pytest.raises(ValueError, match="divisible by 16"):
        tatt.recompress_kv_nvfp4(tp[..., :24], tt, ts)


def test_kv_bytes_and_stats_row_bit_exact():
    rng = np.random.default_rng(3)
    for n in (1, 7, 1000):
        t = rng.integers(0, 4, n).astype(np.uint8)
        assert_bits(jatt.kv_bytes_per_element(t),
                    tatt.kv_bytes_per_element(torch.from_numpy(t)), "bpe")
        assert_bits(jatt.kv_stats_row(t),
                    tatt.kv_stats_row(torch.from_numpy(t)), "stats row")


def _decode_inputs(seed, B=3, T=32, Hq=4, Hkv=2, dh=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 2, Hq, dh)).astype(np.float32)
    k = kv_rows((B, T, Hkv, dh), seed + 1, nan_row=False)
    v = kv_rows((B, T, Hkv, dh), seed + 2, nan_row=False)
    cur = np.array([5, 17, 31], np.int32)[:B]
    return q, k, v, cur


def cold_first(recompress, lanes, h, cat):
    """(payload, tags, scales) with positions [0, h) recompressed to
    NVFP4 (a cold page) and the rest as they were."""
    cold = recompress(*(a[:, :h] for a in lanes))
    return tuple(cat(c, a[:, h:]) for c, a in zip(cold, lanes))


@pytest.mark.parametrize("tier", ["fp8", "mor", "cold"])
def test_decode_attention_tiers(tier):
    """decode_attention over an fp8, a MoR and a MoR cache whose first
    half is cold NVFP4, with per-row positions and two queries a row,
    against the reference on the same lanes."""
    q, k, v, cur = _decode_inputs(4)
    jq, tq = jnp.asarray(q), torch.from_numpy(q)
    jk, tk = both(k)
    jv, tv = both(v)
    if tier == "fp8":
        (jkp, jks), (jvp, jvs) = jatt_c.quantize_kv(jk), jatt_c.quantize_kv(jv)
        (tkp, tks), (tvp, tvs) = tatt.quantize_kv(tk), tatt.quantize_kv(tv)
        jkw, tkw = dict(k_scale=jks, v_scale=jvs), dict(k_scale=tks,
                                                        v_scale=tvs)
    else:
        jkp, jkt, jks = jatt_c.quantize_kv_mor(jk)
        jvp, jvt, jvs = jatt_c.quantize_kv_mor(jv)
        tkp, tkt, tks = tatt.quantize_kv_mor(tk)
        tvp, tvt, tvs = tatt.quantize_kv_mor(tv)
        if tier == "cold":
            h = k.shape[1] // 2
            (jkp, jkt, jks), (jvp, jvt, jvs) = (
                cold_first(jatt_c.recompress_kv_nvfp4, lanes, h,
                           lambda a, b: jnp.concatenate([a, b], axis=1))
                for lanes in ((jkp, jkt, jks), (jvp, jvt, jvs)))
            (tkp, tkt, tks), (tvp, tvt, tvs) = (
                cold_first(tatt.recompress_kv_nvfp4, lanes, h,
                           lambda a, b: torch.cat([a, b], dim=1))
                for lanes in ((tkp, tkt, tks), (tvp, tvt, tvs)))
            assert (tkt.numpy()[:, :h] == TAG_NVFP4).all()
        jkw = dict(k_scale=jks, v_scale=jvs, k_tags=jkt, v_tags=jvt)
        tkw = dict(k_scale=tks, v_scale=tvs, k_tags=tkt, v_tags=tvt)
    jo = jatt_c.decode_attention(jq, jkp, jvp, jnp.asarray(cur), **jkw)
    to = tatt.decode_attention(tq, tkp, tvp, torch.from_numpy(cur), **tkw)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL,
                               rtol=RTOL)


def _poison_beyond(a, cur, value):
    """Positions past ``cur`` (garbage by contract) set to ``value``."""
    a = a.clone()
    a[:, cur + 1:] = value
    return a


def test_decode_mor_trash_rows_cannot_poison_output():
    """Mirror of tests/test_kv_mor.py:198: 0x7F payload bytes (E4M3 NaN),
    NVFP4 tags and NaN / 0 / denormal / Inf scales past ``cur`` leave the
    output bit-identical to the clean one, and the clean one matches the
    reference."""
    rng = np.random.default_rng(9)
    B, T, Hq, Hkv, dh = 2, 16, 4, 2, 16
    cur = 9
    q = rng.standard_normal((B, 1, Hq, dh)).astype(np.float32)
    k = rng.standard_normal((B, T, Hkv, dh)).astype(np.float32)
    v = rng.standard_normal((B, T, Hkv, dh)).astype(np.float32)
    tq = torch.from_numpy(q)
    kp, kt, ks = tatt.quantize_kv_mor(torch.from_numpy(k))
    vp, vt, vs = tatt.quantize_kv_mor(torch.from_numpy(v))
    clean = tatt.decode_attention(tq, kp, vp, cur, k_scale=ks, v_scale=vs,
                                  k_tags=kt, v_tags=vt)
    jk = jatt_c.quantize_kv_mor(jnp.asarray(k))
    jv = jatt_c.quantize_kv_mor(jnp.asarray(v))
    jo = jatt_c.decode_attention(jnp.asarray(q), jk[0], jv[0], cur,
                               k_scale=jk[2], v_scale=jv[2], k_tags=jk[1],
                               v_tags=jv[1])
    np.testing.assert_allclose(clean.numpy(), np.asarray(jo), atol=ATOL,
                               rtol=RTOL)
    kp2, vp2 = _poison_beyond(kp, cur, 0x7F), _poison_beyond(vp, cur, 0x7F)
    kt2 = _poison_beyond(kt, cur, TAG_NVFP4)
    vt2 = _poison_beyond(vt, cur, TAG_NVFP4)
    for bad in (float("nan"), 0.0, 1e-42, float("inf")):
        out = tatt.decode_attention(
            tq, kp2, vp2, cur, k_scale=_poison_beyond(ks, cur, bad),
            v_scale=_poison_beyond(vs, cur, bad), k_tags=kt2, v_tags=vt2)
        assert torch.isfinite(out).all(), bad
        assert torch.equal(out, clean), bad


def test_decode_fp8_trash_rows_cannot_poison_output():
    """Mirror of tests/test_kv_mor.py:240 on the fp8 cache: NaN payloads
    and garbage scales past ``cur``."""
    rng = np.random.default_rng(10)
    B, T, Hq, Hkv, dh = 2, 16, 4, 2, 16
    cur = 6
    q = torch.from_numpy(rng.standard_normal((B, 1, Hq, dh)).astype(
        np.float32))
    k = torch.from_numpy(rng.standard_normal((B, T, Hkv, dh)).astype(
        np.float32))
    v = torch.from_numpy(rng.standard_normal((B, T, Hkv, dh)).astype(
        np.float32))
    kp, ks = tatt.quantize_kv(k)
    vp, vs = tatt.quantize_kv(v)
    clean = tatt.decode_attention(q, kp, vp, cur, k_scale=ks, v_scale=vs)
    kp2 = _poison_beyond(kp.to(torch.float32), cur, float("nan")).to(
        kp.dtype)
    vp2 = _poison_beyond(vp.to(torch.float32), cur, float("nan")).to(
        vp.dtype)
    for bad in (float("nan"), 0.0, 1e-42, float("inf")):
        out = tatt.decode_attention(
            q, kp2, vp2, cur, k_scale=_poison_beyond(ks, cur, bad),
            v_scale=_poison_beyond(vs, cur, bad))
        assert torch.isfinite(out).all(), bad
        assert torch.equal(out, clean), bad


# ----------------------------------------------------------------- model --
@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jreduced(jget_config("llama3-8b")),
                               vocab=VOCAB)
    cfg = dataclasses.replace(reduced(get_config("llama3-8b")), vocab=VOCAB)
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return jcfg, cfg, jparams, tparams


@pytest.fixture(scope="module")
def quantized(model):
    """Both params trees quantized once (sub3, min_size 1024)."""
    _, _, jparams, tparams = model
    qfg = jquantized.quantize_for_gemm
    jquantized.quantize_for_gemm = lambda w, pol: jit_ref(
        lambda x: qfg(x, pol))(w)
    try:
        jq, _ = jquantized.quantize_params(jparams, J_QUANT, min_size=1024)
    finally:
        jquantized.quantize_for_gemm = qfg
    tq, _ = quantize_params(tparams, T_QUANT, min_size=1024)
    return jq, tq


@pytest.mark.parametrize("tier", [{}, {"kv_fp8": True}, {"kv_mor": True}])
def test_cache_specs_match_reference(model, tier):
    jcfg, cfg, _, _ = model
    js = jcache_specs(jcfg, 3, 16, **tier)["dense"]
    ts = cache_specs(cfg, 3, 16, **tier)["dense"]
    assert set(js) == set(ts)
    for key, spec in js.items():
        shape, dtype = ts[key]
        assert tuple(spec.shape) == tuple(shape), key
        assert np.dtype(spec.dtype).name == str(dtype).split(".")[-1], key
    cache = init_cache(cfg, 3, 16, device="cpu", **tier)["dense"]
    jc = jinit_cache(jcfg, 3, 16, **tier)["dense"]
    for key in js:
        assert_bits(jc[key], cache[key], key)
    for fn in (lambda: cache_specs(cfg, 1, 8, kv_fp8=True, kv_mor=True),
               lambda: init_cache(cfg, 1, 8, kv_fp8=True, kv_mor=True,
                                  device="cpu")):
        with pytest.raises(ValueError, match="mutually exclusive"):
            fn()


@pytest.mark.parametrize("weights", ["bf16", "qtensor"])
def test_make_prefill_fn_matches_reference(model, quantized, weights):
    """make_prefill_fn on a 24-token batch of two: last-position logits
    within TOL; the emitted K/V of every layer bit for bit through the
    QTensor (mixed GEMM) weights, and within one bf16 ulp through bf16
    weights, whose qkv GEMM sums in another order in XLA's dot and
    PyTorch's."""
    jcfg, cfg, jparams, tparams = model
    if weights == "bf16":
        jp, tp, jpol, tpol = jparams, tparams, J_BF16, BF16_BASELINE
    else:
        (jp, tp), jpol, tpol = quantized, J_DOT, MoRDotPolicy()
    toks = np.random.default_rng(5).integers(0, VOCAB, (2, 24))
    jl, jc, _ = jit_ref(jmake_prefill_fn(jcfg, jpol))(
        jp, make_tokens(jcfg), {"tokens": jnp.asarray(toks, jnp.int32)})
    tl, tc, _ = make_prefill_fn(cfg, tpol)(
        tp, {"tokens": torch.from_numpy(toks)})
    assert tl.shape == (2, 1, 512) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy()[..., :VOCAB],
                               np.asarray(jl)[..., :VOCAB], atol=TOL,
                               rtol=0)
    assert set(tc) == {"dense"} and set(tc["dense"]) == {"k", "v"}
    for key in ("k", "v"):
        assert tc["dense"][key].shape == (cfg.n_units, 2, 24, cfg.n_kv,
                                          cfg.head_dim)
        assert tc["dense"][key].dtype == torch.bfloat16
        if weights == "bf16":
            assert_within_bf16_ulp(jc["dense"][key], tc["dense"][key], key)
        else:
            assert_bits(jc["dense"][key], tc["dense"][key], key)


@pytest.mark.parametrize("tier", ["kv_fp8", "kv_mor"])
def test_decode_step_with_quantized_cache(model, quantized, tier):
    """A prefill chunk (8 tokens, per-row positions) then a decode step
    against an fp8 and a MoR cache: logits within TOL, every cache lane
    (payload bytes, tags, scales) bit for bit after each call."""
    jcfg, cfg, _, _ = model
    jq, tq = quantized
    jdec = jit_ref(jmake_decode_fn(jcfg, J_DOT))
    tdec = make_decode_fn(cfg, MoRDotPolicy())
    toks = make_tokens(jcfg)
    jc = jinit_cache(jcfg, 2, 32, **{tier: True})
    tc = init_cache(cfg, 2, 32, device="cpu", **{tier: True})
    rng = np.random.default_rng(6)
    for tok, cur in ((rng.integers(0, VOCAB, (2, 8)), np.array([7, 12])),
                     (rng.integers(0, VOCAB, (2, 1)), np.array([8, 13]))):
        lj, jc, _ = jdec(jq, toks, jc, jnp.asarray(tok, jnp.int32),
                         jnp.asarray(cur, jnp.int32))
        lt, tc, _ = tdec(tq, tc, torch.from_numpy(tok), torch.from_numpy(cur))
        np.testing.assert_allclose(lt.numpy()[..., :VOCAB],
                                   np.asarray(lj)[..., :VOCAB], atol=TOL,
                                   rtol=0)
        for key in jc["dense"]:
            assert_bits(jc["dense"][key], tc["dense"][key], key)
    if tier == "kv_mor":
        assert set(np.unique(tc["dense"]["k_tags"].numpy())) <= {
            TAG_E4M3, TAG_E5M2}
