"""The port's recurrent families against the JAX reference on the CPU:
reduced hymba-1.5b (hybrid: sliding-window attention beside the mamba
mixer in every layer; d 64, 4 / 2 heads, d_inner 128, state 8, window 8,
2 layers) and reduced xlstm-350m (ssm: 2 units of an mLSTM and an sLSTM
layer; d 64, 4 heads, tied head), with the JAX ``init_params`` draw
carried across by ``repro_torch.convert``. The reference runs on
``backend='xla'``, compiled with XLA's excess precision off
(``jit_ref``); the port runs its plain versions.

Tolerances, and why:
* activations (softplus, log_sigmoid, the f32 sigmoid and silu, tanh)
  within 4 ulps of XLA's on a sweep of f32 inputs whose results are
  normal (XLA's CPU compiler flushes f32 denormals); their derivatives
  (PyTorch's formulas, not JAX's) within 8 ulps of 1: XLA's exp, log1p,
  tanh and logistic are other implementations than PyTorch's, and the
  derivatives cancel (1 - s, 1 - t^2);
* ``chunked_scan``: bit for bit (the same additions in the same order),
  values and gradients, with and without remat;
* each mixer's output (bf16) within one bf16 ulp and at least 99% bit
  for bit; its f32 states within 2^-18 max|state| (a few ulps: the
  transcendental functions above, and the f32 contractions' summation
  order);
* logits: TOL = 2e-3 (``tests/test_torch_zoo.py``);
* each mixer's gradients alone (train mode, a 16-token input): the
  input's and the bf16 weights' bit for bit (the sLSTM's r, summed over
  the steps in f32, within a bf16 ulp), the f32 leaves' within 1e-6
  max|g| (f32 sums in another order);
* loss and grad norm: rtol 1e-5; gradients as ``tests/test_torch_zoo.py``
  holds them (bf16 within a bf16 ulp plus 1e-5 max|g|, at least 99.9%
  bit for bit; f32 within 1e-5 max|g|), but xLSTM's bf16 ones within a
  bf16 ulp plus 4e-3 max|g| (still 99.9% bit for bit) and its f32 ones
  within 1e-4 max|g|: the head's f32 backward sums in another order and
  flips a few bf16 roundings of the residual stream's gradient, which
  the mLSTM's exponential gating carries into the lower layers' weight
  gradients (seen: one element of w_qkv 2.4e-3 max|g| off, the mLSTM's
  ln1 scale 4.9e-5), while each mixer alone is bit for bit; forward
  stats rows: decisions,
  fractions and formats exact, the operand statistics rtol 1e-3
  (``tests/test_torch_frontends.py``); the step's stats metrics:
  fractions 1e-6, relative errors rtol 1e-5;
* the K/V lanes of a prefill: layer 0's bit for bit, the rest within a
  bf16 ulp (``tests/test_torch_frontends.py``); recurrent states within
  2^-18 max|state| (bf16 conv lanes within a bf16 ulp);
* after one AdamW step the f32 master within 1e-5;
* engines: token for token.
"""
import dataclasses
import sys
from pathlib import Path

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
from repro.models import common as jcommon
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit_params
from repro.models import make_decode_fn as jmake_decode_fn
from repro.models import make_prefill_fn as jmake_prefill_fn
from repro.models import make_tokens as jmake_tokens
from repro.models import recurrent as jR
from repro.models import transformer as jT
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import init_opt_state as jinit_opt_state
from repro.serve import Engine as JEngine
from repro.serve import PagedKVPool as JPool
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import quantized as jquantized
from repro.train import TrainConfig as JTrainConfig
from repro.train import make_train_step as jmake_train_step
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.core.policy import MoRDotPolicy, MoRPolicy, paper_default
from repro_torch.models import (cache_specs, init_cache, init_params,
                                make_decode_fn, make_prefill_fn)
from repro_torch.models import common as tcommon
from repro_torch.models import recurrent as tR
from repro_torch.models import transformer as tT
from repro_torch.models.api import make_tokens
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.serve import Engine, PagedKVPool, Request, ServeConfig
from repro_torch.serve.quantized import QTensor, quantize_params
from repro_torch.train import TrainConfig, make_train_step

sys.path.insert(0, str(Path(__file__).parent))
from test_serve_engine import _sequential_reference  # noqa: E402

NOEX = {"xla_allow_excess_precision": False}
TOL = 2e-3
HYMBA, XLSTM = "hymba-1.5b", "xlstm-350m"
ARCHS = (HYMBA, XLSTM)
J_DOT = JDotPolicy(act=JPolicy(backend="xla"), weight=JPolicy(backend="xla"),
                   grad=JPolicy(backend="xla"))
TIERS = ({}, {"kv_fp8": True}, {"kv_mor": True})
STATE_TOL = 2.0**-18
# Per layer type: (mixer, its params' subtree, its cache's subtree).
MIXERS = {"hymba": ("mamba_mix", "ssm", "ssm"),
          "mlstm": ("mlstm_mix", None, None),
          "slstm": ("slstm_mix", None, None)}


def jit_ref(fn, **kw):
    return jax.jit(fn, compiler_options=NOEX, **kw)


def jax_policy(recipe):
    pol = jpaper_default(recipe)
    return pol.replace(act=pol.act.replace(backend="xla"),
                       weight=pol.weight.replace(backend="xla"),
                       grad=pol.grad.replace(backend="xla"))


_MODELS = {}


def model(name):
    """(jcfg, cfg, jparams, tparams) of the reduced arch, drawn once."""
    if name not in _MODELS:
        jcfg = jreduced(jget_config(name))
        cfg = reduced(get_config(name))
        # Compiled: an order of magnitude faster than op by op here.
        jparams = jax.jit(lambda k: jinit_params(jcfg, k))(
            jax.random.PRNGKey(0))
        tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                                  device="cpu")
        _MODELS[name] = (jcfg, cfg, jparams, tparams)
    return _MODELS[name]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, name) if isinstance(v, dict) else {name: v})
    return out


def _jflat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(k.key) for k in path): leaf for path, leaf in flat}


def _layer(tree, l=0):
    return {k: _layer(v, l) if isinstance(v, dict) else v[l]
            for k, v in tree.items()}


def batch_of(cfg, seed, B=2, S=16, labels=True):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, S))}
    if labels:
        b["labels"] = rng.integers(0, cfg.vocab, (B, S))
    return b


def jbatch(b):
    return {k: jnp.asarray(v, jnp.int32) for k, v in b.items()}


def tbatch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def bits(a):
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16) if a.element_size() == 2 else a
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.itemsize == 2 else a


def _assert_logits(lt, lj, vocab):
    """Logits within TOL; the padded columns masked. No token of the
    model tests is decided by them (decode steps feed tokens drawn from a
    seed); the engines' greedy tokens are compared themselves."""
    lt, lj = lt.detach().numpy(), np.asarray(lj)
    np.testing.assert_allclose(lt[..., :vocab], lj[..., :vocab], atol=TOL,
                               rtol=0)
    assert (lt[..., vocab:] == -1e30).all()


def _bf16_close(t, j, what, share=0.99):
    """Two bf16 lanes within one bf16 ulp of each other, elementwise, and
    at least ``share`` of them bit for bit."""
    t = t.detach().float().numpy()
    j = np.asarray(j, np.float32)
    assert (np.abs(t - j) <= 2.0**-7 * np.abs(j) + 1e-30).all(), what
    assert (t == j).mean() >= share, (what, (t == j).mean())


def _state_close(t, j, what):
    """A state lane: f32 within STATE_TOL max|state|, bf16 within a bf16
    ulp."""
    if t.dtype == torch.bfloat16:
        _bf16_close(t, j, what, share=0.98)
        return
    t, j = t.detach().numpy(), np.asarray(j)
    assert t.dtype == j.dtype == np.float32, what
    err = np.abs(t - j).max()
    assert err <= STATE_TOL * max(np.abs(j).max(), 1e-30), (what, err)


# ------------------------------------------------------------- structure --
@pytest.mark.parametrize("name", ARCHS)
def test_configs_field_for_field(name):
    from repro import configs as jconfigs
    from repro_torch import configs as tconfigs
    j, t = jconfigs.get_config(name), tconfigs.get_config(name)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(tconfigs.reduced(t)) == \
        dataclasses.asdict(jconfigs.reduced(j))
    assert t.param_count() == j.param_count()
    assert t.n_units == j.n_units and t.mamba_d_inner == j.mamba_d_inner


@pytest.mark.parametrize("name", ARCHS)
def test_params_tokens_cache_specs_match_reference(name):
    """Key paths, shapes and dtypes of init_params (the mixers' f32
    leaves among them), make_tokens (hymba: 6 GEMMs a layer; mLSTM and
    sLSTM 3 each) and cache_specs: hymba's K/V lanes with the mamba state
    nested under ``ssm`` (bf16 tier only), xLSTM's f32 cells, the same on
    every tier (it has no K/V lanes); and init's constants (A_log =
    log(1..N) within an ulp: XLA's f32 log(7) is one ulp above the
    correctly rounded value PyTorch gives)."""
    jcfg, cfg, jparams, _ = model(name)
    tparams = init_params(cfg, seed=0, device="cpu")
    tp = _flat(tparams)
    jp = _jflat(jparams)
    assert sorted(tp) == sorted(jp)
    for k, leaf in jp.items():
        assert tuple(tp[k].shape) == leaf.shape, k
        assert str(tp[k].dtype).replace("torch.", "") == str(leaf.dtype), k
        last = k.rsplit("/", 1)[-1]
        if last in ("dt_bias", "D", "gate_bias", "out_norm"):
            assert np.array_equal(tp[k].numpy(), np.asarray(leaf)), k
        if last == "A_log":  # log(1..N): XLA's f32 log is 1 ulp off log 7
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(leaf),
                                       rtol=2.0**-23, atol=0)
    if name == HYMBA:
        assert "blocks/hymba/ssm/w_dt_up" in tp and \
            tp["blocks/hymba/ssm/w_bc"].dtype == torch.float32
    tt, jt = _flat(make_tokens(cfg, device="cpu")), _jflat(
        jmake_tokens(jcfg))
    assert sorted(tt) == sorted(jt)
    for k, leaf in jt.items():
        assert tuple(tt[k].shape) == leaf.shape and tt[k].requires_grad, k
    tiers = TIERS if name == XLSTM else TIERS[:1]
    for tier in tiers:
        ts = _flat(cache_specs(cfg, 3, 16, **tier))
        js = _jflat(jcache_specs(jcfg, 3, 16, **tier))
        assert sorted(ts) == sorted(js), tier
        for k, spec in js.items():
            assert ts[k] == (tuple(spec.shape), getattr(
                torch, str(spec.dtype))), (tier, k)
    if name == HYMBA:
        assert ts["hymba/ssm/h"][1] == torch.float32
        assert ts["hymba/ssm/conv"][1] == torch.bfloat16


def _ulps(a, b):
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return np.abs(ia - ib)


@pytest.mark.parametrize("fn", ("softplus", "log_sigmoid", "sigmoid",
                                "silu", "tanh"))
def test_activations_match_reference(fn):
    """The f32 activations of the mixers and their derivatives (PyTorch's
    formulas) against JAX's compiled: the values within 4 ulps where the
    result is a normal number, the derivatives within 8 ulps of 1;
    softplus / log_sigmoid also at +-Inf and NaN."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(0, 3, 20000), rng.normal(0, 30, 5000),
                        np.linspace(-60, 60, 4001)]).astype(np.float32)
    jf = {"softplus": jax.nn.softplus, "log_sigmoid": jax.nn.log_sigmoid,
          "sigmoid": jax.nn.sigmoid, "silu": jax.nn.silu,
          "tanh": jnp.tanh}[fn]
    tf = {"softplus": tR.softplus, "log_sigmoid": tR.log_sigmoid,
          "sigmoid": torch.sigmoid, "silu": tR.silu_f32,
          "tanh": torch.tanh}[fn]
    jv = np.asarray(jit_ref(jf)(x))
    jg = np.asarray(jit_ref(jax.grad(lambda v: jnp.sum(jf(v))))(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    tv = tf(tx)
    tv.sum().backward()
    tv, tg = tv.detach().numpy(), tx.grad.numpy()
    keep = np.abs(jv) >= np.finfo(np.float32).tiny
    assert keep.mean() > 0.7
    assert _ulps(tv[keep], jv[keep]).max() <= 4, fn
    # The derivatives (at most ~1.1) are formed from the values with
    # cancellation (1 - s, 1 - t^2) and other formulas than JAX's.
    assert np.abs(tg - jg).max() <= 8 * 2.0**-23, fn
    if fn in ("softplus", "log_sigmoid"):
        edge = np.array([np.inf, -np.inf, np.nan, 0.0, 25.0, -25.0],
                        np.float32)
        np.testing.assert_array_equal(
            tf(torch.from_numpy(edge)).numpy(), np.asarray(jf(edge)))


@pytest.mark.parametrize("length,chunk", [(16, 4), (67, 64), (128, 64)])
def test_chunked_scan_matches_reference(length, chunk):
    """``chunked_scan`` against the reference's (lax.scan in remat
    chunks): the carry and outputs, and the gradient of the outputs'
    weighted sum with respect to the inputs and the initial carry, bit
    for bit, with and without remat. A prime length above the chunk
    falls to chunks of one step, as there."""
    rng = np.random.default_rng(length)
    xs = rng.normal(size=(length, 3, 5)).astype(np.float32)
    h0 = rng.normal(size=(3, 5)).astype(np.float32)
    w = rng.normal(size=(length, 3, 5)).astype(np.float32)

    def jf(h, x):
        h = h * 0.5 + x
        return h, h - x

    def tf(carry, x):
        (h,), (x,) = carry, x
        h = h * 0.5 + x
        return (h,), h - x

    def jloss(h0, xs):
        h, ys = jcommon.chunked_scan(jf, h0, xs, length, chunk)
        return jnp.sum(ys * w) + jnp.sum(h), (h, ys)

    (_, (jh, jys)), jg = jit_ref(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(h0, xs)
    assert tcommon.pick_chunk(length, chunk) == (1 if length == 67 else
                                                 min(chunk, length))
    for remat in (False, True):
        th0 = torch.from_numpy(h0).requires_grad_(True)
        txs = torch.from_numpy(xs).requires_grad_(True)
        (th,), tys = tcommon.chunked_scan(tf, (th0,), (txs,), length, chunk,
                                          remat=remat)
        (torch.sum(tys * torch.from_numpy(w)) + torch.sum(th)).backward()
        for got, want in ((th, jh), (tys, jys), (th0.grad, jg[0]),
                          (txs.grad, jg[1])):
            assert np.array_equal(got.detach().numpy(), np.asarray(want))


def _state(cfg, t, seed):
    """A random cache of one layer of type ``t`` (B = 2): its f32 lanes
    ~ N(0, 1) (the sLSTM's normaliser n ~ 1 + |N(0, 1)|), hymba's conv
    lane bf16; numpy, so that each side gets its own copy."""
    spec = cache_specs(cfg, 2, 8)[t]
    sub = MIXERS[t][2]
    spec = spec[sub] if sub else spec
    rng = np.random.default_rng(seed)
    out = {}
    for k, (shape, _) in spec.items():
        v = rng.normal(size=shape[1:]).astype(np.float32)
        out[k] = 1 + np.abs(v) if (t, k) == ("slstm", "n") else v
    return out


@pytest.mark.parametrize("t,mode", [(t, m) for t in MIXERS
                                    for m in ("train", "prefill",
                                              "decode")])
def test_mixers_match_reference(t, mode):
    """Each mixer alone (layer 0's weights, the serving policy) on a
    67-token input (a prime length: chunks of one step), in train mode,
    in prefill mode from a random state and in decode mode (one token)
    from another: the output and every state lane; decode writes the new
    state into the cache it is given."""
    name = HYMBA if t == "hymba" else XLSTM
    jcfg, cfg, jparams, tparams = model(name)
    fn, sub, _ = MIXERS[t]
    jp, tp = _layer(jparams["blocks"][t]), _layer(tparams["blocks"][t])
    if sub:
        jp, tp = jp[sub], tp[sub]
    jtok = _layer(jmake_tokens(jcfg)["blocks"][t])
    S = 1 if mode == "decode" else 67
    x = np.random.default_rng(1).normal(size=(2, S, 64)).astype(np.float32)
    st = None if mode == "train" else _state(cfg, t, 2 + len(mode))
    bf = lambda k: k == "conv"  # noqa: E731
    jc = None if st is None else {
        k: jnp.asarray(v, jnp.bfloat16 if bf(k) else jnp.float32)
        for k, v in st.items()}
    tc = None if st is None else {
        k: torch.from_numpy(v.copy()).to(torch.bfloat16 if bf(k)
                                          else torch.float32)
        for k, v in st.items()}
    jout, jnc, _ = jit_ref(lambda p, xx, tok, c: getattr(jR, fn)(
        p, xx, tok, J_DOT, jcfg, mode, c))(
        jp, jnp.asarray(x, jnp.bfloat16), jtok, jc)
    tout, tnc, _ = getattr(tR, fn)(tp, torch.from_numpy(x).to(
        torch.bfloat16), None, MoRDotPolicy(), cfg, mode, tc)
    assert tuple(tout.shape) == jout.shape == (2, S, 64)
    _bf16_close(tout, jout, f"{t} {mode} output")
    if mode == "train":
        assert jnc is None and tnc is None
        return
    assert sorted(tnc) == sorted(jnc)
    for k in jnc:
        assert tnc[k].dtype == tc[k].dtype
        _state_close(tnc[k], jnc[k], f"{t} {mode} state {k}")
    if mode == "decode":
        assert all(tnc[k] is tc[k] for k in tc)


@pytest.mark.parametrize("t", tuple(MIXERS))
def test_mixer_gradients_match_reference(t):
    """Each mixer alone in train mode (layer 0's weights, the tensor
    recipe, a 16-token input, remat chunks of the scan): the gradients of
    a weighted sum of its output with respect to its input and every
    weight -- the input's and the bf16 weights' bit for bit (the sLSTM's
    recurrence r, read in f32 and its gradient summed over the steps in
    f32, within a bf16 ulp, 99% bit for bit), the f32 leaves' (the mamba
    mixer's conv taps, projections, dt bias, A and D; the mLSTM's gate
    bias; the out norms) within 1e-6 max|g|."""
    name = HYMBA if t == "hymba" else XLSTM
    jcfg, cfg, jparams, tparams = model(name)
    fn, sub, _ = MIXERS[t]
    jp, tp = _layer(jparams["blocks"][t]), _layer(tparams["blocks"][t])
    if sub:
        jp, tp = jp[sub], tp[sub]
    jp = {k: v for k, v in jp.items() if not isinstance(v, dict)}
    jtok = _layer(jmake_tokens(jcfg)["blocks"][t])
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 16, 64)).astype(np.float32)
    w = rng.normal(size=(2, 16, 64)).astype(np.float32)
    pol = jax_policy("tensor")

    def jloss(p, xx):
        out, _, _ = getattr(jR, fn)(p, xx, jtok, pol, jcfg, "train", None)
        return jnp.sum(out.astype(jnp.float32) * w)

    jgp, jgx = jit_ref(jax.grad(jloss, argnums=(0, 1)))(
        jp, jnp.asarray(x, jnp.bfloat16))
    tpp = {k: tp[k].detach().clone().requires_grad_(True) for k in jp}
    tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    out, _, _ = getattr(tR, fn)(tpp, tx, None, paper_default("tensor"), cfg,
                                "train", None)
    torch.sum(out.float() * torch.from_numpy(w)).backward()
    assert np.array_equal(bits(tx.grad), bits(jgx))
    for k, gj in jgp.items():
        g = tpp[k].grad
        assert g is not None and g.dtype == tpp[k].dtype, k
        if k == "r":  # summed over the steps in f32, then rounded to bf16
            _bf16_close(g, gj, k)
        elif g.dtype == torch.bfloat16:
            assert np.array_equal(bits(g), bits(gj)), k
        else:
            gj = np.asarray(gj)
            err = np.abs(g.numpy() - gj).max()
            assert err <= 1e-6 * np.abs(gj).max(), (k, err)


# ---------------------------------------------------------------- models --
@pytest.mark.parametrize("name", ARCHS)
def test_train_logits_match_reference(name):
    """Train-mode logits (hymba: sliding-window attention, window 8, over
    16 positions) and the forward stats rows of every GEMM: the
    decision, fraction, format and guard lanes exact, the operand
    statistics rtol 1e-3."""
    jcfg, cfg, jparams, tparams = model(name)
    b = batch_of(cfg, 1, labels=False)
    lj, _, sj = jit_ref(lambda p, t, bb: jT.forward(
        jcfg, jax_policy("tensor"), p, t, bb, mode="train", remat=False))(
        jparams, jmake_tokens(jcfg), jbatch(b))
    lt, cache, st = tT.forward(cfg, paper_default("tensor"), tparams,
                               tbatch(b), mode="train", remat=False)
    assert lt.shape == (2, 16, 512) and cache is None
    _assert_logits(lt, lj, cfg.vocab)
    rows_t, rows_j = _flat(st), _jflat(sj)
    assert sorted(rows_t) == sorted(rows_j)
    assert set(st["blocks"]) == set(cfg.unit)
    for k, rj in rows_j.items():
        rt, rj = rows_t[k].detach().numpy(), np.asarray(rj)
        assert rt.shape == rj.shape, k
        exact = [0, 3, 4, 5, 8, 9, 10, 11, 12, 13]
        close = [1, 2, 6, 7]
        assert np.array_equal(rt[..., exact], rj[..., exact]), k
        np.testing.assert_allclose(rt[..., close], rj[..., close],
                                   rtol=1e-3, err_msg=k)


def _capture(store):
    """A ``grad_fault`` hook that records the parameter gradients and
    passes them on unchanged (both packages)."""
    def hook(grads, batch):
        if isinstance(next(iter(_flat(grads).values())), torch.Tensor):
            store.append({k: v.detach().float().numpy()
                          for k, v in _flat(grads).items()})
        else:
            jax.debug.callback(lambda g: store.append(
                {k: np.asarray(v, np.float32) for k, v in
                 _jflat(g).items()}), grads)
        return grads
    return hook


@pytest.mark.parametrize("name", ARCHS)
def test_train_step_matches_reference(name):
    """One make_train_step step (AdamW, warmup_steps=1, remat on: the
    layers and, inside them, the scans' 64-step chunks) under the tensor
    recipe on 2 x 16 tokens: the loss, the stats metrics, the grad norm,
    every parameter's gradient (the mixers' f32 leaves among them) and
    the f32 master after the update."""
    jcfg, cfg, jparams, tparams = model(name)
    b = batch_of(cfg, 2)
    gj, gt = [], []
    jstep = jit_ref(jmake_train_step(jcfg, jax_policy("tensor"), JTrainConfig(
        optimizer=JAdamWConfig(warmup_steps=1)), grad_fault=_capture(gj)))
    _, jopt, jm = jstep(jparams, jinit_opt_state(jparams), jbatch(b))
    jax.effects_barrier()
    tstep = make_train_step(cfg, paper_default("tensor"), TrainConfig(
        optimizer=AdamWConfig(warmup_steps=1)), grad_fault=_capture(gt))
    _, topt, tm = tstep(tparams, init_opt_state(tparams), tbatch(b))
    for k in ("loss", "total_loss", "grad_norm", "fwd_rel_err",
              "bwd_rel_err"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-5), k
    for k in ("fwd_frac_bf16", "bwd_frac_bf16"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), abs=1e-6), k
    (gj,), (gt,) = gj, gt
    assert sorted(gt) == sorted(gj)
    tp = _flat(tparams)
    bf16_tol, f32_tol = (1e-5, 1e-5) if name == HYMBA else (4e-3, 1e-4)
    for k, g_ref in gj.items():
        g, scale = gt[k], np.abs(g_ref).max()
        err = np.abs(g - g_ref)
        assert scale > 0, k
        if tp[k].dtype == torch.bfloat16:
            assert (err <= 2.0**-7 * np.abs(g_ref) + bf16_tol * scale).all(), k
            assert (g == g_ref).mean() >= 0.999, k
        else:
            assert err.max() <= f32_tol * scale, (k, err.max(), scale)
    master = _flat(topt.master)
    for k, leaf in _jflat(jopt.master).items():
        err = np.abs(np.asarray(leaf) - master[k].numpy()).max()
        assert err <= 1e-5, (k, err)


# --------------------------------------------------------------- serving --
_JITS = {}


def jfn(kind, name):
    if (kind, name) not in _JITS:
        make = jmake_prefill_fn if kind == "prefill" else jmake_decode_fn
        _JITS[kind, name] = jit_ref(make(model(name)[0], J_DOT))
    return _JITS[kind, name]


def _decode_cache(cfg, jcfg, jpc, tpc, P, T):
    """Both packages' bf16 decode caches of T positions holding the
    prefill's P K/V positions and its final recurrent state."""
    jc = jinit_cache(jcfg, 2, T)
    tc = init_cache(cfg, 2, T, device="cpu")
    jflat, tflat = _jflat(jc), _flat(tc)
    jnew = {}
    for k, leaf in _jflat(jpc).items():
        if k.rsplit("/", 1)[-1] in ("k", "v"):
            jnew[k] = jflat[k].at[:, :, :P].set(leaf)
            tflat[k][:, :, :P] = _flat(tpc)[k]
        else:
            jnew[k] = leaf
            tflat[k].copy_(_flat(tpc)[k])
    paths, treedef = jax.tree_util.tree_flatten_with_path(jc)
    jc = jax.tree_util.tree_unflatten(treedef, [
        jnew["/".join(str(p.key) for p in path)] for path, _ in paths])
    return jc, tc


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_and_decode_match_reference(name):
    """make_prefill_fn on a 12-token prompt (past hymba's window of 8),
    its K/V lanes and final states, then three decode steps from a
    32-position cache holding them at per-row positions (row 1 one
    position further, over a zero key): logits, and every lane the steps
    wrote (the recurrent state replaced in place)."""
    jcfg, cfg, jparams, tparams = model(name)
    b = batch_of(cfg, 3, S=12, labels=False)
    lj, jpc, _ = jfn("prefill", name)(jparams, jmake_tokens(jcfg),
                                     jbatch(b))
    lt, tpc, _ = make_prefill_fn(cfg, MoRDotPolicy())(tparams, tbatch(b))
    _assert_logits(lt, lj, cfg.vocab)
    tflat, jflat = _flat(tpc), _jflat(jpc)
    assert sorted(tflat) == sorted(jflat)
    for k, leaf in tflat.items():
        assert tuple(leaf.shape) == jflat[k].shape, k
        if k.rsplit("/", 1)[-1] in ("k", "v"):
            assert np.array_equal(bits(leaf[0]), bits(jflat[k][0])), k
            _bf16_close(leaf, jflat[k], k)
        else:
            _state_close(leaf, jflat[k], k)
    jc, tc = _decode_cache(cfg, jcfg, jpc, tpc, 12, 32)
    lanes = dict(_flat(tc))
    rng = np.random.default_rng(4)
    for cur in ([12, 13], [13, 14], [14, 15]):
        tok = rng.integers(0, cfg.vocab, (2, 1))
        lj, jc, _ = jfn("decode", name)(
            jparams, jmake_tokens(jcfg), jc, jnp.asarray(tok, jnp.int32),
            jnp.asarray(cur, jnp.int32))
        lt, tc, _ = make_decode_fn(cfg, MoRDotPolicy())(
            tparams, tc, torch.from_numpy(tok), torch.tensor(cur))
        _assert_logits(lt, lj, cfg.vocab)
    for k, leaf in _flat(tc).items():
        assert leaf is lanes[k], k  # updated in place
        if k.rsplit("/", 1)[-1] in ("k", "v"):
            _bf16_close(leaf, _jflat(jc)[k], k)
        else:
            _state_close(leaf, _jflat(jc)[k], k)


def _prompts(cfg):
    rng = np.random.default_rng(2)
    return [rng.integers(0, cfg.vocab, L).astype(np.int32) for L in (4, 13)]


def _serve(E, R, SC, cfg, params, pol, **kw):
    """An engine (2 slots, max_seq 32, pages of 8) on prompts of 4 and 13
    tokens, 6 greedy tokens each, the second submitted once the first
    decodes (so it is admitted into a slot whose state a ride-along
    decode step wrote); the reference's step and prefill compiled with
    ``jit_ref``. Returns (engine, requests)."""
    eng = E(cfg, pol, params, SC(slots=2, max_seq=32, page_size=8,
                                 prefill_chunk=8), **kw)
    if E is JEngine:
        eng._step_fn = jit_ref(eng._step_fn.__wrapped__, donate_argnums=(2,))
        eng._prefill = jit_ref(jmake_prefill_fn(cfg, pol))
    reqs = [R(i, q, max_tokens=6) for i, q in enumerate(_prompts(cfg))]
    eng.submit(reqs[0])
    eng.step()
    eng.submit(reqs[1])
    eng.run_to_completion()
    for r in reqs:
        assert r.done and r.error is None and len(r.out) == 6
    return eng, reqs


@pytest.mark.parametrize("name", ARCHS)
def test_engine_matches_sequential_reference(name):
    """The port's Engine token for token against
    ``tests/test_serve_engine.py``'s sequential reference (one request at
    a time through the reference's prefill and decode functions, no
    engine code): one-shot prefill (the cache is not all paged), the
    pool's state leaves slot-dense, bytes per token, key order and state
    bytes as the reference's pool; admission splices fresh state over
    the state a ride-along decode step wrote into the idle slot."""
    jcfg, cfg, jparams, tparams = model(name)
    teng, treqs = _serve(Engine, Request, ServeConfig, cfg, tparams,
                         MoRDotPolicy(), device="cpu")
    jpool = JPool(jcfg, 2, 32, page_size=8)
    assert teng.chunked_prefill is False
    assert teng.pool.has_paged is jpool.has_paged is (name == HYMBA)
    assert teng.pool.bytes_per_token() == jpool.bytes_per_token()
    assert list(jpool._keys) == [k for k, _ in teng.pool._by_key()]
    state = sum(l[:, 0].nbytes for l, pg in zip(jpool._leaves,
                                                jpool._paged) if not pg)
    assert teng.pool.state_bytes_per_slot() == state > 0
    for r, p in zip(treqs, _prompts(cfg)):
        assert r.out == _sequential_reference(jcfg, jparams, p, 6, 32)


@pytest.mark.parametrize("name", ARCHS)
def test_quantized_engine_matches_reference(name):
    """Both packages' trees quantized with sub3 at min_size 4096, where
    the reference runs: every GEMM weight quantized (hymba's untied head
    too), the mixers' plain leaves dense on both sides, the same
    quantized set; then the port's Engine against the reference's, token
    for token."""
    jcfg, cfg, jparams, tparams = model(name)
    qfg = jquantized.quantize_for_gemm
    jquantized.quantize_for_gemm = jit_ref(qfg, static_argnums=1)
    try:
        jq, jst = jquantized.quantize_params(
            jparams, JPolicy(recipe="sub3", backend="xla"), min_size=4096)
    finally:
        jquantized.quantize_for_gemm = qfg
    tq, tst = quantize_params(tparams, MoRPolicy(recipe="sub3"),
                              min_size=4096)
    assert sorted(tst) == sorted(jst)
    want = ({"lm_head"} | {f"blocks/hymba/{w}" for w in (
        "wqkv", "wo", "mlp/wi", "mlp/wo", "ssm/w_in", "ssm/w_out")}
        if name == HYMBA else {f"blocks/{w}" for w in (
            "mlstm/w_up", "mlstm/w_qkv", "mlstm/w_down", "slstm/w_x",
            "slstm/w_ff1", "slstm/w_ff2")})
    assert set(tst) == want
    jeng, jreqs = _serve(JEngine, JRequest, JServeConfig, jcfg, jq, J_DOT)
    teng, treqs = _serve(Engine, Request, ServeConfig, cfg, tq,
                         MoRDotPolicy(), device="cpu")
    assert teng.chunked_prefill is jeng.chunked_prefill is False
    for rj, rt in zip(jreqs, treqs):
        assert rt.out == rj.out, (rt.rid, rt.out, rj.out)


@pytest.mark.parametrize("min_size,error,match", [
    (0, ValueError, "different leading axis sizes"),
    (1024, AttributeError, "astype")])
def test_hymba_quantized_small_min_size_keeps_the_mixer_leaves(
        min_size, error, match):
    """Below the default min_size the reference also quantizes the mamba
    mixer's plain leaves. At 0: all seven (conv_w, w_bc, w_dt_down,
    w_dt_up, dt_bias, A_log, D), and the 2-D stacks dt_bias and D are
    taken for single matrices, whose lanes have no layer axis, so its
    layer scan fails before reaching the mixer. At 1024 (w_bc and A_log
    quantized, the rest dense): its mamba_mix fails on w_bc (a QTensor
    has no ``astype``). The port keeps those leaves dense and serves, and its
    quantized set is the reference's GEMM weights."""
    jcfg, cfg, jparams, tparams = model(HYMBA)
    qfg = jquantized.quantize_for_gemm
    jquantized.quantize_for_gemm = jit_ref(qfg, static_argnums=1)
    try:
        jq, jst = jquantized.quantize_params(
            jparams, JPolicy(recipe="sub3", backend="xla"),
            min_size=min_size)
    finally:
        jquantized.quantize_for_gemm = qfg
    mixer = {f"blocks/hymba/ssm/{w}" for w in (
        "conv_w", "w_bc", "w_dt_down", "w_dt_up", "dt_bias", "A_log", "D")}
    if min_size:
        mixer = {"blocks/hymba/ssm/w_bc", "blocks/hymba/ssm/A_log"}
    assert mixer <= set(jst)
    b = batch_of(cfg, 7, S=8, labels=False)
    with pytest.raises(error, match=match):
        jmake_prefill_fn(jcfg, J_DOT)(jq, jmake_tokens(jcfg), jbatch(b))
    tq, tst = quantize_params(tparams, MoRPolicy(recipe="sub3"),
                              min_size=min_size)
    assert set(tst) == set(jst) - mixer
    ssm = tq["blocks"]["hymba"]["ssm"]
    assert isinstance(ssm["w_in"], QTensor)
    assert not any(isinstance(v, QTensor) for k, v in ssm.items()
                   if k not in ("w_in", "w_out"))
    eng = Engine(cfg, MoRDotPolicy(), tq, ServeConfig(
        slots=2, max_seq=32, page_size=8, prefill_chunk=8), device="cpu")
    r = Request(0, b["tokens"][0].astype(np.int32), max_tokens=4)
    eng.submit(r)
    eng.run_to_completion()
    assert r.done and r.error is None and len(r.out) == 4


@pytest.mark.parametrize("tier", ("kv_fp8", "kv_mor"))
def test_hymba_refuses_quantized_kv_tiers(tier):
    """The reference's ``_hymba_block`` hands ``attn_sublayer`` only the
    cache's k / v: on a kv_fp8 or kv_mor cache its decode step returns a
    cache without the scale and tag lanes. The port refuses those tiers
    for the hybrid family by name (cache_specs, init_cache, the pool and
    a decode call)."""
    jcfg, cfg, jparams, tparams = model(HYMBA)
    jc = jinit_cache(jcfg, 2, 32, **{tier: True})
    assert "k_scale" in jc["hymba"]
    _, out, _ = jfn("decode", HYMBA)(
        jparams, jmake_tokens(jcfg), jc, jnp.zeros((2, 1), jnp.int32),
        jnp.asarray([3, 4], jnp.int32))
    assert sorted(out["hymba"]) == ["k", "ssm", "v"]
    for call in (lambda: cache_specs(cfg, 2, 32, **{tier: True}),
                 lambda: init_cache(cfg, 2, 32, device="cpu",
                                    **{tier: True}),
                 lambda: PagedKVPool(cfg, 2, 32, page_size=8, device="cpu",
                                     **{tier: True})):
        with pytest.raises(ValueError, match=f"{tier}.*'hybrid'"):
            call()
    tc = init_cache(cfg, 2, 32, device="cpu")
    tc["hymba"]["k_scale"] = torch.zeros(tc["hymba"]["k"].shape[:-1])
    if tier == "kv_mor":
        tc["hymba"]["k_tags"] = torch.zeros(tc["hymba"]["k"].shape[:-1],
                                            dtype=torch.uint8)
    with pytest.raises(ValueError, match=f"{tier}.*_hymba_block"):
        make_decode_fn(cfg, MoRDotPolicy())(
            tparams, tc, torch.zeros((2, 1), dtype=torch.int64),
            torch.tensor([3, 4]))


@pytest.mark.parametrize("tier", ("kv_fp8", "kv_mor"))
def test_xlstm_kv_tiers_change_nothing(tier):
    """xLSTM has no K/V lanes: under kv_fp8 / kv_mor its cache and pool
    are the bf16 tier's (state alone, 0 bytes per token, nothing to
    census), as the reference's, and its engine serves the bf16 tier's
    tokens."""
    jcfg, cfg, jparams, tparams = model(XLSTM)
    jp = JPool(jcfg, 2, 32, page_size=8, **{tier: True})
    tp = PagedKVPool(cfg, 2, 32, page_size=8, device="cpu", **{tier: True})
    assert tp.bytes_per_token() == jp.bytes_per_token() == 0
    assert not tp.has_paged and not jp.has_paged
    assert _flat(cache_specs(cfg, 2, 32, **{tier: True})) == _flat(
        cache_specs(cfg, 2, 32))
    outs = []
    for kw in ({}, {tier: True}):
        eng = Engine(cfg, MoRDotPolicy(), tparams, ServeConfig(
            slots=2, max_seq=32, page_size=8, prefill_chunk=8, **kw),
            device="cpu")
        r = Request(0, np.arange(5, dtype=np.int32), max_tokens=4)
        eng.submit(r)
        eng.run_to_completion()
        assert r.done and r.error is None
        outs.append(r.out)
        assert eng.pool._kv_lane_groups() == []
    assert outs[0] == outs[1]
