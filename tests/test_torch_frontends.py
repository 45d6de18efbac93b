"""The port's frontend families against the JAX reference on the CPU:
reduced paligemma-3b (vlm: a gemma backbone behind 8 stub patch
embeddings that attend bidirectionally; d 64, one KV head, geglu, tied
head) and reduced whisper-tiny (audio: 2 encoder layers over 16 stub
frames, 2 decoder layers with cross-attention, layer norm, sinusoidal
positions; d 64, 4 / 2 heads, gelu, tied head), with the JAX
``init_params`` draw carried across by ``repro_torch.convert``. The
reference runs on ``backend='xla'``, compiled with XLA's excess
precision off (``jit_ref``); the port runs its plain versions.

The reference's init zeroes every layer norm's scale and bias, which
makes every normed stream of whisper zero (and its logits constant), so
whisper's norm scales and biases are drawn from a numpy seed on both
sides (``model``).

Tolerances, and why:
* sinusoidal positions: within 2 ulps of each angle (f32), plus 2^-22:
  XLA compiles pos / 10000^(2i/d) and its sin / cos in other
  instructions than PyTorch (its eager and compiled values differ from
  each other by as much); the port's positions and its per-position
  form agree bit for bit;
* logits: TOL = 2e-3 (``tests/test_torch_zoo.py``); no token is
  decided by them (decode steps take tokens drawn from a seed);
* loss and grad norm: rtol 1e-5; gradients as ``tests/test_torch_zoo.py``
  holds them (the bf16 ones within a bf16 ulp plus 1e-5 max|g|, at
  least 99.9% bit for bit; the f32 ones within 1e-5 max|g|); forward
  stats rows: decisions, fractions and formats exact, the operand
  statistics rtol 1e-3 (``test_train_logits_match_reference``); the step's
  stats metrics: fractions 1e-6, ``fwd_rel_err`` rtol 1e-5,
  ``bwd_rel_err`` rtol 5e-3 (``test_train_step_matches_reference``
  says why);
* cache lanes: bit for bit, or within one bf16 ulp where the f32
  attention's last bits reach them (stated per lane);
* after one AdamW step the f32 master within 1e-5.
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
from repro.models import make_decode_fn as jmake_decode_fn
from repro.models import make_prefill_fn as jmake_prefill_fn
from repro.models import make_tokens as jmake_tokens
from repro.models import attention as jattention
from repro.models import common as jcommon
from repro.models import init_params as jinit_params
from repro.models import transformer as jT
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import init_opt_state as jinit_opt_state
from repro.serve import quantized as jquantized
from repro.train import TrainConfig as JTrainConfig
from repro.train import make_train_step as jmake_train_step
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.core.policy import MoRDotPolicy, MoRPolicy, paper_default
from repro_torch.models import (cache_specs, init_cache, init_params,
                                make_decode_fn, make_prefill_fn)
from repro_torch.models import attention as tattention
from repro_torch.models import common as tcommon
from repro_torch.models import transformer as tT
from repro_torch.models.api import make_tokens
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.serve.quantized import QTensor, quantize_params
from repro_torch.train import TrainConfig, make_train_step
from repro_torch.train import train_step as ttrain_step

NOEX = {"xla_allow_excess_precision": False}
TOL = 2e-3
PALI, WHISPER = "paligemma-3b", "whisper-tiny"
ARCHS = (PALI, WHISPER)
J_DOT = JDotPolicy(act=JPolicy(backend="xla"), weight=JPolicy(backend="xla"),
                   grad=JPolicy(backend="xla"))
TIERS = ({}, {"kv_fp8": True}, {"kv_mor": True})


def jit_ref(fn, **kw):
    return jax.jit(fn, compiler_options=NOEX, **kw)


def jax_policy(recipe):
    pol = jpaper_default(recipe)
    return pol.replace(act=pol.act.replace(backend="xla"),
                       weight=pol.weight.replace(backend="xla"),
                       grad=pol.grad.replace(backend="xla"))


def _draw_norms(jcfg, jparams):
    """Layer-norm scales ~ 1 + N(0, 0.2) and biases ~ N(0, 0.5) from a
    numpy seed (the reference's init zeroes both); RMS-norm trees are
    left as drawn."""
    if jcfg.norm != "ln":
        return jparams
    rng = np.random.default_rng(11)

    def draw(path, leaf):
        keys = [str(k.key) for k in path]
        if keys[-1] == "scale":
            return jnp.asarray(1.0 + rng.normal(0, 0.2, leaf.shape),
                               leaf.dtype)
        if keys[-1] == "bias":
            return jnp.asarray(rng.normal(0, 0.5, leaf.shape), leaf.dtype)
        return leaf
    return jax.tree_util.tree_map_with_path(draw, jparams)


_MODELS = {}


def model(name):
    """(jcfg, cfg, jparams, tparams) of the reduced arch, drawn once."""
    if name not in _MODELS:
        jcfg = jreduced(jget_config(name))
        cfg = reduced(get_config(name))
        jparams = _draw_norms(jcfg, jinit_params(jcfg, jax.random.PRNGKey(0)))
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


def batch_of(cfg, seed, B=2, S=16, labels=True):
    """numpy inputs: tokens (and labels), and the frontend's stub
    embeddings ~ N(0, 1) as f32 (each side casts them to bf16 alike)."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, S))}
    if labels:
        b["labels"] = rng.integers(0, cfg.vocab, (B, S))
    if cfg.family == "vlm":
        b["patches"] = rng.normal(size=(B, cfg.img_tokens, cfg.d_model))
    if cfg.family == "audio":
        b["frames"] = rng.normal(size=(B, cfg.enc_seq, cfg.d_model))
    return b


def jbatch(b):
    return {k: jnp.asarray(v, jnp.int32 if v.dtype.kind == "i"
                           else jnp.bfloat16) for k, v in b.items()}


def tbatch(b):
    return {k: torch.from_numpy(v) if v.dtype.kind == "i" else
            torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16)
            for k, v in b.items()}


def bits(a):
    """An integer view of a JAX or torch lane for exact comparison."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16) if a.element_size() == 2 else (
            a.view(torch.uint8) if a.element_size() == 1 else a)
        return a.numpy()
    a = np.asarray(a)
    return a.view({2: np.int16, 1: np.uint8}.get(a.dtype.itemsize,
                                                   a.dtype))


def _assert_logits(lt, lj, vocab):
    """Logits within TOL; the padded columns masked. No token of these
    tests is decided by the logits (decode steps feed tokens drawn from
    a seed), so a near-tie decides nothing."""
    lt, lj = lt.detach().numpy(), np.asarray(lj)
    np.testing.assert_allclose(lt[..., :vocab], lj[..., :vocab], atol=TOL,
                               rtol=0)
    assert (lt[..., vocab:] == -1e30).all()


def _bf16_close(t, j, what):
    """Two bf16 lanes within one bf16 ulp of each other element by
    element (the f32 attention's last bits reach them through the
    layers), at least 99% bit for bit."""
    t = t.float().numpy()
    j = np.asarray(j, np.float32)
    assert (np.abs(t - j) <= 2.0**-7 * np.abs(j) + 1e-30).all(), what
    assert (t == j).mean() >= 0.99, (what, (t == j).mean())


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


@pytest.mark.parametrize("name", ARCHS)
def test_params_tokens_cache_specs_match_reference(name):
    """Key paths, shapes and dtypes of init_params (whisper's 'enc'
    subtree, the wdec layer's x* weights, every layer norm's bias),
    make_tokens (whisper's 'enc' tokens, 7 GEMMs a wdec layer) and
    cache_specs on every tier the port serves (whisper: bf16 only)."""
    jcfg, cfg, jparams, _ = model(name)
    tp = _flat(init_params(cfg, seed=0, device="cpu"))
    jp = _jflat(jparams)
    assert sorted(tp) == sorted(jp)
    for k, leaf in jp.items():
        assert tuple(tp[k].shape) == leaf.shape, k
        assert str(tp[k].dtype).replace("torch.", "") == str(leaf.dtype), k
    if name == WHISPER:
        assert "enc/blocks/wqkv" in tp and "blocks/wdec/xwkv" in tp
        assert "blocks/wdec/lnx/bias" in tp and "enc/final_norm/bias" in tp
    tt, jt = _flat(make_tokens(cfg, device="cpu")), _jflat(
        jmake_tokens(jcfg))
    assert sorted(tt) == sorted(jt)
    for k, leaf in jt.items():
        assert tuple(tt[k].shape) == leaf.shape and tt[k].requires_grad, k
    tiers = TIERS if name == PALI else TIERS[:1]
    for tier in tiers:
        ts = _flat(cache_specs(cfg, 3, 16, **tier))
        js = _jflat(jcache_specs(jcfg, 3, 16, **tier))
        assert sorted(ts) == sorted(js), tier
        for k, spec in js.items():
            assert ts[k] == (tuple(spec.shape), getattr(
                torch, str(spec.dtype))), (tier, k)


@pytest.mark.parametrize("seq,d", [(16, 64), (1500, 384)])
def test_sinusoidal_positions_match_reference(seq, d):
    """``sinusoidal_positions`` against the reference compiled, within 2
    ulps of each angle plus 2^-22; ``sinusoidal_at`` at every position
    (and at a per-row (B, S) index) equals the positions' rows bit for
    bit, and the reference's vmapped ``_sinusoidal_at`` within the same
    bound."""
    j = np.asarray(jit_ref(lambda: jcommon.sinusoidal_positions(seq, d))())
    t = tcommon.sinusoidal_positions(seq, d).numpy()
    assert t.shape == j.shape == (seq, d) and t.dtype == np.float32
    ang = np.arange(seq, dtype=np.float32)[:, None]
    tol = 2 * np.spacing(np.maximum(ang, 1.0)) + 2.0**-22
    assert (np.abs(t - j) <= tol).all(), np.abs(t - j).max()
    idx = np.arange(seq)
    at = tcommon.sinusoidal_at(torch.from_numpy(idx), d).numpy()
    assert np.array_equal(at, t)
    rows = np.stack([idx[::-1], idx])[:, :8]
    at2 = tcommon.sinusoidal_at(torch.from_numpy(rows), d).numpy()
    assert at2.shape == (2, 8, d) and np.array_equal(at2, t[rows])
    ja = np.asarray(jit_ref(lambda i: jax.vmap(
        lambda k: jT._sinusoidal_at(k, d))(i))(idx.astype(np.int32)))
    assert (np.abs(at - ja) <= tol).all()


# ---------------------------------------------------------------- models --
@pytest.mark.parametrize("name", ARCHS)
def test_train_logits_match_reference(name):
    """Train-mode logits: paligemma's (img_tokens + S positions, the
    embedding scaled by sqrt(d), the prefix mask), whisper's (the encoder
    under the full mask, cross-attention, sinusoidal positions); and the
    forward stats rows of every GEMM, whisper's 'enc' ones included: the
    decision, fraction, format and guard lanes exact; the others (mean
    relative error, amax, nonzero share, group mantissa) rtol 1e-3, since
    the f32 attention's last bits flip a few bf16 roundings of the
    operands after it (seen: 8e-5 on a proj GEMM's relative error)."""
    jcfg, cfg, jparams, tparams = model(name)
    b = batch_of(cfg, 1, labels=False)
    lj, _, sj = jit_ref(lambda p, t, bb: jT.forward(
        jcfg, jax_policy("tensor"), p, t, bb, mode="train", remat=False))(
        jparams, jmake_tokens(jcfg), jbatch(b))
    lt, cache, st = tT.forward(cfg, paper_default("tensor"), tparams,
                               tbatch(b), mode="train", remat=False)
    extra = cfg.img_tokens if name == PALI else 0
    assert lt.shape == (2, 16 + extra, 512) and cache is None
    _assert_logits(lt, lj, cfg.vocab)
    rows_t, rows_j = _flat(st), _jflat(sj)
    assert sorted(rows_t) == sorted(rows_j)
    if name == WHISPER:
        assert set(st) == {"blocks", "enc"}
        assert set(st["blocks"]["wdec"]) == set(tT._WDEC_NAMES)
        assert st["enc"]["dense"]["qkv"].shape[0] == cfg.enc_layers
    for k, rj in rows_j.items():
        rt, rj = rows_t[k].detach().numpy(), np.asarray(rj)
        assert rt.shape == rj.shape, k
        assert (rt[..., 0] >= 0).all(), k  # every event enabled
        exact = [0, 3, 4, 5, 8, 9, 10, 11, 12, 13]
        close = [1, 2, 6, 7]
        assert np.array_equal(rt[..., exact], rj[..., exact]), k
        np.testing.assert_allclose(rt[..., close], rj[..., close],
                                   rtol=1e-3, err_msg=k)


def _capture(store):
    """A ``grad_fault`` hook that records the (accumulated) parameter
    gradients and passes them on unchanged (both packages)."""
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
    """One make_train_step step (AdamW, warmup_steps=1, remat on) under
    the tensor recipe: the loss (paligemma's over the text positions
    only), the stats metrics (whisper's encoder rows and tokens among
    them), the grad norm, every parameter's gradient (read through a
    ``grad_fault`` hook that passes them on) and the f32 master after
    the update.

    ``bwd_rel_err`` is held to rtol 5e-3: the reference's softmax
    gradient cancels exactly where two keys of a query's row coincide in
    a bf16 component, and the port's (autograd through the same online
    softmax) leaves a residue ~1e-11 of the operand's amax there, which
    counts as a nonzero element whose quantization error is total. On
    this batch 6 elements of whisper's two decoder dqkv operands (4,096
    elements each) do so (dq at position 1, whose two keys' components
    are equal), and ``bwd_rel_err`` moves 0.14%."""
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
    for k in ("loss", "total_loss", "grad_norm", "fwd_rel_err"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-5), k
    for k in ("fwd_frac_bf16", "bwd_frac_bf16"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), abs=1e-6), k
    assert float(tm["bwd_rel_err"]) == pytest.approx(
        float(jm["bwd_rel_err"]), rel=5e-3)
    assert float(tm["aux_loss"]) == 0.0
    (gj,), (gt,) = gj, gt
    assert sorted(gt) == sorted(gj)
    tp = _flat(tparams)
    for k, g_ref in gj.items():
        g, scale = gt[k], np.abs(g_ref).max()
        err = np.abs(g - g_ref)
        assert scale > 0, k
        if tp[k].dtype == torch.bfloat16:
            assert (err <= 2.0**-7 * np.abs(g_ref) + 1e-5 * scale).all(), k
            assert (g == g_ref).mean() >= 0.999, k
        else:
            assert err.max() <= 1e-5 * scale, (k, err.max(), scale)
    master = _flat(topt.master)
    for k, leaf in _jflat(jopt.master).items():
        err = np.abs(np.asarray(leaf) - master[k].numpy()).max()
        assert err <= 1e-5, (k, err)


@pytest.mark.parametrize("name", ARCHS)
def test_grad_accum_splits_the_frontend_inputs(name):
    """grad_accum=2 against 1 on a batch of four equal rows (the
    reference's stats contract, ``tests/test_stats_contract.py``): the
    step splits 'patches' / 'frames' with the tokens (each microbatch
    sees two rows of each) and reports the same loss and stats."""
    _, cfg, _, tparams = model(name)
    one = batch_of(cfg, 5, B=1)
    b = tbatch({k: np.repeat(v, 4, axis=0) for k, v in one.items()})
    frontend = "patches" if name == PALI else "frames"
    seen = []
    split = ttrain_step._split

    def spy(batch, n, i):
        out = split(batch, n, i)
        seen.append({k: tuple(v.shape) for k, v in out.items()})
        return out

    metrics = []
    for accum in (1, 2):
        step = make_train_step(cfg, paper_default("sub3"), TrainConfig(
            optimizer=AdamWConfig(warmup_steps=1), grad_accum=accum))
        ttrain_step._split = spy
        try:
            metrics.append(step(tparams, init_opt_state(tparams), b)[2])
        finally:
            ttrain_step._split = split
    assert len(seen) == 2
    for shapes in seen:
        assert shapes[frontend][0] == 2 and shapes["tokens"][0] == 2
        assert shapes[frontend][1:] == tuple(b[frontend].shape[1:])
    for key in ("fwd_frac_bf16", "fwd_rel_err", "bwd_frac_bf16",
                "bwd_rel_err", "loss"):
        a, c = float(metrics[0][key]), float(metrics[1][key])
        assert a == pytest.approx(c, rel=1e-5, abs=1e-6), (key, a, c)


# --------------------------------------------------------------- serving --
_JITS = {}


def jfn(kind, name):
    """The reference's prefill or decode function, compiled once per
    arch (jax.jit retraces per argument structure)."""
    if (kind, name) not in _JITS:
        make = jmake_prefill_fn if kind == "prefill" else jmake_decode_fn
        _JITS[kind, name] = jit_ref(make(model(name)[0], J_DOT))
    return _JITS[kind, name]


def _prefill_both(name, jparams, tparams, b):
    jcfg, cfg, _, _ = model(name)
    lj, jpc, _ = jfn("prefill", name)(jparams, jmake_tokens(jcfg),
                                     jbatch(b))
    lt, tpc, st = make_prefill_fn(cfg, MoRDotPolicy())(tparams, tbatch(b))
    return lj, jpc, lt, tpc, st


def _decode_cache(cfg, jcfg, jpc, tpc, P, T, tier):
    """Both packages' decode caches of T positions holding the prefill's
    P positions: bf16 lanes copied; a quantized tier's lanes written by
    each package's own quantizer from the prefill's bf16 K/V, layer by
    layer (as the engine's splice does)."""
    t = "dense" if "dense" in tpc else "wdec"
    jc = jinit_cache(jcfg, 2, T, **tier)
    tc = init_cache(cfg, 2, T, device="cpu", **tier)
    jl, tl = dict(jc[t]), tc[t]
    for name in ("k", "v"):
        if not tier:
            jl[name] = jl[name].at[:, :, :P].set(jpc[t][name])
            tl[name][:, :, :P] = tpc[t][name]
            continue
        for l in range(cfg.n_units):
            if tier.get("kv_mor"):
                pay, tags, sc = jattention.quantize_kv_mor(jpc[t][name][l])
                tpay, ttags, tsc = tattention.quantize_kv_mor(
                    tpc[t][name][l])
                lanes = {"": (pay, tpay), "_tags": (tags, ttags),
                         "_scale": (sc, tsc)}
            else:
                pay, sc = jattention.quantize_kv(jpc[t][name][l])
                tpay, tsc = tattention.quantize_kv(tpc[t][name][l])
                lanes = {"": (pay, tpay), "_scale": (sc, tsc)}
            for suf, (jv, tv) in lanes.items():
                jl[name + suf] = jl[name + suf].at[l, :, :P].set(jv)
                tl[name + suf][l, :, :P] = tv
    for name in ("xk", "xv"):
        if name in tl:
            jl[name] = jpc[t][name]
            tl[name].copy_(tpc[t][name])
    return {t: jl}, tc


def _decode_both(name, jparams, tparams, jc, tc, tok, cur):
    jcfg, cfg, _, _ = model(name)
    lj, jc, _ = jfn("decode", name)(
        jparams, jmake_tokens(jcfg), jc, jnp.asarray(tok, jnp.int32),
        jnp.asarray(cur, jnp.int32))
    lt, tc, st = make_decode_fn(cfg, MoRDotPolicy())(
        tparams, tc, torch.from_numpy(tok), torch.tensor(cur))
    return lj, jc, lt, tc, st


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_and_decode_match_reference(name):
    """make_prefill_fn on a 12-token prompt (paligemma: behind its 8
    patches, 20 cached positions), the cache's lanes (whisper's
    cross-attention ``xk`` / ``xv`` over the 16 frames too), then its
    cache in a 32-position decode cache and a decode step at a per-row
    ``cur_index`` (row 1 one position further, over a zero key), whose
    positions count the image tokens; then a second step."""
    jcfg, cfg, jparams, tparams = model(name)
    b = batch_of(cfg, 3, S=12, labels=False)
    lj, jpc, lt, tpc, st = _prefill_both(name, jparams, tparams, b)
    _assert_logits(lt, lj, cfg.vocab)
    t = "dense" if name == PALI else "wdec"
    P = 12 + cfg.img_tokens
    want = {"k", "v", "xk", "xv"} if name == WHISPER else {"k", "v"}
    assert set(tpc) == {t} and set(tpc[t]) == set(jpc[t]) == want
    for lane, leaf in tpc[t].items():
        assert tuple(leaf.shape) == jpc[t][lane].shape and \
            leaf.dtype == torch.bfloat16, lane
        assert leaf.shape[2] == (cfg.enc_seq if lane[0] == "x" else P)
        # Layer 0's K/V come straight from the GEMM; the rest pass
        # through the f32 attention (and whisper's xk / xv through the
        # encoder's).
        if lane in ("k", "v"):
            assert np.array_equal(bits(leaf[0]), bits(jpc[t][lane][0]))
        _bf16_close(leaf, jpc[t][lane], lane)
    if name == WHISPER:
        assert set(st) == {"blocks", "enc"}
        assert float(st["blocks"]["wdec"]["xkv"].abs().sum()) > 0
    jc, tc = _decode_cache(cfg, jcfg, jpc, tpc, P, 32, {})
    rng = np.random.default_rng(4)
    for cur in ([P, P + 1], [P + 1, P + 2]):
        tok = rng.integers(0, cfg.vocab, (2, 1))
        lj, jc, lt, tc, st = _decode_both(name, jparams, tparams, jc, tc,
                                          tok, cur)
        _assert_logits(lt, lj, cfg.vocab)
    for lane in ("k", "v"):
        _bf16_close(tc[t][lane], jc[t][lane], lane)
    if name == WHISPER:
        assert float(st["blocks"]["wdec"]["xkv"].abs().sum()) == 0
        assert "enc" not in st


@pytest.mark.parametrize("tier", ("kv_fp8", "kv_mor"))
def test_paligemma_quantized_kv_tiers_match_reference(tier):
    """paligemma (dense blocks) on the fp8 and MoR KV tiers: the prefill's
    bf16 K/V quantized into each package's tier cache by its own
    quantizer, then two decode steps at per-row positions; logits and
    every lane the steps wrote."""
    name = PALI
    jcfg, cfg, jparams, tparams = model(name)
    b = batch_of(cfg, 6, S=8, labels=False)
    _, jpc, _, tpc, _ = _prefill_both(name, jparams, tparams, b)
    P = 8 + cfg.img_tokens
    jc, tc = _decode_cache(cfg, jcfg, jpc, tpc, P, 32, {tier: True})
    rng = np.random.default_rng(8)
    for cur in ([P, P + 2], [P + 1, P + 3]):
        tok = rng.integers(0, cfg.vocab, (2, 1))
        lj, jc, lt, tc, _ = _decode_both(name, jparams, tparams, jc, tc,
                                         tok, cur)
        _assert_logits(lt, lj, cfg.vocab)
    assert sorted(tc["dense"]) == sorted(jc["dense"])
    for lane, leaf in tc["dense"].items():
        same = bits(leaf) == bits(jc["dense"][lane])
        assert same.mean() >= 0.99, (lane, same.mean())


@pytest.mark.parametrize("tier", ("kv_fp8", "kv_mor"))
def test_whisper_refuses_quantized_kv_tiers(tier):
    """The reference's ``_wdec_block`` hands ``attn_sublayer`` only the
    cache's k / v: on a kv_fp8 or kv_mor cache its decode step casts K/V
    into the payload buffers with no scale and returns a cache without
    the scale and tag lanes. The port refuses those tiers for the audio
    family by name (cache_specs, init_cache and forward)."""
    jcfg, cfg, jparams, _ = model(WHISPER)
    jc = jinit_cache(jcfg, 2, 32, **{tier: True})
    assert "k_scale" in jc["wdec"]
    _, out, _ = jfn("decode", WHISPER)(
        jparams, jmake_tokens(jcfg), jc, jnp.zeros((2, 1), jnp.int32),
        jnp.asarray([3, 4], jnp.int32))
    assert sorted(out["wdec"]) == ["k", "v", "xk", "xv"]
    for call in (lambda: cache_specs(cfg, 2, 32, **{tier: True}),
                 lambda: init_cache(cfg, 2, 32, device="cpu",
                                    **{tier: True})):
        with pytest.raises(ValueError, match=f"{tier}.*'audio'"):
            call()
    tc = init_cache(cfg, 2, 32, device="cpu")
    tc["wdec"]["k_scale"] = torch.zeros(tc["wdec"]["k"].shape[:-1])
    if tier == "kv_mor":
        tc["wdec"]["k_tags"] = torch.zeros(tc["wdec"]["k"].shape[:-1],
                                           dtype=torch.uint8)
    with pytest.raises(ValueError, match=f"{tier}.*_wdec_block"):
        make_decode_fn(cfg, MoRDotPolicy())(
            model(WHISPER)[3], tc, torch.zeros((2, 1), dtype=torch.int64),
            torch.tensor([3, 4]))


def _quantized(name):
    """Both packages' trees quantized with sub3, min_size 1024 (every
    GEMM weight of the reduced models, whisper's encoder and x* weights
    included; embeddings, norms and biases stay dense)."""
    jcfg, cfg, jparams, tparams = model(name)
    qfg = jquantized.quantize_for_gemm
    compiled = jit_ref(qfg, static_argnums=1)  # once per weight shape
    jquantized.quantize_for_gemm = compiled
    try:
        jq, jst = jquantized.quantize_params(
            jparams, JPolicy(recipe="sub3", backend="xla"), min_size=1024)
    finally:
        jquantized.quantize_for_gemm = qfg
    tq, tst = quantize_params(tparams, MoRPolicy(recipe="sub3"),
                              min_size=1024)
    assert sorted(tst) == sorted(jst)
    return jq, tq, tst


@pytest.mark.parametrize("name", ARCHS)
def test_quantized_prefill_and_decode_match_reference(name):
    """sub3 QTensor weights (the reference's quantize_params rule: the
    encoder stack and the x* weights quantized, their lanes sliced per
    layer): a prefill and a decode step, every GEMM through the mixed
    GEMM on both sides."""
    jcfg, cfg, jparams, tparams = model(name)
    jq, tq, tst = _quantized(name)
    t = "dense" if name == PALI else "wdec"
    want = {f"blocks/{t}/{w}" for w in ("wqkv", "wo", "mlp/wi", "mlp/wo")}
    if name == WHISPER:
        want |= {f"blocks/wdec/{w}" for w in ("xwq", "xwkv", "xwo")}
        want |= {f"enc/blocks/{w}" for w in ("wqkv", "wo", "mlp/wi",
                                             "mlp/wo")}
        assert isinstance(tq["enc"]["blocks"]["wqkv"], QTensor)
        assert not isinstance(tq["enc"]["final_norm"]["bias"], QTensor)
    assert set(tst) == want
    b = batch_of(cfg, 7, S=8, labels=False)
    lj, jpc, lt, tpc, _ = _prefill_both(name, jq, tq, b)
    _assert_logits(lt, lj, cfg.vocab)
    P = 8 + cfg.img_tokens
    jc, tc = _decode_cache(cfg, jcfg, jpc, tpc, P, 24, {})
    tok = np.random.default_rng(9).integers(0, cfg.vocab, (2, 1))
    lj, _, lt, _, _ = _decode_both(name, jq, tq, jc, tc, tok, [P, P + 1])
    _assert_logits(lt, lj, cfg.vocab)
