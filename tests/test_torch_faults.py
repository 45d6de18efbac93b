"""The chaos harness of the port (``repro_torch.robust.faults``) against
the JAX reference on the CPU, and the port's guard rails under every
registered fault class.

* Every injector against the reference's on the same converted inputs,
  bit for bit: the same seed corrupts the same leaf, element, bit, byte
  and page. ``make_grad_fault``'s hook against the reference's with the
  flag off and on.
* The registry: ``fault_names()`` in the reference's order, and every
  class pinned to a test of this file (COVERAGE).
* The mirrors of ``tests/test_robust_chaos.py`` on the port: detection
  and containment of NaN / Inf operands by every recipe, the pack path,
  the three pack faults' decode containment, the re-encode ladder, the
  optimizer's skip-step, a ``make_train_step(grad_fault=)`` step on a
  reduced llama3 (skipped with the flag on, identical to the hook-free
  step with it off), and ``kv_page_trash`` in the engine (the victim
  quarantined, every other request's tokens bit-identical).

Tolerances: none but the re-encode's closeness to the data (rtol 0.08,
atol 0.02, the reference suite's). The rest is bit for bit.
"""
import copy
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.robust import faults as jfaults
from repro_torch.configs import get_config, reduced
from repro_torch.core.mor import (GUARD_BLOCK_FALLBACK, GUARD_NONFINITE_AMAX,
                                  GUARD_STALE_SCALE, STAT_FALLBACK_COUNT,
                                  STAT_FRAC_BF16, STAT_GUARD_FLAGS,
                                  mor_quantize, quantize_for_gemm)
from repro_torch.core.policy import (BF16_BASELINE, MoRDotPolicy, MoRPolicy,
                                     paper_default)
from repro_torch.core.tree import flatten_with_path
from repro_torch.kernels import ref as tref
from repro_torch.models import init_params
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import moments as tmoments
from repro_torch.robust import (GuardPolicy, fault_names, get_fault,
                                guard_flag_set, make_grad_fault, poison_tree,
                                requantize_with_backoff)
from repro_torch.serve import Engine, Request, ServeConfig
from repro_torch.serve.paged import PagedKVPool
from repro_torch.train import TrainConfig, make_train_step

# Fault class -> the tests of this file that exercise it (set-equal to the
# registry below, so a new class without a test fails).
COVERAGE = {
    "grad_nan": "test_grad_faults_match_reference / "
                "test_nonfinite_operand_* / test_skip_step_* / "
                "test_train_step_grad_fault_*",
    "grad_inf": "test_grad_faults_match_reference / "
                "test_nonfinite_operand_* / test_skip_step_* / "
                "test_train_step_grad_fault_*",
    "payload_bitflip": "test_pack_faults_match_reference / "
                       "test_payload_bitflip_contained",
    "scale_corrupt": "test_pack_faults_match_reference / "
                     "test_scale_corrupt_contained",
    "micro_scale_corrupt": "test_pack_faults_match_reference / "
                           "test_micro_scale_corrupt_contained",
    "stale_amax": "test_stale_amax_matches_reference / test_backoff_*",
    "kv_page_trash": "test_kv_page_trash_matches_reference / "
                     "test_kv_page_trash_quarantines_only_victim",
}
RECIPES = ("sub2", "sub3", "sub4", "tensor", "e4m3")
BADS = {"nan": np.nan, "inf": np.inf}


def bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        a = a.numpy()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16)
    if a.dtype == np.float32:
        return a.view(np.uint32)
    return a


def to_torch(a) -> torch.Tensor:
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def to_jax(t: torch.Tensor):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(bits(t).copy()).view(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _operand(seed=0, shape=(256, 256)):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32))


def test_every_fault_class_has_chaos_coverage():
    assert fault_names() == jfaults.fault_names()
    assert set(fault_names()) == set(COVERAGE)
    for name in fault_names():
        assert get_fault(name).layer == jfaults.get_fault(name).layer


# ------------------------------------------------- against the reference --
def _grad_tree():
    """Float leaves of three dtypes and shapes, a nested dict, an int
    leaf the injectors must skip."""
    rng = np.random.default_rng(3)
    return {"a": rng.normal(size=(8, 8)).astype(np.float32),
            "b": {"c": rng.normal(size=(16,)).astype(np.float32),
                  "d": rng.normal(size=(4, 6)).astype(np.float32)},
            "i": np.arange(12, dtype=np.int32).reshape(3, 4),
            "h": rng.normal(size=(5, 3)).astype(np.float32)}


def _convert(tree, jax_side):
    if isinstance(tree, dict):
        return {k: _convert(v, jax_side) for k, v in tree.items()}
    if jax_side:
        return jnp.asarray(tree).astype(jnp.bfloat16) \
            if tree.shape == (16,) else jnp.asarray(tree)
    t = torch.from_numpy(tree.copy())
    return t.to(torch.bfloat16) if tuple(t.shape) == (16,) else t


def _assert_trees_bitequal(t_tree, j_tree):
    import jax
    tl = flatten_with_path(t_tree)
    jl = jax.tree_util.tree_flatten_with_path(j_tree)[0]
    assert [k for k, _ in tl] == [jax.tree_util.keystr(p) for p, _ in jl]
    for (k, a), (_, b) in zip(tl, jl):
        np.testing.assert_array_equal(bits(a), bits(b), err_msg=k)


@pytest.mark.parametrize("kind", ("grad_nan", "grad_inf"))
def test_grad_faults_match_reference(kind):
    """poison_tree through the registry, and make_grad_fault's hook with
    the flag off and on: the same leaf and element as the reference's
    for every seed (bf16 and f32 leaves, an int leaf skipped)."""
    g = _grad_tree()
    seen = set()
    for seed in range(12):
        t = get_fault(kind).inject(_convert(g, False), seed=seed)
        j = jfaults.get_fault(kind).inject(_convert(g, True), seed=seed)
        _assert_trees_bitequal(t, j)
        _assert_trees_bitequal(poison_tree(_convert(g, False), BADS[
            kind.split("_")[1]], seed), j)
        bad = [k for k, leaf in flatten_with_path(t)
               if leaf.is_floating_point()
               and not bool(torch.isfinite(leaf).all())]
        assert len(bad) == 1
        seen.add(bad[0])
    assert len(seen) >= 3  # the seeds reach several leaves
    hook_t = make_grad_fault(kind.split("_")[1], seed=5)
    hook_j = jfaults.make_grad_fault(kind.split("_")[1], seed=5)
    for flag in (0.0, 1.0):
        t = hook_t(_convert(g, False), {"inject": torch.tensor(flag)})
        j = hook_j(_convert(g, True), {"inject": jnp.float32(flag)})
        _assert_trees_bitequal(t, j)
    src = _convert(g, False)
    assert hook_t(src, {"tokens": None}) is src  # no flag: the identity


def _packs():
    """(the port's pack, the reference's) of one sub4 operand with every
    tag: the port's pack_mixed lanes (bit for bit the reference's, held
    in test_torch_quantize_pack) carried into a reference MixedOperand."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(256, 256))
    grid = np.array([0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0])
    x[128:, :128] = grid[rng.integers(0, 7, (128, 128))] * np.repeat(
        np.exp2(rng.integers(-4, 4, (128, 8))), 16, axis=1)
    xt = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    tags = torch.tensor([[tref.TAG_E4M3, tref.TAG_E5M2],
                         [tref.TAG_NVFP4, tref.TAG_BF16]], dtype=torch.int32)
    mo = tref.pack_mixed(xt, tags, (128, 128), with_nvfp4=True)
    mo_j = jref.MixedOperand(
        *(to_jax(getattr(mo, n)) for n in ("payload_q", "payload_bf16",
                                           "tags", "scales")),
        block=mo.block, shape=mo.shape, payload_nib=to_jax(mo.payload_nib),
        micro_scales=to_jax(mo.micro_scales), has_nvfp4=True)
    return mo, mo_j


@pytest.mark.parametrize("kind", ("payload_bitflip", "scale_corrupt",
                                  "micro_scale_corrupt"))
def test_pack_faults_match_reference(kind):
    """The same byte, bit and block for the same seed as the reference's
    injector, the other lanes untouched, the input pack left whole."""
    mo, mo_j = _packs()
    before = {n: getattr(mo, n).clone() for n in ("payload_q", "scales",
                                                  "micro_scales")}
    for seed in range(8):
        t = get_fault(kind).inject(mo, seed=seed)
        j = jfaults.get_fault(kind).inject(mo_j, seed=seed)
        for lane in ("payload_q", "payload_bf16", "tags", "scales",
                     "payload_nib", "micro_scales"):
            np.testing.assert_array_equal(
                bits(getattr(t, lane)), bits(getattr(j, lane)),
                err_msg=f"{kind} seed {seed} {lane}")
    for n, b in before.items():
        assert torch.equal(getattr(mo, n), b)


def test_micro_scale_corrupt_needs_the_lane():
    mo, _ = _packs()
    empty = dataclasses.replace(
        mo, micro_scales=torch.zeros((0,), dtype=torch.uint8))
    with pytest.raises(ValueError, match="micro-scale"):
        get_fault("micro_scale_corrupt").inject(empty)


def test_stale_amax_matches_reference():
    for amax, shrink in ((3.7, 8.0), (np.float32(1e-3), 4.0)):
        t = get_fault("stale_amax").inject(amax, shrink=shrink)
        j = jfaults.get_fault("stale_amax").inject(amax, shrink=shrink)
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(bits(t), bits(j))


def test_kv_page_trash_matches_reference():
    """Page 3 of a reduced llama3's bf16 pool, trashed in place: every
    paged leaf as the reference's (the page NaN on axis 1, the rest
    untouched)."""
    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.serve.paged import PagedKVPool as JPagedKVPool

    cfg = reduced(get_config("llama3-8b"))
    tp = PagedKVPool(cfg, slots=2, max_seq=32, page_size=8, device="cpu")
    jp = JPagedKVPool(jreduced(jget_config("llama3-8b")), 2, 32, page_size=8)
    rng = np.random.default_rng(0)
    for i, key in enumerate(jp._keys):
        t, name = key.split("/")
        leaf = tp.leaves[t][name]
        vals = rng.normal(size=tuple(leaf.shape)).astype(np.float32)
        tp.leaves[t][name] = torch.from_numpy(vals).to(leaf.dtype)
        jp._leaves[i] = jnp.asarray(vals).astype(jp._leaves[i].dtype)
    get_fault("kv_page_trash").inject(tp, 3, seed=1)
    jfaults.get_fault("kv_page_trash").inject(jp, 3, seed=1)
    for i, key in enumerate(jp._keys):
        t, name = key.split("/")
        got = tp.leaves[t][name]
        np.testing.assert_array_equal(bits(got), bits(jp._leaves[i]))
        assert bool(torch.isnan(got[:, 3]).all())
        assert bool(torch.isfinite(got[:, :3]).all())


# ------------------------------------------------ detect + contain --
@pytest.mark.parametrize("recipe", RECIPES)
@pytest.mark.parametrize("bad", sorted(BADS))
def test_nonfinite_operand_detected_and_contained(recipe, bad):
    """One poisoned element: the guard lanes flag it, and the sub-tensor
    recipes route exactly the poisoned 128x128 block to the BF16 arm
    (poison kept, every other element finite); the tensor recipe
    degrades the whole operand to passthrough."""
    x = _operand()
    x[3, 7] = BADS[bad]
    y, stats = mor_quantize(x, MoRPolicy(recipe=recipe))
    assert bool(guard_flag_set(stats[STAT_GUARD_FLAGS],
                               GUARD_NONFINITE_AMAX))
    assert bool(guard_flag_set(stats[STAT_GUARD_FLAGS],
                               GUARD_BLOCK_FALLBACK))
    assert float(stats[STAT_FALLBACK_COUNT]) == 1.0
    if recipe in ("sub2", "sub3", "sub4"):
        assert float(stats[STAT_FRAC_BF16]) == 0.25
        assert not np.isfinite(float(y[3, 7]))
        mask = torch.ones(y.shape, dtype=torch.bool)
        mask[3, 7] = False
        assert bool(torch.isfinite(y[mask]).all())
    elif recipe == "tensor":
        assert float(stats[STAT_FRAC_BF16]) == 1.0
        np.testing.assert_array_equal(bits(y), bits(x))


@pytest.mark.parametrize("recipe", RECIPES)
def test_clean_path_has_no_flags(recipe):
    _, stats = mor_quantize(_operand(), MoRPolicy(recipe=recipe))
    assert float(stats[STAT_GUARD_FLAGS]) == 0.0
    assert float(stats[STAT_FALLBACK_COUNT]) == 0.0


def test_pack_path_preserves_poison_in_bf16_block():
    x = _operand()
    x[3, 7] = np.nan
    mo, stats = quantize_for_gemm(x.to(torch.bfloat16),
                                  MoRPolicy(recipe="sub3"))
    assert int((mo.tags == tref.TAG_BF16).sum()) == 1
    assert float(stats[STAT_FALLBACK_COUNT]) == 1.0
    y = tref.decode_mixed_ref(mo)[:256, :256].float()
    assert bool(torch.isnan(y[3, 7]))
    mask = torch.ones(y.shape, dtype=torch.bool)
    mask[3, 7] = False
    assert bool(torch.isfinite(y[mask]).all())


def _decode(mo):
    R, K = mo.shape
    return tref.decode_mixed_ref(mo)[:R, :K].float()


def _same_or_both_nan(a, b):
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def test_payload_bitflip_contained():
    """A flipped payload bit changes at most the elements of that byte."""
    mo, _ = quantize_for_gemm(_operand(3).to(torch.bfloat16),
                              MoRPolicy(recipe="sub3"))
    clean = _decode(mo)
    inj = _decode(get_fault("payload_bitflip").inject(mo, seed=11))
    diff = (clean != inj) & ~(torch.isnan(clean) & torch.isnan(inj))
    assert 1 <= int(diff.sum()) <= 2


def test_scale_corrupt_contained():
    """A NaN GAM scale poisons exactly its own block."""
    mo, _ = quantize_for_gemm(_operand(4).to(torch.bfloat16),
                              MoRPolicy(recipe="sub3"))
    clean = _decode(mo)
    bad = get_fault("scale_corrupt").inject(mo, seed=7)
    inj = _decode(bad)
    bi, bj = torch.nonzero(torch.isnan(bad.scales))[0].tolist()
    block = torch.zeros(inj.shape, dtype=torch.bool)
    block[bi * 128:(bi + 1) * 128, bj * 128:(bj + 1) * 128] = True
    assert not bool(torch.isfinite(inj[block]).all())
    assert _same_or_both_nan(inj[~block], clean[~block])


def test_micro_scale_corrupt_contained():
    """A 0xFF micro-scale byte poisons only its own 16-element group."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(128, 256)).astype(
        np.float32)).to(torch.bfloat16)
    tags = torch.full((1, 2), tref.TAG_NVFP4, dtype=torch.int32)
    mo = tref.pack_mixed(x, tags, (128, 128), with_nvfp4=True)
    assert int((mo.micro_scales != 0).sum()) > 0
    clean = _decode(mo)
    inj = _decode(get_fault("micro_scale_corrupt").inject(mo, seed=9))
    n_bad = int((~torch.isfinite(inj)).sum())
    assert 1 <= n_bad <= 16
    ok = torch.isfinite(inj)
    assert _same_or_both_nan(inj[ok], clean[ok])


# ------------------------------------------- stale-amax re-encode --
def test_backoff_recovers_with_bounded_retries():
    x = _operand(6, (128, 128))
    true_amax = torch.amax(x.abs())
    stale = get_fault("stale_amax").inject(true_amax, shrink=4.0)
    y, stats, attempts = requantize_with_backoff(x, stale, max_retries=3)
    assert int(attempts) == 2
    assert float(stats[STAT_GUARD_FLAGS]) == 0.0
    assert bool(torch.isfinite(y).all())
    assert np.allclose(y.numpy(), x.numpy(), rtol=0.08, atol=0.02)
    assert float(y.abs().max()) <= float(true_amax) * 1.01


def test_backoff_exhaustion_falls_back_to_bf16():
    x = _operand(6, (128, 128))
    stale = get_fault("stale_amax").inject(torch.amax(x.abs()), shrink=1e6)
    y, stats, attempts = requantize_with_backoff(x, stale, max_retries=2)
    assert int(attempts) == 2
    assert bool(guard_flag_set(stats[STAT_GUARD_FLAGS], GUARD_STALE_SCALE))
    assert torch.equal(y, x)


def test_backoff_nonfinite_amax_falls_back():
    x = _operand(6, (128, 128))
    y, stats, _ = requantize_with_backoff(x, torch.tensor(float("inf")))
    assert bool(guard_flag_set(stats[STAT_GUARD_FLAGS],
                               GUARD_NONFINITE_AMAX))
    assert torch.equal(y, x)


# ------------------------------------------------ optimizer rung --
def _state_bits(tree):
    return [(k, bits(v)) for k, v in flatten_with_path(tree)]


def _same_state(a, b):
    return all(ka == kb and np.array_equal(x, y)
               for (ka, x), (kb, y) in zip(_state_bits(a), _state_bits(b)))


@pytest.mark.parametrize("kind", ["grad_nan", "grad_inf"])
def test_skip_step_preserves_state(kind):
    """A poisoned gradient tree leaves the master weights, the packed
    moments (every lane), the step counter and the params bit-exact and
    reports guard_skip; without the guard the same gradients do move the
    state."""
    moments = tmoments.MomentPolicy(
        m=MoRPolicy(recipe="sub3"),
        v=MoRPolicy(recipe="sub3", threshold=0.02), min_leaf=0)
    rng = np.random.default_rng(8)
    params = {"w": torch.from_numpy(rng.normal(size=(128, 128)).astype(
                  np.float32)).to(torch.bfloat16),
              "b": torch.from_numpy(rng.normal(size=(128,)).astype(
                  np.float32)).to(torch.bfloat16)}
    cfg = tadamw.AdamWConfig(peak_lr=1e-3, final_lr=1e-4, warmup_steps=2,
                             total_steps=10)
    opt = tadamw.init_opt_state(params, moments=moments)
    grads = {k: torch.from_numpy((rng.normal(size=tuple(v.shape)) * 1e-2)
                                 .astype(np.float32))
             for k, v in params.items()}
    params, opt, m0 = tadamw.adamw_update(cfg, grads, opt, moments=moments,
                                          guard=GuardPolicy())
    assert float(m0["guard_skip"]) == 0.0
    before = copy.deepcopy((params, opt))
    bad = get_fault(kind).inject(grads, seed=2)
    p2, opt2, m2 = tadamw.adamw_update(cfg, bad, opt, moments=moments,
                                       guard=GuardPolicy())
    assert float(m2["guard_skip"]) == 1.0
    assert _same_state((p2, opt2), before)
    p3, opt3, _ = tadamw.adamw_update(cfg, bad, opt, moments=moments)
    assert not _same_state(opt3.master, before[1].master)


# ------------------------------------------------ train-step rung --
def _chaos_step(fault):
    cfg = dataclasses.replace(reduced(get_config("llama3-8b")), vocab=64)
    tcfg = TrainConfig(
        optimizer=tadamw.AdamWConfig(peak_lr=1e-3, final_lr=1e-4,
                                     warmup_steps=5, total_steps=50),
        compress_grads="mor_ef", grad_policy=MoRPolicy(recipe="sub3"),
        guard=GuardPolicy())
    params = init_params(cfg, seed=0, device="cpu")
    opt = tadamw.init_opt_state(params, ef=True)
    return params, opt, make_train_step(cfg, paper_default("sub3"), tcfg,
                                        grad_fault=fault)


def _batch(rng, inject=None):
    b = {k: torch.from_numpy(rng.integers(0, 64, (4, 32)))
         for k in ("tokens", "labels")}
    if inject is not None:
        b["inject"] = torch.tensor(inject, dtype=torch.float32)
    return b


@pytest.mark.parametrize("kind", ["nan", "inf"])
def test_train_step_grad_fault_skips_and_clean_steps_match(kind):
    """make_train_step(grad_fault=make_grad_fault(kind, seed=3)) under
    'mor_ef' and the guard: with the flag on the step is dropped (EF
    residuals, masters, moments, step and params bit-exact; the guard
    reports), with it off the step is the hook-free step's bit for
    bit."""
    params, opt, step = _chaos_step(make_grad_fault(kind, seed=3))
    p_ref, opt_ref, step_ref = _chaos_step(None)
    rng = np.random.default_rng(7)
    b = _batch(rng, 0.0)
    params, opt, m = step(params, opt, b)
    p_ref, opt_ref, m_ref = step_ref(p_ref, opt_ref,
                                     {k: b[k] for k in ("tokens", "labels")})
    assert float(m["guard_skip"]) == 0.0
    assert _same_state((params, opt), (p_ref, opt_ref))
    assert float(m["loss"]) == float(m_ref["loss"])

    before = copy.deepcopy((params, opt))
    p2, opt2, m2 = step(params, opt, _batch(rng, 1.0))
    assert float(m2["guard_skip"]) == 1.0
    assert float(m2["guard_flag_events"]) > 0.0
    assert np.isfinite(float(m2["loss"]))  # the loss precedes the poison
    assert _same_state((p2, opt2), before)

    _, opt3, m3 = step(params, opt, _batch(rng, 0.0))
    assert float(m3["guard_skip"]) == 0.0
    assert int(opt3.step) == int(before[1].step) + 1


# --------------------------------------------------- serve rung --
def _serve(params, cfg, quantize, inject_after=None, victim=0):
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab, L).astype(np.int32)
               for L in (3, 17, 9)]
    q = None if quantize is None else MoRPolicy(recipe=quantize)
    eng = Engine(cfg, BF16_BASELINE if q is None else MoRDotPolicy(), params,
                 ServeConfig(slots=3, max_seq=64, page_size=8,
                             prefill_chunk=8),
                 quantize=q, quantize_min_size=0, device="cpu")
    reqs = [Request(i, p, max_tokens=8) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    if inject_after is not None:
        for _ in range(inject_after):
            eng.step()
        assert eng.slot_state[victim] == "decode"
        get_fault("kv_page_trash").inject(eng.pool,
                                          eng.pool._owned[victim][0])
    eng.run_to_completion()
    return reqs, eng


@pytest.mark.parametrize("quantize", (None, "sub3"))
def test_kv_page_trash_quarantines_only_victim(quantize):
    """Trash the victim's first KV page mid-decode: it is quarantined with
    the condition on req.error and its pages freed; every other request's
    tokens are bit-identical to the clean run. The rows of a decode batch
    are independent where its activations are not quantized as one
    tensor: bf16 weights under the bf16 baseline, and every weight a
    sub3 QTensor (the serving GEMM takes the activation as it is). Under
    the tensor recipe the batch's group amax couples the rows, and a
    quarantined slot's row moves the others' scales."""
    cfg = dataclasses.replace(reduced(get_config("llama3-8b")), vocab=128)
    params = init_params(cfg, seed=0, device="cpu")
    ref, _ = _serve(params, cfg, quantize)
    assert all(r.done and r.error is None for r in ref)
    inj, eng = _serve(params, cfg, quantize, inject_after=5)
    v = inj[0]
    assert v.done and v.error and v.error.startswith("quarantined:")
    assert "nonfinite logits" in v.error
    assert v in eng.quarantined
    assert len(v.out) < len(ref[0].out)
    for got, want in zip(inj[1:], ref[1:]):
        assert got.error is None and got.out == want.out
    assert len(eng.pool.free) == eng.pool.n_pages  # pages released
