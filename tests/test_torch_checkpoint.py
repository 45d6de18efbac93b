"""Checkpoint/restart of the port (``repro_torch.checkpoint``,
``repro_torch.train.Trainer``) against the JAX reference on the CPU.

* Cross-format: a checkpoint the port writes (bf16 params, packed
  moments with forced E4M3 / E5M2 / BF16 / NVFP4 tags, EF residuals)
  is restored by ``repro.checkpoint.Checkpointer`` and one the JAX
  package writes (full lanes) by the port: every lane, scale, stats row,
  master, residual and the step bit for bit, the decoded moments equal,
  and the port's ``has_nvfp4`` recomputed from the restored tags.
* The mirror of ``tests/test_checkpoint_compressed.py`` on the port: a
  bit-exact round trip of the compressed state, and a trajectory resumed
  at step 3 of 6 bit-identical to the unbroken one.
* The Checkpointer's behaviour: keep-k GC, atomicity, an async save
  followed by an in-place update, bf16 and fp8 without ``ml_dtypes``.
* The Trainer: a restart bit-exact to the unbroken run, the straggler
  watchdog, and the preemption divergence (the reference saves a
  preempted run's state again under ``total_steps``; the port saves it
  once, under the step it reached).

Tolerances: none. Every comparison is bit for bit.
"""
import dataclasses
import os
import signal
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JCheckpointer
from repro.checkpoint import latest_step as jlatest_step
from repro.core.policy import MoRPolicy as JPolicy
from repro.kernels import ref as jref
from repro.optim import adamw as jadamw
from repro.optim import moments as jmoments
from repro_torch.checkpoint import Checkpointer, latest_step
from repro_torch.configs import get_config, reduced
from repro_torch.core.policy import MoRPolicy, paper_default
from repro_torch.core.tree import flatten_with_path
from repro_torch.data import DataConfig
from repro_torch.kernels import ref as tref
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import moments as tmoments
from repro_torch.optim.compress import compress_grads
from repro_torch.train import Trainer, TrainConfig, TrainerConfig

ROOT = Path(__file__).resolve().parents[1]
LANES = ("payload_q", "payload_bf16", "tags", "scales", "payload_nib",
         "micro_scales")
E4, E5, BF, NV = (tref.TAG_E4M3, tref.TAG_E5M2, tref.TAG_BF16,
                  tref.TAG_NVFP4)
# m under sub3 (no NVFP4 arm), v under sub4; "b" stays dense (min_leaf).
TPOL = tmoments.MomentPolicy(m=MoRPolicy(recipe="sub3"),
                             v=MoRPolicy(recipe="sub4"), min_leaf=1024)
JPOL = jmoments.MomentPolicy(m=JPolicy(recipe="sub3", backend="xla"),
                             v=JPolicy(recipe="sub4", backend="xla"),
                             min_leaf=1024)
SHAPES = {"b": (256,), "w": (256, 256)}
TAGS = {"m": [[E4, E5], [BF, E4]], "v": [[NV, E4], [BF, E5]]}


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


def moment_values(seed, which):
    """Leaf values a forced-tag pack stores meaningfully: N(0, 1) for the
    fp8 and BF16 arms, E2M1 grid values times power-of-two micro scales
    where the v pack has its NVFP4 block."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(SHAPES["w"]) * 1e-3
    if which == "v":
        grid = np.array([0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0])
        micro = np.exp2(rng.integers(-12, -6, (128, 8)).astype(np.float64))
        x[:128, :128] = grid[rng.integers(0, 7, (128, 128))] * np.repeat(
            micro, 16, axis=1)
    return x.astype(np.float32)


def forced_packs(seed):
    """{name: (the port's PackedMoment (compact), the reference's (full
    lanes, the same arrays))} of the "w" leaf, packed from bf16 values
    under the forced tag grids of TAGS (the port's pack_mixed is held
    bit for bit against the reference's in test_torch_quantize_pack)."""
    out = {}
    for i, name in enumerate(("m", "v")):
        x = torch.from_numpy(moment_values(seed + i, name)).to(
            torch.bfloat16)
        tags = torch.tensor(TAGS[name], dtype=torch.int32)
        stats = np.random.default_rng(seed + 10 + i).standard_normal(
            14).astype(np.float32)
        mo = tref.pack_mixed(x, tags, (128, 128), with_nvfp4=name == "v")
        mo_j = jref.MixedOperand(
            *(jnp.asarray(bits(getattr(mo, n)).copy()).view(jnp.bfloat16)
              if n == "payload_bf16" else jnp.asarray(getattr(mo, n).numpy())
              for n in ("payload_q", "payload_bf16", "tags", "scales")),
            block=mo.block, shape=mo.shape,
            payload_nib=jnp.asarray(mo.payload_nib.numpy()),
            micro_scales=jnp.asarray(mo.micro_scales.numpy()),
            has_nvfp4=name == "v")
        out[name] = (
            tmoments.PackedMoment(mo=mo.compact(),
                                  stats=torch.from_numpy(stats),
                                  shape=SHAPES["w"]),
            jmoments.PackedMoment(mo=mo_j, stats=jnp.asarray(stats),
                                  shape=SHAPES["w"]))
    return out


def dense(seed):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}


def assert_lanes_equal(pm_t, pm_j, what):
    for lane in LANES:
        a, b = getattr(pm_t.mo, lane), getattr(pm_j.mo, lane)
        assert tuple(a.shape) == tuple(b.shape), (what, lane)
        np.testing.assert_array_equal(bits(a), bits(b),
                                      err_msg=f"{what} {lane}")
    np.testing.assert_array_equal(bits(pm_t.stats), bits(pm_j.stats))
    np.testing.assert_array_equal(
        bits(tmoments.decode_moment(pm_t)),
        bits(jmoments.decode_moment(pm_j)), err_msg=f"{what} decode")


def test_port_checkpoint_restores_in_jax(tmp_path):
    """The port writes (params, OptState) with packed moments of every
    tag; the reference's Checkpointer restores it into its own
    init_opt_state target: every lane bit for bit, the decoded moments
    equal."""
    packs = forced_packs(1)
    p = {k: torch.from_numpy(v).to(torch.bfloat16)
         for k, v in dense(2).items()}
    master, ef = dense(3), dense(4)
    m_b, v_b = dense(5)["b"], dense(6)["b"] ** 2
    opt = tadamw.OptState(
        master={k: torch.from_numpy(v) for k, v in master.items()},
        m={"b": torch.from_numpy(m_b), "w": packs["m"][0]},
        v={"b": torch.from_numpy(v_b), "w": packs["v"][0]},
        step=torch.tensor(5, dtype=torch.int32),
        ef={k: torch.from_numpy(v) for k, v in ef.items()})
    keys = [k for k, _ in flatten_with_path((p, opt))]
    assert "[1].m['w'].mo.payload_q" in keys and "[1].step" in keys
    assert "[1].ef['w']" in keys and "[0]['w']" in keys
    ck = Checkpointer(str(tmp_path))
    ck.save(5, (p, opt))
    ck.wait()

    jp = {k: jnp.zeros(s, jnp.bfloat16) for k, s in SHAPES.items()}
    # The structure of the reference's fresh state (restore reads only
    # its structure and dtypes).
    target = (jp, jax.eval_shape(
        lambda: jadamw.init_opt_state(jp, moments=JPOL, ef=True)))
    gp, gopt = JCheckpointer(str(tmp_path)).restore(5, target)
    for k in SHAPES:
        np.testing.assert_array_equal(bits(gp[k]), bits(p[k]))
        np.testing.assert_array_equal(bits(gopt.master[k]), bits(master[k]))
        np.testing.assert_array_equal(bits(gopt.ef[k]), bits(ef[k]))
    np.testing.assert_array_equal(bits(gopt.m["b"]), bits(m_b))
    np.testing.assert_array_equal(bits(gopt.v["b"]), bits(v_b))
    assert int(gopt.step) == 5 and gopt.step.dtype == jnp.int32
    for name in ("m", "v"):
        assert_lanes_equal(packs[name][0], getattr(gopt, name)["w"], name)
        assert set(np.unique(np.asarray(getattr(gopt, name)["w"].mo.tags))) \
            == set(np.ravel(TAGS[name]))


def test_jax_checkpoint_restores_in_port(tmp_path):
    """The reference writes its state with full lanes; the port restores
    it into its own init_opt_state target (compact zero packs, has_nvfp4
    False): the file's lane shapes and bits, has_nvfp4 read from the
    restored tags, the decoded moments equal."""
    packs = forced_packs(7)
    jp = {k: jnp.asarray(v).astype(jnp.bfloat16)
          for k, v in dense(8).items()}
    m_b, v_b = dense(10)["b"], dense(11)["b"] ** 2
    jopt = jadamw.OptState(
        master={k: jnp.asarray(v) for k, v in dense(12).items()},
        m={"b": jnp.asarray(m_b), "w": packs["m"][1]},
        v={"b": jnp.asarray(v_b), "w": packs["v"][1]},
        step=jnp.int32(7),
        ef={k: jnp.asarray(v) for k, v in dense(9).items()})
    JCheckpointer(str(tmp_path), async_save=False).save(7, (jp, jopt))

    tp = {k: torch.zeros(s, dtype=torch.bfloat16) for k, s in SHAPES.items()}
    target = (tp, tadamw.init_opt_state(tp, moments=TPOL, ef=True))
    assert target[1].v["w"].mo.has_nvfp4 is False
    gp, gopt = Checkpointer(str(tmp_path)).restore(7, target)
    for k in SHAPES:
        np.testing.assert_array_equal(bits(gp[k]), bits(jp[k]))
        np.testing.assert_array_equal(bits(gopt.master[k]),
                                      bits(jopt.master[k]))
        np.testing.assert_array_equal(bits(gopt.ef[k]), bits(jopt.ef[k]))
        assert gp[k].dtype == torch.bfloat16
    np.testing.assert_array_equal(bits(gopt.m["b"]), bits(m_b))
    np.testing.assert_array_equal(bits(gopt.v["b"]), bits(v_b))
    assert gopt.step.dtype == torch.int32 and int(gopt.step) == 7
    for name in ("m", "v"):
        pm_t, pm_j = getattr(gopt, name)["w"], getattr(jopt, name)["w"]
        assert_lanes_equal(pm_t, pm_j, name)
        assert pm_t.shape == SHAPES["w"]
        assert pm_t.mo.has_nvfp4 is (name == "v")


# ---------------------------------------------------------------------------
# The mirror of tests/test_checkpoint_compressed.py
# ---------------------------------------------------------------------------

_MOMENTS = tmoments.MomentPolicy(
    m=MoRPolicy(recipe="sub3"), v=MoRPolicy(recipe="sub3", threshold=0.02),
    min_leaf=0)
_CFG = tadamw.AdamWConfig(peak_lr=1e-2, final_lr=1e-3, warmup_steps=2,
                          total_steps=10)


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": torch.from_numpy(rng.normal(size=(128, 128)).astype(
                np.float32)).to(torch.bfloat16),
            "b": torch.from_numpy(rng.normal(size=(128,)).astype(
                np.float32)).to(torch.bfloat16)}


def _grads(rng, params, scale=1e-2):
    return {k: torch.from_numpy((rng.normal(size=tuple(v.shape)) * scale)
                                .astype(np.float32))
            for k, v in params.items()}


def _step(params, opt, grads):
    """One compressed optimizer step: mor_ef gradients, then packed-moment
    AdamW (it updates ``opt`` in place)."""
    g, ef, _ = compress_grads(grads, "mor_ef", opt.ef,
                              MoRPolicy(recipe="sub3"))
    params, opt, _ = tadamw.adamw_update(_CFG, g, opt, moments=_MOMENTS)
    return params, opt._replace(ef=ef)


def _warm_state(steps=3):
    params = _params()
    opt = tadamw.init_opt_state(params, moments=_MOMENTS, ef=True)
    rng = np.random.default_rng(1)
    for _ in range(steps):
        params, opt = _step(params, opt, _grads(rng, params))
    return params, opt


def _assert_tree_bitexact(got, want):
    g, w = flatten_with_path(got), flatten_with_path(want)
    assert [k for k, _ in g] == [k for k, _ in w]
    for (k, a), (_, b) in zip(g, w):
        assert a.dtype == b.dtype and tuple(a.shape) == tuple(b.shape), k
        np.testing.assert_array_equal(bits(a), bits(b), err_msg=k)


def _fresh_target():
    return {"params": _params(5),
            "opt": tadamw.init_opt_state(_params(5), moments=_MOMENTS,
                                         ef=True)}


def test_packed_opt_state_roundtrips_bitexact(tmp_path):
    params, opt = _warm_state()
    dts = {a.dtype for _, a in flatten_with_path(opt)}
    assert torch.uint8 in dts, dts  # the state holds payload lanes
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(3, {"params": params, "opt": opt})
    got = ck.restore(3, _fresh_target())
    _assert_tree_bitexact(got["params"], params)
    _assert_tree_bitexact(got["opt"], opt)
    assert int(got["opt"].step) == 3
    for name in ("m", "v"):
        for k in ("w", "b"):
            assert getattr(got["opt"], name)[k].mo.has_nvfp4 is False


def test_resumed_trajectory_matches_unbroken(tmp_path):
    """Save at step 3 of 6, restore into a fresh target, continue on the
    same gradient stream: params and the whole OptState (packed lanes,
    EF, step) bit-identical to the run that never stopped."""
    params_u, opt_u = _warm_state(3)
    rng_tail = np.random.default_rng(2)
    for _ in range(3):
        params_u, opt_u = _step(params_u, opt_u, _grads(rng_tail, params_u))

    params_h, opt_h = _warm_state(3)
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(3, {"params": params_h, "opt": opt_h})
    got = ck.restore(3, _fresh_target())
    params_r, opt_r = got["params"], got["opt"]
    rng_tail = np.random.default_rng(2)
    for _ in range(3):
        params_r, opt_r = _step(params_r, opt_r, _grads(rng_tail, params_r))
    _assert_tree_bitexact(params_r, params_u)
    _assert_tree_bitexact(opt_r, opt_u)
    assert int(opt_r.step) == 6


# ---------------------------------------------------------------------------
# Checkpointer behaviour
# ---------------------------------------------------------------------------


def test_keep_k_gc_and_atomic_latest(tmp_path):
    """keep=2 leaves the two newest steps; a .tmp directory (a save cut
    mid-write) and a directory without a manifest are never a
    checkpoint."""
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in range(1, 6):
        ck.save(s, {"x": torch.full((4,), float(s))})
    ck.wait()
    names = sorted(n for n in os.listdir(tmp_path))
    assert names == ["step_4", "step_5"]
    (tmp_path / "step_9.tmp").mkdir()
    (tmp_path / "step_9.tmp" / "manifest.json").write_text("{}")
    (tmp_path / "step_8").mkdir()
    assert latest_step(str(tmp_path)) == 5
    assert jlatest_step(str(tmp_path)) == 5
    assert latest_step(str(tmp_path / "absent")) is None
    got = ck.restore(5, {"x": torch.zeros(4)})
    assert torch.equal(got["x"], torch.full((4,), 5.0))
    assert ck.manifest(5)["step"] == 5


def test_async_save_holds_the_pre_update_bytes(tmp_path):
    """save() copies every leaf before it returns, so an in-place update
    right after it (the port's AdamW writes its state in place) cannot
    reach the file the writer thread is still writing."""
    x = torch.arange(1 << 20, dtype=torch.float32)
    y = torch.arange(64, dtype=torch.int32)
    ck = Checkpointer(str(tmp_path), async_save=True)
    ck.save(1, {"x": x, "y": y}, extra={"note": "pre"})
    x.add_(1.0)
    y.mul_(3)
    ck.wait()
    got = ck.restore(1, {"x": torch.zeros(1), "y": torch.zeros(1,
                                                               dtype=torch.int32)})
    assert torch.equal(got["x"], torch.arange(1 << 20, dtype=torch.float32))
    assert torch.equal(got["y"], torch.arange(64, dtype=torch.int32))
    assert ck.manifest(1)["extra"] == {"note": "pre"}


def test_write_error_is_raised_by_wait(tmp_path):
    """A write that fails on the writer thread (here a file where the
    .tmp directory goes) is raised by wait(), and leaves no checkpoint."""
    ck = Checkpointer(str(tmp_path))
    (tmp_path / "step_2.tmp").write_text("not a directory")
    ck.save(2, {"x": torch.zeros(2)})
    with pytest.raises(NotADirectoryError):
        ck.wait()
    ck.wait()  # raised once
    assert latest_step(str(tmp_path)) is None


def test_restore_refuses_shardings(tmp_path):
    """restore(shardings=) onto a mesh (the elastic re-mesh): each sharded
    leaf is this rank's block of the reference's file, in the target's
    dtype, a leaf without a sharding whole, and a sharding whose axis
    does not divide its dimension is refused with a ValueError naming
    the leaf. The rank is rank 1 of a ('data' 1, 'model' 2) mesh, stood
    in by a Mesh without a process group (the cut reads only its
    coordinates); the four-rank worlds are tests/test_torch_sharded.py's.
    shardings=None restores every leaf whole, as before."""
    from repro_torch.core.collectives import Mesh
    from repro_torch.sharding import NamedSharding, P

    w = np.arange(6 * 8, dtype=np.float32).reshape(6, 8)
    v = np.arange(5, dtype=np.float32) - 2.5
    JCheckpointer(str(tmp_path), async_save=False).save(
        1, {"w": jnp.asarray(w, jnp.bfloat16), "v": jnp.asarray(v)})
    ck = Checkpointer(str(tmp_path), async_save=False)
    target = {"w": torch.zeros(1, dtype=torch.float32),
              "v": torch.zeros(1, dtype=torch.bfloat16)}
    mesh = Mesh((1, 2), ("data", "model"), "cpu", 1, {})
    got = ck.restore(1, target, shardings={
        "w": NamedSharding(mesh, P(None, "model"))})
    assert got["w"].dtype == torch.float32 and got["v"].dtype == \
        torch.bfloat16
    np.testing.assert_array_equal(got["w"].numpy(), w[:, 4:])
    np.testing.assert_array_equal(got["v"].float().numpy(), v)
    whole = ck.restore(1, target)
    np.testing.assert_array_equal(whole["w"].numpy(), w)
    with pytest.raises(ValueError, match=r"\['v'\]"):
        ck.restore(1, target, shardings={"v": NamedSharding(mesh,
                                                            P("model"))})


def test_bf16_and_fp8_without_ml_dtypes(tmp_path):
    """With ml_dtypes unimportable, the port stores bf16 / fp8 leaves as
    unsigned integers named by the sidecar and restores them bit for
    bit."""
    code = f"""
import sys
sys.modules["ml_dtypes"] = None
import json, torch
from repro_torch.checkpoint import Checkpointer
x = torch.randn(64, 32).to(torch.bfloat16)
f = torch.randn(16).to(torch.float8_e4m3fn)
g = torch.randn(16).to(torch.float8_e5m2)
ck = Checkpointer({str(tmp_path)!r})
ck.save(2, (x, {{"f": f, "g": g}}))
ck.wait()
d = ck.manifest(2)["dtypes"]
assert d == {{"[0]": "bfloat16", "[1]['f']": "float8_e4m3fn",
             "[1]['g']": "float8_e5m2"}}, d
got = ck.restore(2, (torch.zeros(1, dtype=torch.bfloat16),
                     {{"f": f, "g": g}}))
assert got[0].dtype == torch.bfloat16
assert torch.equal(got[0].view(torch.int16), x.view(torch.int16))
for k, t in (("f", f), ("g", g)):
    assert torch.equal(got[1][k].view(torch.uint8), t.view(torch.uint8))
assert "ml_dtypes" not in [m for m in sys.modules if sys.modules[m]]
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and "ok" in res.stdout, res.stdout + res.stderr
    # The reference reads the same file (with ml_dtypes, through jax).
    got = JCheckpointer(str(tmp_path)).restore(
        2, (jnp.zeros((64, 32), jnp.bfloat16),
            {"f": jnp.zeros(16, jnp.float8_e4m3fn),
             "g": jnp.zeros(16, jnp.float8_e5m2)}))
    assert got[0].dtype == jnp.bfloat16 and got[1]["g"].shape == (16,)


# ---------------------------------------------------------------------------
# The Trainer
# ---------------------------------------------------------------------------


def _cfg():
    return dataclasses.replace(reduced(get_config("llama3-8b")), vocab=128)


def _trainer(d, total_steps, ckpt_every=50, **kw):
    return Trainer(
        _cfg(), paper_default("tensor"),
        TrainConfig(optimizer=tadamw.AdamWConfig(
            peak_lr=1e-3, final_lr=1e-4, warmup_steps=5, total_steps=200)),
        TrainerConfig(total_steps=total_steps,
                      ckpt_dir=None if d is None else str(d),
                      ckpt_every=ckpt_every, **kw),
        DataConfig(vocab=128, seq_len=32, global_batch=4), device="cpu")


def test_trainer_restart_resumes_bitexact(tmp_path):
    """A run of 4 steps (checkpoints at 2 and 4), then a new Trainer on
    the same directory up to 6: it resumes at 4, and its losses, params
    and OptState equal the unbroken 6-step run's bit for bit."""
    d = tmp_path / "b"
    r1 = _trainer(d, 4, ckpt_every=2).run()
    assert sorted(os.listdir(d)) == ["step_2", "step_4"]
    assert r1["final_step"] == 4
    r2 = _trainer(d, 6, ckpt_every=2).run()
    assert r2["history"][0]["step"] == 4 and r2["final_step"] == 6
    assert latest_step(str(d)) == 6
    r3 = _trainer(None, 6).run()
    assert [h["loss"] for h in r2["history"]] == \
        [h["loss"] for h in r3["history"][4:]]
    _assert_tree_bitexact(r2["params"], r3["params"])
    _assert_tree_bitexact(r2["opt_state"], r3["opt_state"])


def test_trainer_straggler_watchdog(tmp_path):
    """A step over straggler_factor x the trailing median (after 8 steps)
    reaches the callback with its step and ratio; steps at the median do
    not. The train step is a stand-in that sleeps."""
    import time
    hits = []
    tr = _trainer(None, 12, straggler_factor=3.0)
    tr.straggler_cb = lambda step, ratio: hits.append((step, ratio))

    def fake_step(params, opt, batch):
        time.sleep(0.2 if len(tr.history) == 10 else 0.01)
        return params, opt, {"loss": torch.tensor(1.0)}

    tr.step_fn = fake_step
    tr.run()
    assert [s for s, _ in hits] == [10] and hits[0][1] > 3.0


def _preempt_at(trainer, call, wrap=lambda f: f):
    """Wrap the trainer's step so that its ``call``-th call (from 0) sends
    this process SIGTERM before it runs."""
    inner = trainer.step_fn
    n = [0]

    def step(*a):
        if n[0] == call:
            os.kill(os.getpid(), signal.SIGTERM)
        n[0] += 1
        return inner(*a)

    trainer.step_fn = wrap(step)


def test_preempted_run_saves_once_under_the_step_it_reached(tmp_path):
    """SIGTERM during the third step of 8. The reference saves at step 3
    and again under total_steps: latest_step is 8 and holds step 3's
    state, so a restart would take no step. The port saves step 3 only,
    and a restart resumes there and reaches step 8."""
    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.core import BF16_BASELINE
    from repro.data.pipeline import DataConfig as JDataConfig
    from repro.train import TrainConfig as JTrainConfig
    from repro.train.trainer import Trainer as JTrainer
    from repro.train.trainer import TrainerConfig as JTrainerConfig

    old = signal.getsignal(signal.SIGTERM)
    try:
        jd = tmp_path / "jax"
        # One layer, no quantization: the checkpoint logic is under test,
        # and the reference's train step compiles in a few seconds.
        jcfg = dataclasses.replace(jreduced(jget_config("llama3-8b")),
                                   vocab=128, n_layers=1)
        jt = JTrainer(
            jcfg, BF16_BASELINE,
            JTrainConfig(optimizer=jadamw.AdamWConfig(warmup_steps=5)),
            JTrainerConfig(total_steps=8, ckpt_dir=str(jd)),
            JDataConfig(vocab=128, seq_len=32, global_batch=4))
        _preempt_at(jt, 2)
        out = jt.run()
        assert out["final_step"] == 3
        assert sorted(os.listdir(jd)) == ["step_3", "step_8"]
        assert jlatest_step(str(jd)) == 8
        # The reference's step_8 holds the state after 3 steps.
        assert int(np.asarray(np.load(jd / "step_8" / "arrays.npz")[
            "[1].step"])) == 3
        signal.signal(signal.SIGTERM, old)

        td = tmp_path / "port"
        tt = _trainer(td, 8)
        _preempt_at(tt, 2)
        out = tt.run()
        assert out["final_step"] == 3 and int(out["opt_state"].step) == 3
        assert sorted(os.listdir(td)) == ["step_3"]
        assert latest_step(str(td)) == 3
        assert signal.getsignal(signal.SIGTERM) is old  # restored
        out = _trainer(td, 8).run()
        assert [h["step"] for h in out["history"]] == [3, 4, 5, 6, 7]
        assert int(out["opt_state"].step) == 8 and out["final_step"] == 8
        assert latest_step(str(td)) == 8
    finally:
        signal.signal(signal.SIGTERM, old)
