"""The port's training slice against the JAX reference on reduced llama3
(d 64, 2 layers, vocab 512), with the JAX ``init_params`` draw carried
across by ``repro_torch.convert.params_from_jax`` and the port's own
``SyntheticLM`` batches, checked token for token against the
reference's.

One ``make_train_step`` step (AdamW defaults, ``warmup_steps=1``) under
three policies: (a) ``paper_default('tensor')``, the trainer's default;
(b) ``paper_default('sub3')`` fake-quant; (c) the same with
``fuse_gemm=True``. The JAX side runs ``backend='xla'`` and is compiled
whole with XLA's excess precision off. The port runs on the CPU with
its layer remat (``torch.utils.checkpoint``) on.

Tolerances, and why:
* loss: rtol 1e-5 -- the forward differs only by f32 summation order
  in the GEMMs, attention and norms;
* the summarize_mor_stats metrics: block fractions within 1e-6 (the
  decisions agree), mean relative errors within rtol 1e-5 (ratios of
  f32 sums; the backward events see a dy that differs by summation
  order), guard counters and lr exactly, grad_norm within rtol 1e-5;
* updated f32 master weights within 1e-5 absolute (3% of the step's
  lr): the bf16 weight gradients agree bit for bit (silu's derivative
  is JAX's, ``models.common._Silu``), but the f32 gradients of the
  norm scales and the head sum in another order, and a first AdamW
  step moves a weight by lr * g / (|g| + eps), which amplifies the
  relative error of a gradient that cancels to near eps; the bf16
  parameters are the master rounded, and all but 0.1% of them equal
  the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core.policy import paper_default as jpaper_default
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import init_params as jinit_params
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import init_opt_state as jinit_opt_state
from repro.train import TrainConfig as JTrainConfig
from repro.train import make_train_step as jmake_train_step
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.core.policy import paper_default
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.optim.adamw import tree_leaves
from repro_torch.train import (Trainer, TrainerConfig, TrainConfig,
                               make_train_step)

NOEX = {"xla_allow_excess_precision": False}
DATA = dict(vocab=512, seq_len=32, global_batch=2)


def jax_policy(name):
    pol = jpaper_default("sub3" if name != "tensor" else "tensor")
    pol = pol.replace(act=pol.act.replace(backend="xla"),
                      weight=pol.weight.replace(backend="xla"),
                      grad=pol.grad.replace(backend="xla"))
    return pol.replace(fuse_gemm=(name == "fused"))


def port_policy(name):
    pol = paper_default("sub3" if name != "tensor" else "tensor")
    return pol.replace(fuse_gemm=(name == "fused"))


@pytest.fixture(scope="module")
def model():
    jcfg = jreduced(jget_config("llama3-8b"))
    cfg = reduced(get_config("llama3-8b"))
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return jcfg, cfg, jparams, tparams


def torch_batch(b):
    return {k: torch.from_numpy(v.astype(np.int64)) for k, v in b.items()}


def test_synthetic_batches_match_reference():
    jd = JSyntheticLM(JDataConfig(**DATA))
    td = SyntheticLM(DataConfig(**DATA))
    for step in (0, 1, 7):
        jb, tb = jd.batch_at(step), td.batch_at(step)
        assert set(jb) == set(tb) == {"tokens", "labels"}
        for k in jb:
            np.testing.assert_array_equal(jb[k], tb[k])


def _leaf(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


@pytest.mark.parametrize("name", ("tensor", "sub3", "fused"))
def test_train_step_matches_reference(model, name):
    jcfg, cfg, jparams, tparams = model
    batch = JSyntheticLM(JDataConfig(**DATA)).batch_at(0)
    jstep = jax.jit(jmake_train_step(
        jcfg, jax_policy(name),
        JTrainConfig(optimizer=JAdamWConfig(warmup_steps=1))),
        compiler_options=NOEX)
    _, jopt, jm = jstep(jparams, jinit_opt_state(jparams),
                        {k: jnp.asarray(v) for k, v in batch.items()})
    tstep = make_train_step(cfg, port_policy(name), TrainConfig(
        optimizer=AdamWConfig(warmup_steps=1)))
    tnew, topt, tm = tstep(tparams, init_opt_state(tparams),
                           torch_batch(batch))

    jm = {k: float(v) for k, v in jm.items()}
    tm = {k: float(v) for k, v in tm.items()}
    assert tm["loss"] == pytest.approx(jm["loss"], rel=1e-5)
    assert tm["total_loss"] == pytest.approx(jm["total_loss"], rel=1e-5)
    for k in ("fwd_frac_bf16", "bwd_frac_bf16"):
        assert tm[k] == pytest.approx(jm[k], abs=1e-6), k
    for k in ("fwd_rel_err", "bwd_rel_err"):
        assert tm[k] == pytest.approx(jm[k], rel=1e-5), k
    for k in ("guard_flag_events", "guard_fallback_blocks", "lr",
              "aux_loss"):
        assert tm[k] == jm[k], k
    assert tm["grad_norm"] == pytest.approx(jm["grad_norm"], rel=1e-5)

    flat, _ = jax.tree_util.tree_flatten_with_path(jopt.master)
    assert len(flat) == len(tree_leaves(topt.master))
    for path, leaf in flat:
        what = "/".join(k.key for k in path)
        a, b = np.asarray(leaf), _leaf(topt.master, path).numpy()
        assert np.abs(a - b).max() <= 1e-5, (what, np.abs(a - b).max())
        p = _leaf(tnew, path)
        assert p.dtype == torch.bfloat16, what
        assert torch.equal(p, _leaf(topt.master, path).to(torch.bfloat16))
        same = np.asarray(a.astype(jnp.bfloat16), np.float32) == \
            p.float().numpy()
        assert same.mean() >= 0.999, (what, same.mean())
    assert int(topt.step) == int(jopt.step) == 1


def _port_metrics(cfg, tparams, grad_accum):
    """The reference's contract (tests/test_stats_contract.py): on a
    constant batch every microbatch sees the same rows, so the reported
    stats must not depend on the grad_accum split."""
    rng = np.random.default_rng(5)
    row_t, row_l = rng.integers(0, 512, (1, 32)), rng.integers(0, 512, (1, 32))
    batch = {"tokens": torch.from_numpy(np.repeat(row_t, 4, axis=0)),
             "labels": torch.from_numpy(np.repeat(row_l, 4, axis=0))}
    step = make_train_step(cfg, paper_default("sub3"), TrainConfig(
        optimizer=AdamWConfig(peak_lr=1e-3, final_lr=1e-4, warmup_steps=2,
                              total_steps=10), grad_accum=grad_accum))
    _, _, metrics = step(tparams, init_opt_state(tparams), batch)
    return metrics


def test_grad_accum_reports_the_same_stats(model):
    _, cfg, _, tparams = model
    m1 = _port_metrics(cfg, tparams, 1)
    m2 = _port_metrics(cfg, tparams, 2)
    for key in ("fwd_frac_bf16", "fwd_rel_err", "bwd_frac_bf16",
                "bwd_rel_err", "loss"):
        a, b = float(m1[key]), float(m2[key])
        assert a == pytest.approx(b, rel=1e-5, abs=1e-6), (key, a, b)


def test_trainer_runs_on_cpu(tmp_path):
    """A few Trainer steps on the CPU: finite losses, weights moving, the
    tracker fed with one enabled event per step."""
    cfg = reduced(get_config("llama3-8b"))
    tr = Trainer(cfg, paper_default("tensor"),
                 TrainConfig(optimizer=AdamWConfig(warmup_steps=1)),
                 TrainerConfig(total_steps=3, seed=0),
                 DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=2),
                 device="cpu")
    out = tr.run()
    losses = [h["loss"] for h in out["history"]]
    assert len(losses) == 3 and np.all(np.isfinite(losses))
    assert out["final_step"] == 3 and int(out["opt_state"].step) == 3
    assert tr.tracker.total_events == 3
    assert "global" in tr.tracker.hists
    # Checkpointing is ported (tests/test_torch_checkpoint.py): the config
    # is accepted.
    tr = Trainer(cfg, paper_default("tensor"), TrainConfig(),
                 TrainerConfig(ckpt_dir=str(tmp_path / "ckpt"), ckpt_every=7,
                               keep=2), device="cpu")
    assert tr.ckpt is not None and tr.ckpt.keep == 2
    # Gradient compression is ported: the config is accepted.
    assert TrainConfig(compress_grads="fp8").compress_grads == "fp8"
