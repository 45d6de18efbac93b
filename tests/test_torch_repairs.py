"""Faults of the port against the JAX reference, each held against it
on the CPU (and, where the fault was device-dependent, on the card):

* ``mor_dot`` with a real-quantized (``QTensor``) weight: the forward
  serves as before (same values and zero stats, no error without a
  gradient), and a backward raises the reference's
  ``NotImplementedError`` with its message, where the port used to
  differentiate the plain version's ops (CPU) or drop x's gradient
  (CUDA).
* tanh-approximate gelu in bf16 (``models.common.activation('gelu')`` /
  ``'geglu'``): bit for bit against compiled ``jax.nn.gelu(approximate=
  True)`` forward and backward, over every finite bf16 value whose
  result stays a normal number (XLA on the CPU flushes f32 denormals, so
  inputs below 2^-124 in magnitude, whose results are denormal, are left
  out); f32 within a few ulps of XLA's own tanh.
* ``QTensor.is_quantized`` as the reference's ("any block stored as
  fp8").
* ``core.linear._dot`` turns cuBLAS's reduced-precision bf16 reduction
  off for its own call only (card); the port's f32 matmuls (attention,
  the f32 head, ``_dot``'s f32 branch) turn TF32 off for their own call
  only (``core.device.ieee_f32_matmul``; card).
* Parameters of the reference that the port dropped, which gave
  reference-style callers a ``TypeError``: ``adamw_update(decay_mask=)``
  is ported (bit for bit against JAX on master and moments);
  ``tile=``, ``zero2_grads``, ``decision_cache_steps`` and ``log_every``
  are accepted and ignored; ``aux_coef`` takes any value (the dense
  models' aux loss is 0); ``ckpt_every``, ``keep``, ``mor_mesh_axes``
  and ``grad_fault`` do nothing at the reference's defaults and raise
  ``NotImplementedError`` naming the reference module they wait for
  otherwise.

The JAX side is compiled whole with excess precision off (``jit_ref``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import linear as jlin
from repro.core.policy import MoRDotPolicy as JDotPolicy
from repro.core.policy import MoRPolicy as JPolicy
from repro.serve import quantized as jq
from repro_torch.core import linear as tlin
from repro_torch.core.policy import MoRDotPolicy, MoRPolicy
from repro_torch.kernels import ops as tops
from repro_torch.models.common import activation, glu_split
from repro_torch.serve import quantized as tq

SERVE_ERR = ("mor_dot cannot differentiate through a real-quantized "
             "(QTensor) serving weight")


def jit_ref(fn):
    """``fn`` compiled by XLA with its excess precision off."""
    return jax.jit(fn, compiler_options={"xla_allow_excess_precision": False})


def to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(a.copy())


def bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        a = a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def served(seed=0):
    """One (K, N) = (256, 192) weight served as a sub3 QTensor by both
    packages, and a (2, 5, 256) bf16 activation."""
    rng = np.random.default_rng(seed)
    wj = jnp.asarray(rng.standard_normal((256, 192)) * 0.02, jnp.bfloat16)
    xj = jnp.asarray(rng.standard_normal((2, 5, 256)), jnp.bfloat16)
    qj, _ = jq.quantize_weight(wj, JPolicy(recipe="sub3", block_shape=(64, 64),
                                           backend="xla"))
    qt, _ = tq.quantize_weight(to_torch(wj), MoRPolicy(recipe="sub3",
                                                       block_shape=(64, 64)))
    return xj, qj, qt


def test_qtensor_backward_raises_the_reference_error():
    """A gradient through a QTensor weight raises NotImplementedError with
    the reference's message in both packages."""
    xj, qj, qt = served()
    pol_j = JDotPolicy(weight=JPolicy(backend="xla"))

    def loss_j(x):
        y, _ = jlin.mor_dot(x, qj, jlin.new_token(), pol_j)
        return jnp.sum(y.astype(jnp.float32))

    with pytest.raises(NotImplementedError) as ej:
        jax.grad(loss_j)(xj)
    xt = to_torch(xj).requires_grad_(True)
    y, st = tlin.mor_dot(xt, qt, None, MoRDotPolicy())
    assert y.requires_grad and not st.requires_grad
    with pytest.raises(NotImplementedError) as et:
        y.float().sum().backward()
    assert str(et.value) == str(ej.value) == SERVE_ERR
    assert xt.grad is None


@pytest.mark.parametrize("grad", (False, True))
def test_qtensor_forward_unchanged(grad):
    """The serving forward: the mixed GEMM's values (the same call as
    ``ops.mixed_dot``, one launch of the plain version on the CPU), zero
    stats, within the reference's qdot; no error where nothing asks for a
    gradient."""
    from repro_torch.kernels.ref import mixed_gemm_ref
    xj, qj, qt = served(1)
    xt = to_torch(xj).requires_grad_(grad)
    calls = mixed_gemm_ref.calls
    y, st = tlin.mor_dot(xt, qt, None, MoRDotPolicy())
    assert mixed_gemm_ref.calls == calls + 1
    want = tops.mixed_dot(xt.detach().reshape(10, 256), qt.mo,
                          out_dtype=torch.bfloat16).reshape(2, 5, 192)
    np.testing.assert_array_equal(bits(y), bits(want))
    assert y.requires_grad == grad and y.dtype == torch.bfloat16
    assert not st.requires_grad and not bool(st.any())
    assert tuple(st.shape) == (tlin.N_FWD_EVENTS, st.shape[1])
    yj = jit_ref(lambda x, q: jq.qdot(x, q, backend="xla"))(xj, qj)
    yj32 = np.asarray(yj).astype(np.float32)
    scale = np.abs(np.asarray(xj).astype(np.float64)).reshape(10, 256) @ \
        np.abs(qt.dequant().double().numpy())
    tol = 1e-6 * scale.reshape(2, 5, 192) + 2.0**-7 * np.abs(yj32)
    assert np.all(np.abs(y.detach().float().numpy() - yj32) <= tol)
    with torch.no_grad():
        y2, _ = tlin.mor_dot(xt, qt, None, MoRDotPolicy())
    np.testing.assert_array_equal(bits(y2), bits(want))


@pytest.mark.cuda
def test_qtensor_backward_raises_on_card(cuda_device):
    """On the card the kernel's output now carries the serving Function's
    grad_fn, so a backward raises instead of leaving x without one."""
    _, _, qt = served(2)
    qt = tq.QTensor(tq.MixedOperand(**{
        **qt.mo.__dict__,
        **{lane: getattr(qt.mo, lane).to(cuda_device) for lane in tq._LANES}}),
        qt.stats.to(cuda_device), qt.shape)
    x = torch.randn(4, 256, device=cuda_device).to(torch.bfloat16)
    x.requires_grad_(True)
    y, st = tlin.mor_dot(x, qt, None, MoRDotPolicy())
    assert y.is_cuda and y.requires_grad and not st.requires_grad
    with pytest.raises(NotImplementedError, match="QTensor"):
        y.float().sum().backward()


def _gelu_ref(x, g):
    y, vjp = jax.vjp(lambda v: jax.nn.gelu(v, approximate=True), x)
    return y, vjp(g)[0]


def _normal_bf16():
    """Every finite bf16 value of magnitude >= 2^-124, and zero."""
    b = np.arange(1 << 16, dtype=np.uint16)
    f = b.view(jnp.bfloat16).astype(np.float32)
    keep = np.isfinite(f) & ((np.abs(f) >= 2.0**-124) | (f == 0))
    return b[keep]


def _same(a, b):
    """Bit for bit, two NaNs of any payload counting as equal."""
    a, b = np.asarray(a).astype(np.float32), np.asarray(b).astype(np.float32)
    nan = np.isnan(a) & np.isnan(b)
    return int(((a.view(np.uint32) != b.view(np.uint32)) & ~nan).sum())


def test_gelu_bf16_bit_exact_forward_and_backward():
    xb = _normal_bf16()
    rng = np.random.default_rng(0)
    xj = jnp.asarray(xb.view(jnp.bfloat16))
    gj = jnp.asarray(rng.standard_normal(xb.shape[0]), jnp.bfloat16)
    yj, dj = jit_ref(_gelu_ref)(xj, gj)
    xt = to_torch(xj).requires_grad_(True)
    yt = activation("gelu")(xt)
    yt.backward(to_torch(gj))
    assert yt.dtype == torch.bfloat16 and xt.grad.dtype == torch.bfloat16
    assert _same(yj, yt.detach().float()) == 0
    assert _same(dj, xt.grad.float()) == 0
    # The one-rounding F.gelu the port used before differs in many.
    old = torch.nn.functional.gelu(xt.detach(), approximate="tanh")
    assert _same(yj, old.float()) > 1000


def test_gelu_f32_matches_to_rounding():
    """f32: the same chain against XLA's. The one op that differs is tanh:
    XLA computes it with its own approximation and returns +-1 exactly
    beyond |h| ~ 7.9, so the two differ by up to ~4.5 ulps of 1 (at most
    2^-21). Carried through the chain (dy/di = x / 2; |d dx/di| <= |g|
    (1/2 + c2 |x| (1 + 3 c1 x^2))) that moves y by at most 2^-22 |x| and
    dx by at most 2^-21 |g| (1 + |x| (1 + 0.135 x^2)), near zero where
    1 + tanh cancels as well. Each result is held to that plus 4 ulps of
    its own rounding (relative 2^-21)."""
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.standard_normal(4096) * s for s in
                        (0.01, 1.0, 4.0, 30.0)]).astype(np.float32)
    g = rng.standard_normal(x.shape[0]).astype(np.float32)
    yj, dj = jit_ref(_gelu_ref)(jnp.asarray(x), jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    yt = activation("gelu")(xt)
    yt.backward(torch.from_numpy(g))
    ax, ag = np.abs(x).astype(np.float64), np.abs(g).astype(np.float64)
    for want, got, slack in (
            (yj, yt.detach(), 2.0**-22 * ax),
            (dj, xt.grad, 2.0**-21 * ag * (ax * (1 + 0.135 * ax**2) + 1))):
        want = np.asarray(want).astype(np.float64)
        err = np.abs(got.numpy().astype(np.float64) - want)
        assert np.all(err <= slack + 2.0**-21 * np.abs(want) + 1e-37)


def test_geglu_glu_split_bit_exact():
    """The gated form: gelu(gate) * up over a (4, 2 x 96) fc1 output, the
    reference's ``glu_split`` forward and backward bit for bit."""
    from repro.models.common import activation as jact
    from repro.models.common import glu_split as jglu
    rng = np.random.default_rng(2)
    hj = jnp.asarray(rng.standard_normal((4, 192)) * 3, jnp.bfloat16)
    gj = jnp.asarray(rng.standard_normal((4, 96)), jnp.bfloat16)

    def ref(h, g):
        y, vjp = jax.vjp(lambda v: jglu(v, True, jact("geglu")), h)
        return y, vjp(g)[0]

    yj, dj = jit_ref(ref)(hj, gj)
    ht = to_torch(hj).requires_grad_(True)
    yt = glu_split(ht, True, activation("geglu"))
    yt.backward(to_torch(gj))
    np.testing.assert_array_equal(bits(yt), bits(yj))
    np.testing.assert_array_equal(bits(ht.grad), bits(dj))


def test_qtensor_is_quantized():
    """As tests/test_mixed_gemm.py holds the reference: recipe 'tensor'
    stores a normal weight all in E4M3 (quantized) and a weight of huge
    dynamic range all in BF16 (not); both packages agree."""
    from repro_torch.kernels.ref import TAG_BF16, TAG_E4M3
    rng = np.random.default_rng(1)
    w = rng.standard_normal((256, 128)).astype(np.float32)
    bad = np.exp2(rng.uniform(-30, 30, (256, 128))).astype(np.float32)
    for arr, want, tag in ((w, True, TAG_E4M3), (bad, False, TAG_BF16)):
        qj, _ = jq.quantize_weight(jnp.asarray(arr),
                                   JPolicy(recipe="tensor", backend="xla"))
        qt, st = tq.quantize_weight(torch.from_numpy(arr),
                                    MoRPolicy(recipe="tensor"))
        assert qt.is_quantized is want and qj.is_quantized is want
        assert st["quantized"] == float(want)
        assert bool((qt.tags == tag).all())


@pytest.mark.cuda
def test_dot_restores_the_reduced_precision_flag(cuda_device):
    """``_dot``'s bf16 cuBLAS GEMM runs with the reduced-precision bf16
    reduction off and leaves the caller's setting as it found it."""
    flags = torch.backends.cuda.matmul
    before = flags.allow_bf16_reduced_precision_reduction
    a = torch.randn(64, 256, device=cuda_device).to(torch.bfloat16)
    b = torch.randn(32, 256, device=cuda_device).to(torch.bfloat16)
    try:
        for user in (True, False):
            flags.allow_bf16_reduced_precision_reduction = user
            y = tlin._dot(a, b, torch.bfloat16)
            assert flags.allow_bf16_reduced_precision_reduction is user
            want = (a.float() @ b.float().T).to(torch.bfloat16)
            assert torch.equal(y, want) or bool(
                ((y.float() - want.float()).abs()
                 <= 2.0**-7 * want.float().abs() + 1e-5 * (
                     a.float().abs() @ b.float().abs().T)).all())
    finally:
        flags.allow_bf16_reduced_precision_reduction = before


TF32_SETTERS = {
    "precision_high": "torch.set_float32_matmul_precision('high')",
    "legacy_allow_tf32": "torch.backends.cuda.matmul.allow_tf32 = True",
    "new_fp32_precision": "torch.backends.cuda.matmul.fp32_precision = "
                          "'tf32'",
}


@pytest.mark.parametrize("how", TF32_SETTERS)
def test_ieee_f32_matmul_switches_tf32_off_and_restores_it(how):
    """``core.device.ieee_f32_matmul`` turns TF32 off for cuBLAS inside
    (the flag cuBLAS reads is readable and False) and leaves the caller's
    setting as it found it, whichever of PyTorch's APIs set it (each case
    in its own process: the flags are process-wide and, once the APIs
    are mixed, PyTorch refuses to read them)."""
    import os
    import subprocess
    import sys
    code = (
        "import torch, warnings\n"
        "warnings.simplefilter('ignore')\n"
        "from repro_torch.core.device import ieee_f32_matmul\n"
        "m = torch.backends.cuda.matmul\n"
        f"{TF32_SETTERS[how]}\n"
        "def state():\n"
        "    out = []\n"
        "    for f in (torch.get_float32_matmul_precision,\n"
        "              lambda: m.allow_tf32, lambda: m.fp32_precision):\n"
        "        try:\n"
        "            out.append(f())\n"
        "        except RuntimeError:\n"
        "            out.append('unreadable')\n"
        "    return out\n"
        "before = state()\n"
        "with ieee_f32_matmul():\n"
        "    inside = m.allow_tf32\n"
        "assert inside is False, inside\n"
        "assert state() == before, (state(), before)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and "ok" in res.stdout, res.stderr[-2000:]


@pytest.mark.cuda
def test_f32_matmuls_ignore_the_callers_tf32_setting(cuda_device):
    """The port's f32 matmuls (the chunked attention's einsums, the f32
    head GEMM) run in full f32 under a caller's
    ``set_float32_matmul_precision("high")``: the attention output and
    the logits are bit-identical to the "highest" run, and the caller's
    setting is as it was after each call."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.policy import paper_default
    from repro_torch.models.attention import flash_attention
    from repro_torch.models.transformer import forward, init_params
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn((2, 256, 4, 64), generator=g, device=cuda_device)
               .to(torch.bfloat16) for _ in range(3))
    cfg = reduced(get_config("llama3-8b"))
    params = init_params(cfg, seed=0, device=cuda_device)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 32), generator=g,
                                     device=cuda_device)}
    pol = paper_default("off")
    before = torch.get_float32_matmul_precision()
    outs = {}
    try:
        for prec in ("highest", "high"):
            torch.set_float32_matmul_precision(prec)
            att = flash_attention(q, k, v, q_chunk=64, k_chunk=64)
            assert torch.get_float32_matmul_precision() == prec
            logits, _, _ = forward(cfg, pol, params, batch, mode="train",
                                   remat=False)
            assert torch.get_float32_matmul_precision() == prec
            outs[prec] = (att, logits)
    finally:
        torch.set_float32_matmul_precision(before)
    for a, b in zip(outs["highest"], outs["high"]):
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a.view(torch.int32),
                           b.view(torch.int16) if b.dtype == torch.bfloat16
                           else b.view(torch.int32))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU or "
                    "interpret mode (chip_smoke.py runs them on the card)")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# Reference parameters the port dropped
# ---------------------------------------------------------------------------


def _adamw_inputs():
    """bf16 params, f32 grads of two steps, and a decay mask that differs
    from the default (ndim >= 2) rule on three of its four leaves."""
    rng = np.random.default_rng(3)
    shapes = {"layer": {"w": (8, 16), "scale": (16,)}, "emb": (4, 8),
              "stack": (2, 3, 4)}

    def tree(fn, sh):
        return {k: tree(fn, v) if isinstance(v, dict) else fn(v)
                for k, v in sh.items()}

    params = tree(lambda sh: rng.standard_normal(sh).astype(np.float32),
                  shapes)
    grads = [tree(lambda sh: rng.standard_normal(sh).astype(np.float32),
                  shapes) for _ in range(2)]
    mask = {"layer": {"w": 0.0, "scale": 1.0}, "emb": 0.0, "stack": 1.0}
    return params, grads, mask


@pytest.mark.parametrize("mask_given", (False, True), ids=("default", "mask"))
def test_adamw_decay_mask_matches_reference_bit_for_bit(mask_given):
    """Two AdamW steps with and without a non-default decay mask: master
    weights, both moments and the bf16 params equal JAX's bit for bit
    (warm-up steps, so no cosine enters the learning rate; a clip norm
    far above the gradients' norm, so the norm's f32 summation order,
    which XLA may change, does not reach the update). JAX runs op by
    op."""
    from repro.optim import adamw as jadamw
    from repro_torch.optim import adamw as tadamw
    params, grads, mask = _adamw_inputs()
    kw = {"decay_mask": mask} if mask_given else {}
    kwcfg = dict(warmup_steps=10, weight_decay=0.5, clip_norm=1e9)
    jcfg = jadamw.AdamWConfig(**kwcfg)
    tcfg = tadamw.AdamWConfig(**kwcfg)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    tp = tadamw.tree_map(lambda a: torch.from_numpy(a).to(torch.bfloat16),
                         params)
    jstate, tstate = jadamw.init_opt_state(jp), tadamw.init_opt_state(tp)
    for g in grads:
        jp, jstate, _ = jadamw.adamw_update(
            jcfg, jax.tree.map(jnp.asarray, g), jstate, **kw)
        tp, tstate, _ = tadamw.adamw_update(
            tcfg, tadamw.tree_map(torch.from_numpy, g), tstate, **kw)
    for name in ("master", "m", "v"):
        jl = jax.tree.leaves(getattr(jstate, name))
        tl = tadamw.tree_leaves(getattr(tstate, name))
        assert len(jl) == len(tl) == 4
        for a, b in zip(jl, tl):
            np.testing.assert_array_equal(bits(b), bits(a), err_msg=name)
    for a, b in zip(jax.tree.leaves(jp), tadamw.tree_leaves(tp)):
        np.testing.assert_array_equal(bits(b), bits(a))
    assert int(tstate.step) == int(jstate.step) == 2


def test_adamw_decay_mask_changes_the_update():
    """The mask is read: a leaf masked out of decay moves differently from
    the default rule's update of it."""
    from repro_torch.optim import adamw as tadamw
    params, grads, mask = _adamw_inputs()
    tp = tadamw.tree_map(lambda a: torch.from_numpy(a).to(torch.bfloat16),
                         params)
    cfg = tadamw.AdamWConfig(warmup_steps=10, weight_decay=0.5)
    g = tadamw.tree_map(torch.from_numpy, grads[0])
    _, with_mask, _ = tadamw.adamw_update(cfg, g, tadamw.init_opt_state(tp),
                                          decay_mask=mask)
    _, default, _ = tadamw.adamw_update(cfg, g, tadamw.init_opt_state(tp))
    assert not torch.equal(with_mask.master["layer"]["w"],
                           default.master["layer"]["w"])
    assert torch.equal(with_mask.master["stack"], default.master["stack"])


def _tiny_cfg():
    from repro_torch.configs import get_config, reduced
    return reduced(get_config("llama3-8b"))


@pytest.mark.parametrize("where", ("qdot", "mixed_dot", "mixed_gemm"))
def test_tile_is_accepted_and_ignored(where):
    """``tile=`` (the reference's TPU VMEM tiling) changes nothing."""
    xj, qj, qt = served()
    x = to_torch(xj)
    if where == "qdot":
        want = tq.qdot(x, qt)
        got = tq.qdot(x, qt, tile=object())
    else:
        x2 = x.reshape(-1, x.shape[-1])
        want = tops.mixed_dot(x2, qt.mo)
        if where == "mixed_dot":
            got = tops.mixed_dot(x2, qt.mo, tile=object())
        else:
            from repro_torch.kernels import ref as tref
            a = tref.passthrough_mixed(x2, (tref.activation_row_block(
                x2.shape[0], qt.mo.block[1]), qt.mo.block[1]))
            got = tops.mixed_gemm(a, qt.mo, tile=object())
    assert torch.equal(got, want)


def test_ignored_config_fields_are_accepted():
    """``decision_cache_steps``, ``zero2_grads``, ``log_every`` and any
    ``aux_coef`` are accepted; their configs build train steps and
    trainers as the defaults do."""
    from repro_torch.core.policy import paper_default
    from repro_torch.train import TrainConfig, TrainerConfig
    from repro_torch.train.train_step import make_train_step
    pol = paper_default("tensor").replace(decision_cache_steps=4)
    assert pol.decision_cache_steps == 4
    assert MoRDotPolicy(decision_cache_steps=2).enabled
    cfg = _tiny_cfg()
    for tc in (TrainConfig(zero2_grads=False), TrainConfig(aux_coef=0.5),
               TrainConfig(aux_coef=0.0)):
        assert callable(make_train_step(cfg, pol, tc))
    from repro_torch.train import Trainer
    tr = Trainer(cfg, pol, TrainConfig(), TrainerConfig(log_every=1),
                 device="cpu")
    assert tr.run_cfg.log_every == 1


def test_aux_coef_leaves_the_dense_loss_unchanged():
    """The total is loss + aux_coef * aux_loss and a dense model's aux
    loss is 0, so every aux_coef gives the cross-entropy bit for bit, as
    in the reference."""
    from repro_torch.core.policy import paper_default
    from repro_torch.models.api import init_params, make_loss_fn, make_tokens
    cfg = _tiny_cfg()
    params = init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16)))
             for k in ("tokens", "labels")}
    pol = paper_default("off")
    totals = []
    for coef in (0.01, 0.0, 3.0):
        fn = make_loss_fn(cfg, pol, remat=False, aux_coef=coef)
        total, aux = fn(params, make_tokens(cfg, device="cpu"), batch)
        assert float(aux["aux_loss"]) == 0.0
        assert torch.equal(total, aux["loss"])
        totals.append(total)
    assert torch.equal(totals[0], totals[1]) and torch.equal(totals[0],
                                                             totals[2])


@pytest.mark.parametrize("what,match", (
    pytest.param("mor_mesh_axes", "'data'",
                 id="mor_mesh_axes-repro.core.collectives"),))
def test_unported_parameters_raise_naming_their_item(what, match):
    """``mor_mesh_axes`` (ported with ``repro_torch.core.collectives``):
    a step built with it and run outside a bound mesh raises a
    ValueError naming the unbound axis, as the reference fails at trace
    time outside ``shard_map``; at the default ``()`` it does nothing.
    (``ckpt_every``, ``keep`` and ``grad_fault`` are ported:
    tests/test_torch_checkpoint.py and tests/test_torch_faults.py.)"""
    from repro_torch.core.policy import paper_default
    from repro_torch.models.api import init_params
    from repro_torch.optim import init_opt_state
    from repro_torch.train import TrainConfig, make_train_step
    cfg = _tiny_cfg()
    params = init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16)))
             for k in ("tokens", "labels")}
    step = make_train_step(cfg, paper_default("tensor"),
                           TrainConfig(**{what: ("data",)}))
    with pytest.raises(ValueError, match=match):
        step(params, init_opt_state(params), batch)
    assert TrainConfig(**{what: ()}).mor_mesh_axes == ()
    _, _, m = make_train_step(cfg, paper_default("tensor"), TrainConfig(
        **{what: ()}))(params, init_opt_state(params), batch)
    assert np.isfinite(float(m["loss"]))


def _head_inputs(device, tied, V=300, d=64):
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 16, d, generator=g).to(torch.bfloat16).to(device)
    e = (torch.randn(V, d, generator=g) if tied else
         torch.randn(d, V, generator=g)).to(torch.bfloat16).to(device)
    dlogits = torch.randn(2, 16, V, generator=g).to(device)
    return x.requires_grad_(True), e.requires_grad_(True), dlogits


def _head_today(x, e, tied, dlogits):
    """The expression the head ran before HeadMatmul: the f32 product of
    the operands cast to f32, and its autograd."""
    from repro_torch.core.device import ieee_f32_matmul
    head = e.T if tied else e
    with ieee_f32_matmul():
        y = x.to(torch.float32) @ head.to(torch.float32)
        return (y.detach(),) + torch.autograd.grad(y, (x, e), dlogits)


@pytest.mark.parametrize("tied", (False, True))
def test_head_matmul_is_the_f32_product_on_cpu(tied):
    """On the CPU (no mm.dtype kernel) the head's forward is the f32
    product, and its backward (f32 GEMMs on the f32 dlogits, cast back)
    is the old expression's bit for bit, for an untied head and a tied
    one (embed.T, column-major)."""
    from repro_torch.models.transformer import HeadMatmul
    x, e, g = _head_inputs("cpu", tied)
    y = HeadMatmul.apply(x, e.T if tied else e)
    gx, ge = torch.autograd.grad(y, (x, e), g)
    y0, gx0, ge0 = _head_today(x, e, tied, g)
    assert y.dtype == torch.float32 and torch.equal(y, y0)
    assert gx.dtype == torch.bfloat16 and ge.dtype == torch.bfloat16
    assert torch.equal(gx, gx0) and torch.equal(ge, ge0)


@pytest.mark.cuda
def test_head_matmul_forward_on_card():
    """On the card the forward is one bf16 tensor-core GEMM with an f32
    result (exact products; only the f32 summation order differs: within
    1e-5 sum |x||head|); the backward is the old expression's bit for
    bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the tensor-core forward runs on "
                    "the card only")
    from repro_torch.models.transformer import HeadMatmul
    x, e, g = _head_inputs("cuda", False, V=4096, d=1024)
    y = HeadMatmul.apply(x, e)
    gx, ge = torch.autograd.grad(y, (x, e), g)
    y0, gx0, ge0 = _head_today(x, e, False, g)
    tol = 1e-5 * (x.detach().double().abs() @ e.detach().double().abs())
    assert bool(((y.double() - y0.double()).abs() <= tol).all())
    assert torch.equal(gx, gx0) and torch.equal(ge, ge0)
