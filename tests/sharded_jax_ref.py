"""The JAX reference's side of ``tests/test_torch_sharded.py``:

    python tests/sharded_jax_ref.py OUT_DIR

Run with 4 forced host devices (``repro.launch.mesh.host_device_env``).
Writes ``OUT_DIR/params.npz`` first (the train step's parameters, for
the port's ranks), then ``OUT_DIR/ref.npz``: the single-device results
of the quantization and ``mor_dot`` cases (the invariance contract's
bar), the reference's train step inside ``compat_shard_map`` on the
'data' axis (per-shard metrics, stats, gradients and master out as
P('data')) and each shard's step on one device (its gradients), its
``all_gather_over`` / ``global_size`` / ``psum_over`` inside
``shard_map``, its ``pmax_over`` of a NaN on each shard in turn, its
single-device and sharded ``mixed_gemm`` of the 256 x 256 case, the
error its ``Engine(mesh=)`` raises at its first step, its
``make_pod_compressed_psum`` inside ``compat_shard_map`` on the (pod 2,
data 2) mesh (each device's pack lanes and sum, and the sum of the
single-device packs of each pod's whole gradient), and each device's
shards of a reduced llama3-8b checkpoint after ``reshard_tree`` and
``elastic_restore``. The checkpoint
(``OUT_DIR/ckpt``, the reference's ``Checkpointer``) is written before
``params.npz``, so both are there when the port's ranks start. Every
output is read whole with ``np.asarray`` before it is indexed (eager
indexing of a sharded array raises under JAX 0.9). The
XLA lowering throughout (``REPRO_KERNEL_INTERPRET=0``), compiled with
XLA's excess precision off. The cases compile and run on a pool of
threads (XLA compiles with the interpreter lock released).
"""
import concurrent.futures
import os
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

import sharded_cases as C
from repro.core.collectives import (all_gather_over, compat_shard_map,
                                    global_size, pmax_over, psum_over)
from repro.core.linear import mor_dot, new_token
from repro.core.mor import mor_quantize, quantize_for_gemm
from repro.core.policy import MoRDotPolicy, MoRPolicy

NOEX = {"xla_allow_excess_precision": False}


def jit_ref(fn, **kw):
    return jax.jit(fn, compiler_options=NOEX, **kw)


def f32(a):
    return np.asarray(a, np.float32)


def quant_case(out, key, case):
    rec, algo, th = case
    x = jnp.asarray(C.quant_input(), jnp.bfloat16)
    pol = MoRPolicy(recipe=rec, partition="block", block_shape=C.BLOCK,
                    algo=algo, threshold=th)
    y, s = jit_ref(lambda a: mor_quantize(a, pol))(x)
    out[f"{key}/y"], out[f"{key}/stats"] = f32(y), f32(s)
    if rec == "off":
        return
    mo, s2 = jit_ref(lambda a: quantize_for_gemm(a, pol))(x)
    out[f"{key}/gemm_stats"] = f32(s2)
    for lane in ("tags", "scales", "payload_q", "payload_bf16",
                 "payload_nib", "micro_scales"):
        a = getattr(mo, lane)
        floating = jnp.issubdtype(a.dtype, jnp.floating)
        out[f"{key}/{lane}"] = f32(a) if floating else np.asarray(a)


def dot_run(p):
    def run(x, w, dy):
        (y, st), vjp = jax.vjp(lambda a, b, t: mor_dot(a, b, t, p), x, w,
                               new_token())
        dx, dw, dtok = vjp((dy, jnp.zeros_like(st)))
        return y, st, dx, dw, dtok
    return run


def dot_case(out, kind, rec, fuse):
    """mor_dot (``kind`` 'dot') or its vmap over an E = 2 stack
    ('experts'), forward and both backward GEMMs, on one device."""
    inputs = C.dot_inputs() if kind == "dot" else C.expert_inputs()
    x, w, dy = (jnp.asarray(a, jnp.bfloat16) for a in inputs)
    pol = MoRPolicy(recipe=rec, partition="block", block_shape=C.BLOCK)
    run = dot_run(MoRDotPolicy(act=pol, weight=pol, grad=pol,
                               fuse_gemm=fuse))
    res = jit_ref(jax.vmap(run) if kind == "experts" else run)(x, w, dy)
    for k, v in zip(("y", "stats", "dx", "dw", "tok"), res):
        out[f"{kind}/{rec}/{int(fuse)}/{k}"] = f32(v)


# The train step's gradients, captured by its grad_fault hook while one
# thread traces it.
_CAPTURED = threading.local()


def _capture(grads, batch):
    _CAPTURED.grads = grads
    return grads


def _patch_summarize():
    """Make the reference step's metrics carry its raw forward and
    backward stats trees and its gradients (captured above), so that the
    shard_map can return them per shard."""
    from repro.train import train_step as ts

    summarize = ts.summarize_mor_stats

    def with_trees(fwd, bwd, opt=None):
        m = summarize(fwd, bwd, opt)
        return {**m, "_fwd": fwd, "_bwd": bwd, "_grads": _CAPTURED.grads}

    ts.summarize_mor_stats = with_trees


def train_params(out_dir):
    """The train-step config and its init_params draw, also saved as
    ``OUT_DIR/params.npz`` for the port's ranks (bf16 leaves as their
    uint16 bits; written whole, then renamed into place)."""
    import dataclasses

    from repro.configs import get_config, reduced
    from repro.models import init_params

    cfg = dataclasses.replace(reduced(get_config("llama3-8b")),
                              **C.TRAIN_OVER)
    params = jit_ref(lambda k: init_params(cfg, k))(jax.random.PRNGKey(0))
    flat = C.flatten(jax.tree.map(np.asarray, params))
    part = os.path.join(out_dir, "params.part.npz")
    np.savez(part, **{k: v.view(np.uint16) if v.dtype.name == "bfloat16"
                      else v for k, v in flat.items()})
    os.replace(part, os.path.join(out_dir, "params.npz"))
    return cfg, params


def _step(cfg, name, axes):
    from repro.core.policy import paper_default
    from repro.optim import AdamWConfig
    from repro.train import TrainConfig, make_train_step

    return make_train_step(cfg, paper_default(name), TrainConfig(
        optimizer=AdamWConfig(warmup_steps=1), remat=False,
        zero2_grads=False, mor_mesh_axes=axes), grad_fault=_capture)


def train_case(out, cfg, params, mesh, name):
    from repro.optim import init_opt_state

    batch = {k: jnp.asarray(v, jnp.int32)
             for k, v in C.train_batch(cfg.vocab).items()}
    step = _step(cfg, name, ("data",))

    def body(p, opt, b):
        _, new_opt, m = step(p, opt, b)
        return jax.tree.map(lambda a: a[None], (m, new_opt.master))

    sm = compat_shard_map(body, mesh, (P(), P(), P("data", None)),
                          P("data"))
    m, master = jit_ref(sm)(params, init_opt_state(params), batch)
    fwd, bwd, grads = m.pop("_fwd"), m.pop("_bwd"), m.pop("_grads")
    for k, v in m.items():
        out[f"train/{name}/metrics/{k}"] = f32(v)
    for what, tree in (("fwd", fwd), ("bwd", bwd), ("grads", grads),
                       ("master", master)):
        for k, v in C.flatten(tree).items():
            out[f"train/{name}/{what}/{k}"] = f32(v)


def single_case(out, cfg, params, name):
    """Each shard's step on one device (no mesh axes): its gradients."""
    from repro.optim import init_opt_state

    step = _step(cfg, name, ())
    run = jit_ref(lambda p, opt, b: step(p, opt, b)[2]["_grads"])
    shards = [C.flatten(run(params, init_opt_state(params), {
        k: jnp.asarray(C.rows(v, r), jnp.int32)
        for k, v in C.train_batch(cfg.vocab).items()}))
        for r in range(C.WORLD)]
    for k in shards[0]:
        out[f"train/{name}/single_grads/{k}"] = np.stack(
            [f32(s[k]) for s in shards])


def collective_case(out, mesh, pod_mesh):
    v = jnp.asarray([[float(r), 10.0 * r + 1.0] for r in range(C.WORLD)],
                    jnp.float32)

    def data_body(a):
        a = a[0]
        return jax.tree.map(lambda t: t[None], (
            all_gather_over(a, "data"), all_gather_over(a, None),
            global_size(1000, ("data",)), global_size(7, ()),
            psum_over(a, ("data",))))

    res = jit_ref(compat_shard_map(data_body, mesh, P("data"),
                                   P("data")))(v)
    for k, r in zip(("gather_data", "gather_none", "size_data",
                     "size_none", "psum_data"), res):
        out[f"coll/{k}"] = f32(r)

    def pod_body(a):
        a = a[0]
        return jax.tree.map(lambda t: t[None], (
            all_gather_over(a, "pod"), all_gather_over(a, "data"),
            global_size(1000, ("data", "pod")), psum_over(a, ("pod",))))

    res = jit_ref(compat_shard_map(pod_body, pod_mesh, P(("pod", "data")),
                                   P(("pod", "data"))))(v)
    for k, r in zip(("pod_gather_pod", "pod_gather_data", "pod_size",
                     "pod_psum_pod"), res):
        out[f"coll/{k}"] = f32(r)

    pmax = jit_ref(compat_shard_map(lambda a: pmax_over(a, ("data",)), mesh,
                                    P("data"), P("data")))
    stats = {rec: jit_ref(lambda a, p=MoRPolicy(
        recipe=rec, partition="block", block_shape=C.BLOCK):
        mor_quantize(a, p)[1]) for rec in ("tensor", "sub3", "off")}
    for at in range(C.WORLD):
        vals = np.arange(C.WORLD, dtype=np.float32)
        vals[at] = np.nan
        out[f"nan/pmax/{at}"] = f32(pmax(jnp.asarray(vals)))
        x = jnp.asarray(C.nan_input(at), jnp.bfloat16)
        for rec, fn in stats.items():
            out[f"nan/{rec}/{at}"] = f32(fn(x))


def gemm_case(out, mesh, mesh22):
    """The single-device mixed_gemm and the reference's sharded_mixed_gemm
    of each lane (inside its shard_map) and of the 2 x 2 mesh."""
    from repro.kernels import ops as kops
    from repro.kernels.ref import passthrough_mixed

    w, x = (jnp.asarray(a, jnp.bfloat16) for a in C.gemm_inputs())
    mo, _ = quantize_for_gemm(w, MoRPolicy(recipe="sub3", partition="block",
                                           block_shape=C.BLOCK))
    a = passthrough_mixed(x, C.BLOCK)
    out["gemm/single"] = f32(jit_ref(kops.mixed_gemm)(a, mo))
    for name, kw, m in [(n, k, mesh) for n, k in C.GEMM_CASES] + [
            ("2x2", C.GEMM_2X2, mesh22)]:
        out[f"gemm/{name}"] = f32(jit_ref(
            lambda p, q, m=m, kw=kw: kops.sharded_mixed_gemm(
                p, q, mesh=m, **kw))(a, mo))


def engine_case(out, mesh):
    """The reference's Engine(mesh=) on a (data 1, model 4) mesh at the
    port's engine shape: its first step fails at the vocab-sharded embed
    gather (a ShardingTypeError under this JAX), before any GEMM, so the
    params stay dense here (quantized ones fail at the same gather)."""
    import dataclasses

    from repro.configs import get_config, reduced
    from repro.core.policy import BF16_BASELINE
    from repro.models import init_params
    from repro.serve.engine import Engine, Request, ServeConfig

    cfg = dataclasses.replace(reduced(get_config("llama3-8b")),
                              **C.ENGINE_OVER)
    params = jit_ref(lambda k: init_params(cfg, k))(jax.random.PRNGKey(0))
    eng = Engine(cfg, BF16_BASELINE, params,
                 ServeConfig(slots=C.ENGINE_SLOTS, max_seq=128), mesh=mesh)
    eng.submit(Request(rid=0, prompt=C.engine_prompts(cfg.vocab)[0],
                       max_tokens=C.ENGINE_NEW))
    try:
        eng.step()
        out["engine_error"] = np.array("no error")
    except Exception as e:  # the reference's failure, recorded by name
        out["engine_error"] = np.array(f"{type(e).__name__}: {e}"[:400])


def pod_psum_case(out, pod_mesh, name):
    """make_pod_compressed_psum('pod', policy, inner_axes=('data',)) of
    case ``name`` inside compat_shard_map (tests/test_compress_psum.py's
    body): every device's sum and its local pack's lanes, as bits, a
    device a row; the single-device bar, the f32 sum of each pod's whole
    gradient's pack, decoded. The flat path (policy None, each device its
    pod's whole gradient, tests/test_distributed.py): every device's
    sum."""
    from repro.optim.compress import leaf2d, make_pod_compressed_psum

    g = jnp.asarray(C.pod_grads(name))
    dev = P(("pod", "data"))
    key = f"podsum/{name}/"
    if name == "flat":
        psum = make_pod_compressed_psum("pod")
        res = jit_ref(compat_shard_map(lambda a: psum(a[0])[None], pod_mesh,
                                       P("pod"), dev))(g)
        out[key + "sum"] = C.bits(np.asarray(res))
        return
    recipe, split = C.POD_PSUM_CASES[name]
    pol = MoRPolicy(recipe=recipe, backend="xla")
    psum = make_pod_compressed_psum("pod", policy=pol, inner_axes=("data",))
    pol_sh = pol.replace(mesh_axes=("data",))

    def body(a):
        mo, _ = quantize_for_gemm(leaf2d(a[0]).astype(jnp.bfloat16), pol_sh)
        return psum(a[0])[None], tuple(getattr(mo, l)[None]
                                       for l in C.POD_LANES)

    spec = P("pod", "data" if split else None, None)
    total, lanes = jit_ref(compat_shard_map(body, pod_mesh, spec,
                                            (dev, (dev,) * 6)))(g)
    out[key + "sum"] = C.bits(np.asarray(total))
    for lane, a in zip(C.POD_LANES, lanes):
        out[key + lane] = C.bits(np.asarray(a))
    pack = jit_ref(lambda a: quantize_for_gemm(
        leaf2d(a).astype(jnp.bfloat16), pol)[0].dequant().astype(
            jnp.float32))
    out[key + "single_sum"] = C.bits(np.asarray(pack(g[0]) + pack(g[1])))


def elastic_cfg():
    import dataclasses

    from repro.configs import get_config, reduced

    return dataclasses.replace(reduced(get_config("llama3-8b")),
                               **C.ELASTIC_OVER)


def elastic_save(out_dir):
    """The reduced llama3-8b params of ELASTIC_OVER, saved by the
    reference's Checkpointer under ``OUT_DIR/ckpt`` at ELASTIC_STEP."""
    from repro.checkpoint import Checkpointer
    from repro.models import init_params

    cfg = elastic_cfg()
    params = jit_ref(lambda k: init_params(cfg, k))(jax.random.PRNGKey(2))
    Checkpointer(os.path.join(out_dir, "ckpt"), async_save=False).save(
        C.ELASTIC_STEP, params)
    return params


def _device_shards(out, key, tree):
    """Every device's shard of every leaf of ``tree``, as bits, under
    ``key/leaf/device id``."""
    for k, a in C.flatten(tree).items():
        for sh in a.addressable_shards:
            out[f"{key}/{k}/{sh.device.id}"] = C.bits(np.asarray(sh.data))


def elastic_case(out, out_dir, params):
    """reshard_tree of the restored checkpoint on make_elastic_mesh(
    devices, prefer_model=2) for each of ELASTIC_MESHES, and
    elastic_restore for each of ELASTIC_RESTORES: each device's
    shards."""
    from repro.checkpoint import Checkpointer
    from repro.sharding import rules
    from repro.sharding.elastic import (elastic_restore, make_elastic_mesh,
                                        reshard_tree)

    cfg = elastic_cfg()
    ck = Checkpointer(os.path.join(out_dir, "ckpt"), async_save=False)
    devices = jax.devices()
    for name, ranks in C.ELASTIC_MESHES.items():
        mesh = make_elastic_mesh([devices[r] for r in ranks], prefer_model=2)
        out[f"elastic/{name}/shape"] = np.array(mesh.devices.shape)
        host = ck.restore(C.ELASTIC_STEP, params)
        _device_shards(out, f"elastic/{name}", reshard_tree(
            host, rules.param_specs(cfg, host), mesh))
    for name, ranks in C.ELASTIC_RESTORES.items():
        tree, mesh = elastic_restore(ck, C.ELASTIC_STEP, params, cfg,
                                     [devices[r] for r in ranks])
        out[f"elastic/{name}/shape"] = np.array(mesh.devices.shape)
        _device_shards(out, f"elastic/{name}", tree)


def main():
    out_dir = sys.argv[1]
    assert len(jax.devices()) == C.WORLD, jax.devices()
    mesh = jax.make_mesh((C.WORLD,), ("data",))
    pod_mesh = jax.make_mesh((2, 2), ("pod", "data"))
    out = {}
    _patch_summarize()
    elastic_params = elastic_save(out_dir)
    cfg, params = train_params(out_dir)
    tasks = [(train_case, out, cfg, params, mesh, n)
             for n in C.TRAIN_POLICIES]
    tasks += [(single_case, out, cfg, params, C.SINGLE_POLICY)]
    tasks += [(dot_case, out, "dot", r, f) for r, f in C.DOT_CASES]
    tasks += [(dot_case, out, "experts", r, f) for r, f in C.EXPERT_CASES]
    tasks += [(quant_case, out, f"quant/{i}", c)
              for i, c in enumerate(C.QUANT_CASES)]
    tp_mesh = jax.make_mesh((1, C.WORLD), ("data", "model"))
    tasks += [(quant_case, out, "pod/0", C.POD_CASE),
              (collective_case, out, mesh, pod_mesh),
              (gemm_case, out, mesh, jax.make_mesh((2, 2),
                                                   ("data", "model"))),
              (engine_case, out, tp_mesh),
              (elastic_case, out, out_dir, elastic_params)]
    tasks += [(pod_psum_case, out, pod_mesh, n)
              for n in list(C.POD_PSUM_CASES) + ["flat"]]
    with concurrent.futures.ThreadPoolExecutor(6) as pool:
        for f in [pool.submit(*t) for t in tasks]:
            f.result()
    np.savez(os.path.join(out_dir, "ref.npz"), **out)


if __name__ == "__main__":
    main()
