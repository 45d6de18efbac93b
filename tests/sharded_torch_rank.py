"""One rank of the port's four-rank CPU world for
``tests/test_torch_sharded.py``:

    python tests/sharded_torch_rank.py RANK STORE_FILE OUT_DIR

Joins a gloo world through the ``file://`` store, runs every case of
``sharded_cases`` on its shard under ``core.collectives.use_mesh`` and
writes ``OUT_DIR/rank{RANK}.npz``: also its blocks of the sharded mixed
GEMM, its tensor-parallel engine runs beside the one-rank engine's, the
bits every dtype's gather brings, its ``make_pod_compressed_psum`` sums
and the lanes that the collective gathered, and its blocks of the
reference's checkpoint restored onto elastic meshes. Imports torch and
the port only; the train-step parameters come from
``OUT_DIR/params.npz``, the checkpoint from ``OUT_DIR/ckpt``.
"""
import os
import sys

import numpy as np
import torch

import sharded_cases as C
from repro_torch.core import collectives as col
from repro_torch.launch.ranks import init_world
from repro_torch.core.linear import mor_dot, mor_dot_experts, new_token
from repro_torch.core.mor import mor_quantize, quantize_for_gemm
from repro_torch.core.policy import MoRDotPolicy, MoRPolicy, paper_default
from repro_torch.core.policy import with_mesh_axes


def bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16)


def f32(t):
    return t.detach().to(torch.float32).numpy()


def quant_cases(out, rank, axes, prefix, cases):
    x = bf16(C.rows(C.quant_input(), rank))
    for i, (rec, algo, th) in enumerate(cases):
        pol = MoRPolicy(recipe=rec, block_shape=C.BLOCK, algo=algo,
                        threshold=th, mesh_axes=axes)
        y, s = mor_quantize(x, pol)
        out[f"{prefix}{i}/y"], out[f"{prefix}{i}/stats"] = f32(y), f32(s)
        if rec == "off":
            continue
        mo, s2 = quantize_for_gemm(x, pol)
        out[f"{prefix}{i}/gemm_stats"] = f32(s2)
        for lane in ("tags", "scales", "payload_q", "payload_bf16",
                     "payload_nib", "micro_scales"):
            t = getattr(mo, lane)
            out[f"{prefix}{i}/{lane}"] = (f32(t) if t.is_floating_point()
                                          else t.numpy())


def dot_cases(out, rank):
    x, w, dy = C.dot_inputs()
    for rec, fuse in C.DOT_CASES:
        pol = MoRPolicy(recipe=rec, block_shape=C.BLOCK)
        dp = with_mesh_axes(MoRDotPolicy(act=pol, weight=pol, grad=pol,
                                         fuse_gemm=fuse), ("data",))
        xs = bf16(C.rows(x, rank)).requires_grad_(True)
        ws = bf16(w).requires_grad_(True)
        tok = new_token("cpu")
        y, st = mor_dot(xs, ws, tok, dp)
        y.backward(bf16(C.rows(dy, rank)))
        key = f"dot/{rec}/{int(fuse)}"
        for k, v in (("y", y), ("stats", st), ("dx", xs.grad),
                     ("dw", ws.grad), ("tok", tok.grad)):
            out[f"{key}/{k}"] = f32(v)
    x, w, dy = C.expert_inputs()
    for rec, fuse in C.EXPERT_CASES:
        pol = MoRPolicy(recipe=rec, block_shape=C.BLOCK)
        dp = with_mesh_axes(MoRDotPolicy(act=pol, weight=pol, grad=pol,
                                         fuse_gemm=fuse), ("data",))
        xs = bf16(C.rows(x, rank, axis=1)).requires_grad_(True)
        ws = bf16(w).requires_grad_(True)
        toks = torch.zeros((2, 4, 14), requires_grad=True)
        y, st = mor_dot_experts(xs, ws, toks, dp)
        y.backward(bf16(C.rows(dy, rank, axis=1)))
        key = f"experts/{rec}/{int(fuse)}"
        for k, v in (("y", y), ("stats", st), ("dx", xs.grad),
                     ("dw", ws.grad), ("tok", toks.grad)):
            out[f"{key}/{k}"] = f32(v)


def train_cases(out, rank, params_file):
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.train import TrainConfig, make_train_step
    from repro_torch.train import train_step as ts

    cfg = dataclasses.replace(reduced(get_config("llama3-8b")),
                              **C.TRAIN_OVER)
    flat = dict(np.load(params_file))
    batch = {k: torch.from_numpy(C.rows(v, rank)) for k, v in
             C.train_batch(cfg.vocab).items()}
    seen = {}

    def capture(grads, batch):
        seen["grads"] = grads
        return grads

    def summarize(fwd, bwd, opt=None):
        seen["fwd"], seen["bwd"] = fwd, bwd
        return summarize_mor_stats(fwd, bwd, opt)

    summarize_mor_stats = ts.summarize_mor_stats
    ts.summarize_mor_stats = summarize
    try:
        for name in C.TRAIN_POLICIES:
            params = C.unflatten({
                k: (torch.from_numpy(v).view(torch.bfloat16)
                    if v.dtype == np.uint16 else torch.from_numpy(v))
                for k, v in flat.items()})
            step = make_train_step(cfg, paper_default(name), TrainConfig(
                optimizer=AdamWConfig(warmup_steps=1), remat=False,
                zero2_grads=False, mor_mesh_axes=("data",)),
                grad_fault=capture)
            _, opt, metrics = step(params, init_opt_state(params), batch)
            for k, v in metrics.items():
                out[f"train/{name}/metrics/{k}"] = f32(v)
            for what, tree in (("fwd", seen["fwd"]), ("bwd", seen["bwd"]),
                               ("grads", seen["grads"]),
                               ("master", opt.master)):
                for k, v in C.flatten(tree).items():
                    out[f"train/{name}/{what}/{k}"] = f32(v)
            if name != C.SINGLE_POLICY:
                continue
            # The same shard on one device: no mesh axes, local statistics.
            single = make_train_step(cfg, paper_default(name), TrainConfig(
                optimizer=AdamWConfig(warmup_steps=1), remat=False,
                zero2_grads=False), grad_fault=capture)
            single(params, init_opt_state(params), batch)
            for k, v in C.flatten(seen["grads"]).items():
                out[f"train/{name}/single_grads/{k}"] = f32(v)
    finally:
        ts.summarize_mor_stats = summarize_mor_stats


def collective_cases(out, rank, mesh, pod_mesh):
    v = torch.tensor([float(rank), 10.0 * rank + 1.0])
    with col.use_mesh(mesh):
        out["coll/gather_data"] = col.all_gather_over(v, "data").numpy()
        out["coll/gather_none"] = col.all_gather_over(v, None).numpy()
        out["coll/size_data"] = col.global_size(1000, ("data",)).numpy()
        out["coll/size_none"] = col.global_size(7, ()).numpy()
        out["coll/psum_data"] = col.psum_over(v, ("data",)).numpy()
    with col.use_mesh(pod_mesh):
        for ax in ("pod", "data"):
            out[f"coll/pod_gather_{ax}"] = col.all_gather_over(v, ax).numpy()
        out["coll/pod_size"] = col.global_size(
            1000, ("data", "pod")).numpy()
        out["coll/pod_psum_pod"] = col.psum_over(v, ("pod",)).numpy()
    with col.use_mesh(mesh):
        for at in range(C.WORLD):
            # pmax: a NaN on rank `at`, the other ranks their own index.
            t = torch.tensor([float("nan") if rank == at else float(rank)])
            out[f"nan/pmax/{at}"] = col.pmax_over(t, ("data",)).numpy()
            x = bf16(C.rows(C.nan_input(at), rank))
            for rec in ("tensor", "sub3", "off"):
                _, s = mor_quantize(x, MoRPolicy(
                    recipe=rec, block_shape=C.BLOCK, mesh_axes=("data",)))
                out[f"nan/{rec}/{at}"] = f32(s)
        try:
            mor_quantize(bf16(C.rows(C.quant_input(), rank)), MoRPolicy(
                recipe="sub3", block_shape=C.BLOCK, mesh_axes=("model",)))
            out["unbound"] = np.array("no error")
        except ValueError as e:
            out["unbound"] = np.array(str(e))


def gemm_cases(out, rank, mesh, mesh22):
    """sharded_mixed_gemm on this rank's operands (local_mixed of the
    whole packs): its block of C for each lane, and on the 2 x 2 mesh."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import passthrough_mixed
    from repro_torch.sharding.rules import local_mixed, mixed_operand_pspec

    w, x = C.gemm_inputs()
    mo, _ = quantize_for_gemm(bf16(w), MoRPolicy(recipe="sub3",
                                                 block_shape=C.BLOCK))
    a = passthrough_mixed(bf16(x), C.BLOCK)
    for name, kw, m in [(n, k, mesh) for n, k in C.GEMM_CASES] + [
            ("2x2", C.GEMM_2X2, mesh22)]:
        al = local_mixed(a, mixed_operand_pspec(
            a, kw.get("row_axis"), kw.get("contract_axis")), m, "a")
        bl = local_mixed(mo, mixed_operand_pspec(
            mo, kw.get("col_axis"), kw.get("contract_axis")), m, "b")
        out[f"gemm/{name}"] = f32(ops.sharded_mixed_gemm(al, bl, mesh=m,
                                                         **kw))


def embed_case(out, rank, mesh):
    """ShardedEmbed.lookup of a (64, 8) table with -0.0 entries on the
    (data 1, model 4) mesh, and the sum of the ranks' masked lookups
    (what the owner-select replaces), as bf16 bits."""
    from repro_torch.serve.quantized import ShardedEmbed

    table = bf16(C.embed_table())
    ids = torch.from_numpy(C.embed_ids())
    rows = table.shape[0] // C.WORLD
    shard = ShardedEmbed(table[rank * rows:(rank + 1) * rows].clone(),
                         "model", tuple(table.shape))
    with col.use_mesh(mesh):
        out["embed/lookup"] = shard.lookup(ids).view(torch.int16).numpy()
        mine = (ids >= rank * rows) & (ids < (rank + 1) * rows)
        part = torch.where(mine[..., None],
                           shard.local[(ids - rank * rows).clamp(0, rows - 1)],
                           torch.zeros((), dtype=torch.bfloat16))
        summed = col.psum_over(part, ("model",))
    out["embed/summed"] = summed.view(torch.int16).numpy()


def _recorded(eng, calls):
    """Record every model call's logits (f32) and collectives."""
    decode = eng._decode

    def run(*args):
        before = col.COLLECTIVES["calls"]
        logits, cache, st = decode(*args)
        calls.append((f32(logits).reshape(-1),
                      col.COLLECTIVES["calls"] - before,
                      int(args[2].shape[1])))
        return logits, cache, st

    eng._decode = run


def engine_cases(out, rank, meshes):
    """Engine(mesh=) on each variant's mesh (``meshes``: {(data, model):
    Mesh}) against the one-rank Engine in this process: tokens, logits
    of every model call, weight bytes, collectives of a decode call."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.core.policy import BF16_BASELINE
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.engine import Engine, Request, ServeConfig
    from repro_torch.serve.quantized import param_bytes, replicated_bytes

    for variant, shape in C.ENGINE_VARIANTS.items():
        mesh = meshes[shape]
        cfg = dataclasses.replace(reduced(get_config("llama3-8b")),
                                  tie_embed=variant == "tied",
                                  **C.ENGINE_OVER)
        params = init_params(cfg, seed=3, device="cpu")
        res = {}
        for kind, m in (("one", None), ("tp", mesh)):
            eng = Engine(cfg, BF16_BASELINE, params,
                         ServeConfig(slots=C.ENGINE_SLOTS, max_seq=128),
                         quantize=MoRPolicy(recipe="sub3"),
                         quantize_min_size=C.ENGINE_MIN_SIZE, mesh=m,
                         device="cpu")
            calls = []
            _recorded(eng, calls)
            reqs = [Request(rid=i, prompt=p, max_tokens=C.ENGINE_NEW)
                    for i, p in enumerate(C.engine_prompts(cfg.vocab))]
            for r in reqs:
                eng.submit(r)
            eng.run_to_completion()
            res[kind] = (reqs, calls, param_bytes(eng.params))
        key = f"engine/{variant}/"
        for kind, (reqs, calls, nbytes) in res.items():
            out[key + f"tokens_{kind}"] = np.array([r.out for r in reqs])
            out[key + f"logits_{kind}"] = np.concatenate(
                [c[0] for c in calls])
            out[key + f"bytes_{kind}"] = np.array(nbytes)
        out[key + "decode_collectives"] = np.array(
            [c[1] for c in res["tp"][1] if c[2] == 1])
        out[key + "bytes_replicated"] = np.array(replicated_bytes(
            eng.params))


def raw(t):
    """A tensor's bits as numpy (``C.bits``)."""
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    elif t.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        t = t.view(torch.uint8)
    return C.bits(t.numpy())


def wire_cases(out, rank, pod_mesh):
    """all_gather_over of every dtype the pod sum ships, over each axis of
    the 2 x 2 mesh: the bits that arrive."""
    dtypes = {"float8_e4m3fn": torch.float8_e4m3fn,
              "float8_e5m2": torch.float8_e5m2, "uint8": torch.uint8,
              "bfloat16": torch.bfloat16, "float32": torch.float32,
              "scalar": torch.float32}
    ints = {1: np.uint8, 2: np.int16, 4: np.int32}
    with col.use_mesh(pod_mesh):
        for name, b in C.wire_bits(rank).items():
            dt = dtypes[name]
            t = torch.from_numpy(b.view(ints[b.itemsize]).copy()).view(dt)
            for ax in ("pod", "data"):
                g = col.all_gather_over(t, ax)
                assert g.dtype == dt, (name, g.dtype)
                out[f"wire/{name}/{ax}"] = raw(g)


def pod_psum_cases(out, rank, pod_mesh):
    """make_pod_compressed_psum('pod', ...) on this rank's leaf of each
    case: the sum, and the lanes the collective gathered (every pod's,
    ``POD_LANES`` order); the flat path's sum."""
    from repro_torch.optim import compress

    gathered = []
    gather = compress.all_gather_over

    def spy(x, axis):
        g = gather(x, axis)
        gathered.append(g)
        return g

    compress.all_gather_over = spy
    try:
        with col.use_mesh(pod_mesh):
            for name in list(C.POD_PSUM_CASES) + ["flat"]:
                pol = None if name == "flat" else MoRPolicy(
                    recipe=C.POD_PSUM_CASES[name][0])
                psum = compress.make_pod_compressed_psum(
                    "pod", policy=pol,
                    inner_axes=() if pol is None else ("data",))
                gathered.clear()
                got = psum(torch.from_numpy(C.pod_local(name, rank)))
                key = f"podsum/{name}/"
                out[key + "sum"] = raw(got)
                if pol is None:
                    continue
                assert len(gathered) == len(C.POD_LANES), len(gathered)
                for lane, g in zip(C.POD_LANES, gathered):
                    out[key + "gathered/" + lane] = raw(g)
    finally:
        compress.all_gather_over = gather


def elastic_cases(out, rank, ckpt_dir):
    """The reference's checkpoint restored onto elastic meshes: through
    Checkpointer.restore(shardings=) (demoted specs) and reshard_tree on
    make_elastic_mesh(ranks, prefer_model=2), through elastic_restore;
    this rank's blocks as bits, or 'outside'. make_production_mesh on
    this world: its error."""
    import dataclasses

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.transformer import init_params
    from repro_torch.sharding import (NamedSharding, elastic_restore,
                                      make_elastic_mesh, reshard_tree, rules)
    from repro_torch.sharding.elastic import demoted_spec

    cfg = dataclasses.replace(reduced(get_config("llama3-8b")),
                              **C.ELASTIC_OVER)
    target = init_params(cfg, seed=0, device="cpu")
    specs = rules.param_specs(cfg, target)
    ck = Checkpointer(ckpt_dir, async_save=False)
    for name, ranks in C.ELASTIC_MESHES.items():
        mesh = make_elastic_mesh(ranks, prefer_model=2, device="cpu")
        key = f"elastic/{name}"
        if mesh is None:
            out[f"{key}/outside"] = np.array(1)
            continue
        out[f"{key}/shape"] = np.array(mesh.shape)
        shardings = rules._map2(lambda s, t: NamedSharding(
            mesh, demoted_spec(s, tuple(t.shape), mesh)), specs, target)
        got = ck.restore(C.ELASTIC_STEP, target, shardings=shardings)
        again = reshard_tree(ck.restore(C.ELASTIC_STEP, target), specs,
                             mesh)
        for k, v in C.flatten(got).items():
            out[f"{key}/{k}"] = raw(v)
        for k, v in C.flatten(again).items():
            out[f"{key}/reshard/{k}"] = raw(v)
    for name, ranks in C.ELASTIC_RESTORES.items():
        tree, mesh = elastic_restore(ck, C.ELASTIC_STEP, target, cfg,
                                     ranks=ranks, device="cpu")
        key = f"elastic/{name}"
        if mesh is None:
            assert tree is None
            out[f"{key}/outside"] = np.array(1)
            continue
        out[f"{key}/shape"] = np.array(mesh.shape)
        for k, v in C.flatten(tree).items():
            out[f"{key}/{k}"] = raw(v)
    try:
        make_production_mesh(device="cpu")
        out["production_mesh"] = np.array("no error")
    except ValueError as e:
        out["production_mesh"] = np.array(str(e))


def main():
    rank, store, out_dir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    torch.set_num_threads(1)
    init_world(rank, C.WORLD, store)
    mesh = col.make_mesh((C.WORLD,), ("data",), device="cpu")
    pod_mesh = col.make_mesh((2, 2), ("pod", "data"), device="cpu")
    out = {}
    with col.use_mesh(mesh):
        quant_cases(out, rank, ("data",), "quant/", C.QUANT_CASES)
        dot_cases(out, rank)
        train_cases(out, rank, os.path.join(out_dir, "params.npz"))
    with col.use_mesh(pod_mesh):
        quant_cases(out, rank, ("data", "pod"), "pod/", [C.POD_CASE])
    collective_cases(out, rank, mesh, pod_mesh)
    mesh22 = col.make_mesh((2, 2), ("data", "model"), device="cpu")
    tp_mesh = col.make_mesh((1, C.WORLD), ("data", "model"), device="cpu")
    gemm_cases(out, rank, mesh, mesh22)
    embed_case(out, rank, tp_mesh)
    engine_cases(out, rank, {(1, C.WORLD): tp_mesh, (2, 2): mesh22})
    wire_cases(out, rank, pod_mesh)
    pod_psum_cases(out, rank, pod_mesh)
    elastic_cases(out, rank, os.path.join(out_dir, "ckpt"))
    out["collectives"] = np.array(col.COLLECTIVES["calls"])
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


if __name__ == "__main__":
    main()
