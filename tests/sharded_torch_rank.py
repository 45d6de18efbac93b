"""One rank of the port's four-rank CPU world for
``tests/test_torch_sharded.py``:

    python tests/sharded_torch_rank.py RANK STORE_FILE OUT_DIR

Joins a gloo world through the ``file://`` store, runs every case of
``sharded_cases`` on its shard under ``core.collectives.use_mesh`` and
writes ``OUT_DIR/rank{RANK}.npz``. Imports torch and the port only; the
train-step parameters come from ``OUT_DIR/params.npz``.
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
    out["collectives"] = np.array(col.COLLECTIVES["calls"])
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


if __name__ == "__main__":
    main()
