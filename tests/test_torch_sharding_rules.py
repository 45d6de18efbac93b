"""The port's sharding rules (``repro_torch.sharding.rules``) against the
reference's (``repro.sharding.rules``), in one process.

Every config's params, optimizer-triple and cache specs at ``reduced``
size, key path by key path (the reference's on ``jax.eval_shape``
shapes); the quantized rules on reduced llama3 and granite trees (sub3,
32 x 32 blocks, so the block grids are several blocks wide and some do
not divide the mesh axis), the port's tree against the reference's rules
fed the same tree in its own classes (``as_reference``), with and
without a mesh; ``mixed_operand_pspec`` of a passthrough
pack; the packed-moment and optimizer-state specs under
``FP8_MOMENTS``; and ``local_shards``, whose pieces reassemble to the
whole lanes bit for bit. A spec is compared as the tuple of its entries.
"""
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import list_archs
from repro.configs import reduced as jreduced
from repro_torch.configs import get_config, reduced
from repro_torch.sharding import rules as R

LANES = ("payload_q", "payload_bf16", "payload_nib", "micro_scales", "tags",
         "scales")
BLOCK = (32, 32)


def flat_specs(tree, prefix=""):
    """{key path: spec as a tuple} of a spec tree of either package:
    dicts, QTensor / PackedMoment specs (their lanes and stats), OptState
    (its fields), None for an empty subtree."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat_specs(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    if hasattr(tree, "_fields") and hasattr(tree, "master"):  # OptState
        out = {}
        for f in tree._fields:
            out.update(flat_specs(getattr(tree, f), f"{prefix}.{f}"))
        return out
    if hasattr(tree, "mo"):
        out = {f"{prefix}.stats": tuple(tree.stats)}
        for lane in LANES:
            out[f"{prefix}.mo.{lane}"] = tuple(getattr(tree.mo, lane))
        return out
    return {prefix: tuple(tree)}


def stand_in_mesh(data=1, model=4, rank=0):
    """What the rules read of a mesh: its axis sizes and this rank's
    coordinate on each (row-major, as ``core.collectives.Mesh``)."""
    sizes = {"data": data, "model": model}
    coords = dict(zip(sizes, np.unravel_index(rank, (data, model))))
    return types.SimpleNamespace(axis_sizes=sizes,
                                 axis_index=lambda a: int(coords[a]))


def jax_mesh(data=1, model=4):
    """The reference reads ``mesh.shape[name]`` alone."""
    return types.SimpleNamespace(shape={"data": data, "model": model})


def port_shapes(tree):
    """Nested dicts of (shape, dtype) leaves -> of shape views."""
    if isinstance(tree, dict):
        return {k: port_shapes(v) for k, v in tree.items()}
    return types.SimpleNamespace(shape=tuple(tree[0]), ndim=len(tree[0]))


@pytest.mark.parametrize("arch", list_archs())
def test_dense_specs_match_reference(arch):
    """param_specs, opt_state_spec_from_param and cache_specs_tree (with
    and without the pod axis) of every config, leaf by leaf."""
    from repro.models import init_cache as j_init_cache
    from repro.models import init_params as j_init_params
    from repro.sharding import rules as J
    from repro_torch.models.transformer import cache_specs, init_params

    jcfg, cfg = jreduced(jget(arch)), reduced(get_config(arch))
    jshape = jax.eval_shape(lambda k: j_init_params(jcfg, k),
                            jax.random.PRNGKey(0))
    params = init_params(cfg, device="cpu")
    want = flat_specs(J.param_specs(jcfg, jshape))
    assert want and flat_specs(R.param_specs(cfg, params)) == want
    assert flat_specs(R.opt_state_spec_from_param(cfg, params)) == \
        flat_specs(J.opt_state_spec_from_param(jcfg, jshape))
    jcache = jax.eval_shape(lambda: j_init_cache(jcfg, 2, 64))
    cache = port_shapes(cache_specs(cfg, 2, 64, False, False))
    for pod in (False, True):
        want = flat_specs(J.cache_specs_tree(jcfg, jcache, multi_pod=pod))
        assert want and flat_specs(
            R.cache_specs_tree(cfg, cache, multi_pod=pod)) == want
    assert tuple(R.batch_spec(True)) == tuple(J.batch_spec(True))


def as_reference(tree):
    """A port tree (dicts of tensors, QTensor, PackedMoment, OptState) as
    the reference's classes over shape stand-ins, lane for lane: what the
    reference's rules read of a tree (shapes, and which lanes are
    compact) is then the port's. The port's quantization and moment
    encoding are held to the reference's elsewhere
    (tests/test_torch_serve.py, tests/test_torch_train_state.py)."""
    from repro.kernels.ref import MixedOperand as JMO
    from repro.optim import OptState as JOptState
    from repro.optim import PackedMoment as JPM
    from repro.serve.quantized import QTensor as JQT
    from repro_torch.optim.adamw import OptState
    from repro_torch.optim.moments import PackedMoment
    from repro_torch.serve.quantized import QTensor

    def shape(t):
        return jax.ShapeDtypeStruct(tuple(t.shape), np.float32)

    def mo(m):
        return JMO(block=m.block, shape=m.shape, has_nvfp4=m.has_nvfp4,
                   **{lane: shape(getattr(m, lane)) for lane in LANES})

    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: as_reference(v) for k, v in tree.items()}
    if isinstance(tree, OptState):
        return JOptState(*[as_reference(getattr(tree, f))
                           for f in tree._fields])
    if isinstance(tree, QTensor):
        return JQT(mo=mo(tree.mo), stats=shape(tree.stats), shape=tree.shape)
    if isinstance(tree, PackedMoment):
        return JPM(mo=mo(tree.mo), stats=shape(tree.stats), shape=tree.shape)
    return shape(tree)


@pytest.fixture(scope="module")
def quantized():
    """{arch: (cfg, reference cfg, port QTensor tree, the reference's
    view of it, port params)}: reduced llama3-8b and
    granite-moe-1b-a400m quantized under sub3 with 32 x 32 blocks."""
    from repro_torch.core.policy import MoRPolicy
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.quantized import quantize_params

    out = {}
    for arch in ("llama3-8b", "granite-moe-1b-a400m"):
        cfg = reduced(get_config(arch))
        tp = init_params(cfg, seed=1, device="cpu")
        tq, _ = quantize_params(tp, MoRPolicy(recipe="sub3",
                                              block_shape=BLOCK),
                                min_size=1024)
        out[arch] = (cfg, jreduced(jget(arch)), tq, as_reference(tq), tp)
    return out


@pytest.mark.parametrize("arch", ["llama3-8b", "granite-moe-1b-a400m"])
@pytest.mark.parametrize("model", [None, 2, 4])
def test_quantized_param_specs_match_reference(quantized, arch, model):
    """quantized_param_specs (every QTensor's lanes and stats, the dense
    leaves) and qtensor_pspec_from_dense of each QTensor under both dense
    rules, without a mesh and on meshes whose model axis divides some
    block grids and not others (demoted to replicated)."""
    from jax.sharding import PartitionSpec as JP
    from repro.sharding import rules as J
    from repro_torch.serve.quantized import QTensor

    cfg, jcfg, tq, jq, _ = quantized[arch]
    mesh = None if model is None else stand_in_mesh(model=model)
    jmesh = None if model is None else jax_mesh(model=model)
    got = flat_specs(R.quantized_param_specs(cfg, tq, mesh))
    want = flat_specs(J.quantized_param_specs(jcfg, jq, jmesh))
    assert got == want
    demoted = [k for k, v in got.items()
               if k.endswith("mo.tags") and "model" not in v]
    n_qt = 0
    for key in ("lm_head", "blocks"):
        for name, qt in _qtensors(tq.get(key, {}), key):
            jqt = _at(jq, name)
            lead = qt.mo.tags.ndim - 2
            for dense in ((None,) * lead + ("model", None),
                          (None,) * lead + (None, "model")):
                g = flat_specs(R.qtensor_pspec_from_dense(
                    qt, R.P(*dense), mesh))
                w = flat_specs(J.qtensor_pspec_from_dense(
                    jqt, JP(*dense), jmesh))
                assert g == w, name
            n_qt += 1
    assert n_qt >= 2 and isinstance(qt, QTensor)
    if model == 4:
        assert demoted  # some grid is not a multiple of 4


def _qtensors(tree, prefix):
    from repro_torch.serve.quantized import QTensor
    if isinstance(tree, QTensor):
        yield prefix, tree
        return
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _qtensors(v, f"{prefix}/{k}")


def _at(tree, name):
    for k in name.split("/"):
        tree = tree[k]
    return tree


def test_mixed_operand_pspec_compact_lanes_replicated():
    """A passthrough pack's compact fp8 and sub-byte lanes replicate; its
    bf16 lane, tags and scales shard, as the reference's."""
    import jax.numpy as jnp
    from repro.kernels.ref import passthrough_mixed as jpass
    from repro.sharding.rules import mixed_operand_pspec as jspec
    from repro_torch.kernels.ref import passthrough_mixed

    a = passthrough_mixed(torch.ones((128, 128), dtype=torch.bfloat16),
                          (64, 64))
    ja = jpass(jnp.ones((128, 128), jnp.bfloat16), (64, 64))
    for rows, cols in (("data", None), (None, "model"), ("data", "model")):
        got = R.mixed_operand_pspec(a, rows=rows, cols=cols)
        assert tuple(map(tuple, got)) == tuple(
            map(tuple, jspec(ja, rows=rows, cols=cols)))
    got = R.mixed_operand_pspec(a, rows="data")
    assert got.payload_q == R.P(None, None) and got.tags == R.P("data", None)
    assert repr(got.tags) == "PartitionSpec('data', None)"


@pytest.mark.parametrize("model", [None, 4])
def test_opt_state_specs_match_reference(quantized, model):
    """opt_state_specs and packed_moment_pspec of an FP8_MOMENTS state of
    reduced llama3 (packed m and v where the moment policy packs, dense
    elsewhere; the master; step), on the data axis with and without a
    mesh (the stand-in's data axis of 4 divides some row grids)."""
    from repro.sharding import rules as J
    from repro_torch.optim import FP8_MOMENTS, init_opt_state

    cfg, jcfg, _, _, tp = quantized["llama3-8b"]
    mesh = None if model is None else stand_in_mesh(data=4, model=1)
    jmesh = None if model is None else types.SimpleNamespace(
        shape={"data": 4, "model": 1})
    state = init_opt_state(tp, moments=FP8_MOMENTS)
    got = flat_specs(R.opt_state_specs(cfg, state, mesh=mesh))
    want = flat_specs(J.opt_state_specs(jcfg, as_reference(state),
                                        mesh=jmesh))
    assert got == want
    assert any(".m/" in k and k.endswith("mo.tags") for k in got)


def test_local_shards_reassemble_whole_lanes(quantized):
    """local_shards of the quantized llama3 tree on each of four ranks of
    a (data 1, model 4) stand-in mesh: every cut lane's pieces,
    concatenated in rank order, are the whole lane bit for bit; a
    replicated leaf or lane is the whole tensor itself; a QTensor's local
    (K, N) is its cut view's; a dense dimension the axis does not divide
    raises a ValueError that names the leaf."""
    from repro_torch.serve.quantized import QTensor

    cfg, _, tq, _, _ = quantized["llama3-8b"]
    mesh = stand_in_mesh(model=4)
    specs = R.quantized_param_specs(cfg, tq, mesh)
    pieces = [R.local_shards(tq, specs, stand_in_mesh(model=4, rank=r))
              for r in range(4)]
    n_cut = 0
    for name, qt in list(_qtensors(tq["blocks"], "blocks")) + [
            ("lm_head", tq["lm_head"])]:
        spec = _at(specs, name).mo
        locs = [_at(p, name) for p in pieces]
        for lane in LANES:
            whole, sp = getattr(qt.mo, lane), getattr(spec, lane)
            parts = [getattr(q.mo, lane) for q in locs]
            cut = [d for d, e in enumerate(sp) if e is not None]
            if not cut:
                assert all(p is whole for p in parts)
                continue
            n_cut += 1
            assert torch.equal(torch.cat(parts, dim=cut[0]), whole), name
        assert isinstance(locs[0], QTensor)
        assert locs[0].shape == (locs[0].mo.shape[1], locs[0].mo.shape[0])
    assert n_cut
    emb = [p["embed"] for p in pieces]
    assert torch.equal(torch.cat(emb), tq["embed"])
    bad = {"x": torch.zeros(6, 4)}
    with pytest.raises(ValueError, match="x: dimension 6"):
        R.local_shards(bad, {"x": R.P("model", None)}, mesh)


def test_sharded_leaves_read_the_bound_mesh(quantized):
    """A rank's serving leaves (``serve.quantized.shard_params`` on rank 1
    of a (data 1, model 2) stand-in mesh: wo's two K blocks of 32 do not
    divide 4) carry no mesh of their own:
    their products run on the mesh ``use_mesh`` binds (the engine binds
    it around every model call), and outside one they raise the
    collectives' ValueError naming the axis."""
    from repro_torch.serve.quantized import (ShardedEmbed, ShardedQTensor,
                                             shard_params)

    cfg, _, tq, _, _ = quantized["llama3-8b"]
    local = shard_params(cfg, tq, stand_in_mesh(model=2, rank=1))
    wo, embed = local["blocks"]["dense"]["wo"], local["embed"]
    assert isinstance(wo, ShardedQTensor) and wo.parallel == "row"
    assert isinstance(embed, ShardedEmbed)
    assert not hasattr(wo, "mesh") and not hasattr(embed, "mesh")
    x = torch.ones((2, cfg.d_model), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="unbound mesh axis name 'model'"):
        wo.layer(0).serve_dot(x, out_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="unbound mesh axis name 'model'"):
        embed.lookup(torch.tensor([[0, 1]]))
