"""The port's elastic re-mesh and mesh factories in one CPU process
(``repro_torch.sharding.elastic``, ``repro_torch.launch.mesh``) against
the JAX reference: ``best_mesh_shape``'s arithmetic, the spec demotion of
``reshard_tree`` on a stand-in rank of a larger mesh, and the meshes a
process without a process group can make. The four-rank worlds
(``Checkpointer.restore(shardings=)`` and ``elastic_restore`` of a
reference checkpoint, every rank's blocks) are
``tests/test_torch_sharded.py``'s.
"""
import pytest
import torch

from repro.sharding.elastic import best_mesh_shape as jbest_mesh_shape
from repro_torch.core.collectives import Mesh
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.sharding import P, best_mesh_shape, reshard_tree
from repro_torch.sharding.elastic import demoted_spec


@pytest.mark.parametrize("prefer_model", (1, 2, 4, 16))
def test_best_mesh_shape_matches_reference(prefer_model):
    """Every healthy rank count from 1 to 64: the reference's grid."""
    for n in range(1, 65):
        assert best_mesh_shape(n, prefer_model) == \
            jbest_mesh_shape(n, prefer_model), n


def stand_in(shape, names, pos):
    """The Mesh of the rank at position ``pos`` of a mesh of ``shape``,
    without a process group (a cut reads only its coordinates)."""
    return Mesh(shape, names, "cpu", pos, {})


def test_demoted_spec():
    """An entry whose axes' product does not divide its dimension is
    replicated; an axis the mesh lacks counts as size 1 and is left
    out, as the reference's ``mesh.shape.get(n, 1)`` reads it."""
    mesh = stand_in((2, 3), ("data", "model"), 0)
    assert demoted_spec(P("model", None), (9, 4), mesh) == P("model", None)
    assert demoted_spec(P("model", None), (8, 4), mesh) == P(None, None)
    assert demoted_spec(P(("data", "model")), (12,), mesh) == \
        P(("data", "model"))
    assert demoted_spec(P(("data", "model")), (9,), mesh) == P(None)
    assert demoted_spec(P("pod", "data"), (3, 4), mesh) == P(None, "data")
    assert demoted_spec(P(("pod", "data")), (4,), mesh) == P(("data",))
    assert demoted_spec(P(), (5, 5), mesh) == P(None, None)


def test_reshard_tree_cuts_and_demotes():
    """reshard_tree on the rank at (1, 2) of a (2, 3) mesh: its block of a
    leaf the axes divide, the whole of one they do not."""
    mesh = stand_in((2, 3), ("data", "model"), 5)
    w = torch.arange(4 * 6, dtype=torch.float32).reshape(4, 6)
    v = torch.arange(7, dtype=torch.float32)
    got = reshard_tree({"w": w, "v": v},
                       {"w": P("data", "model"), "v": P("model")}, mesh)
    assert torch.equal(got["w"], w[2:, 4:])
    assert torch.equal(got["v"], v)


def test_meshes_without_a_process_group():
    """make_local_mesh() is the one-rank mesh of this process;
    make_production_mesh names the 256 and 512 ranks it needs and the
    one this process has."""
    mesh = make_local_mesh(device="cpu")
    assert mesh.axis_sizes == {"data": 1, "model": 1}
    assert mesh.axis_index("model") == 0
    with pytest.raises(ValueError, match="256 ranks.* 1"):
        make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="512 ranks.* 1"):
        make_production_mesh(multi_pod=True, device="cpu")

