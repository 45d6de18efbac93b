"""The port's cross-pod compressed gradient sum
(``repro_torch.optim.compress.make_pod_compressed_psum``) against the
JAX reference in one CPU process: the single-pod round trip
(``axis_name=None``, a pack and its decode with no collective) for every
recipe and the flat path, on aligned and uneven leaves, the outlier
witness of ``tests/test_compress_psum.py`` and the argument checks. The
four-rank (pod, data) mesh is ``tests/test_torch_sharded.py``'s.

The reference runs ``backend='xla'``, compiled with XLA's excess
precision off. Every output is held bit for bit: the pack's lanes are
the same IEEE operations, the decode is exact, and a one-pod sum is the
value itself (XLA drops a reduction over one entry, so -0.0 stays).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.policy import MoRPolicy as JPolicy
from repro.optim import compress as jcompress
from repro_torch.core.policy import MoRPolicy
from repro_torch.optim import compress as tcompress

NOEX = {"xla_allow_excess_precision": False}
RECIPES = ("sub2", "sub3", "sub4", None)  # None: the flat path
SHAPES = [(256, 128), (100, 70), (1, 300), (37,), ()]


def bits(a):
    a = np.asarray(a)
    return a.view({2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def both(recipe, g):
    """(reference, port) outputs of the single-pod sum of the f32 leaf
    ``g``, as numpy."""
    jpol = None if recipe is None else JPolicy(recipe=recipe, backend="xla")
    pol = None if recipe is None else MoRPolicy(recipe=recipe)
    want = jax.jit(jcompress.make_pod_compressed_psum(None, jpol),
                   compiler_options=NOEX)(jnp.asarray(g))
    got = tcompress.make_pod_compressed_psum(None, pol)(
        torch.from_numpy(np.array(g)))
    return np.asarray(want), got.numpy()


def leaf(shape, seed):
    r = np.random.default_rng(seed)
    return (r.standard_normal(shape) * np.exp2(
        r.integers(-10, 10, shape))).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("recipe", RECIPES, ids=str)
def test_single_pod_round_trip_matches_reference(recipe, shape):
    """axis_name=None: the port's pack and decode (or the flat per-tensor
    E4M3 round trip) bit for bit the reference's, at the leaf's shape
    and dtype, on leaves that do and do not divide the block grid."""
    g = leaf(shape, 2)
    want, got = both(recipe, g)
    assert got.shape == shape and want.dtype == np.float32
    np.testing.assert_array_equal(bits(got), bits(want))


@pytest.mark.parametrize("recipe", RECIPES, ids=str)
def test_single_pod_bf16_leaf(recipe):
    """A bf16 leaf comes back bf16, bit for bit the reference's."""
    g = jnp.asarray(leaf((256, 128), 4), jnp.bfloat16)
    jpol = None if recipe is None else JPolicy(recipe=recipe, backend="xla")
    pol = None if recipe is None else MoRPolicy(recipe=recipe)
    want = jax.jit(jcompress.make_pod_compressed_psum(None, jpol),
                   compiler_options=NOEX)(g)
    got = tcompress.make_pod_compressed_psum(None, pol)(
        torch.from_numpy(np.asarray(g, np.float32)).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  bits(want).view(np.int16))


def test_outlier_witness_flat_vs_mor():
    """tests/test_compress_psum.py's witness: one 1e4 outlier in a ~1e-2
    gradient flattens every other element of the flat E4M3 path (rel err
    > 0.5 outside the outlier's block), while the per-block sub3 path
    keeps them (< 0.05); both outputs bit for bit the reference's."""
    r = np.random.default_rng(3)
    g = (r.standard_normal((256, 128)) * 1e-2).astype(np.float32)
    g[17, 5] = 1e4
    mask = np.ones_like(g, bool)
    mask[:128, :128] = False
    rel = {}
    for recipe in (None, "sub3"):
        want, got = both(recipe, g)
        np.testing.assert_array_equal(bits(got), bits(want))
        rel[recipe] = float(np.linalg.norm(got[mask] - g[mask])
                            / np.linalg.norm(g[mask]))
    assert rel[None] > 0.5, rel
    assert rel["sub3"] < 0.05, rel
    assert rel["sub3"] < rel[None] / 10


def test_pod_axis_must_not_be_inner():
    """The pod axis in ``inner_axes`` or in ``policy.mesh_axes`` raises a
    ValueError, as the reference's does."""
    for mk, pol in ((tcompress.make_pod_compressed_psum, MoRPolicy),
                    (jcompress.make_pod_compressed_psum, JPolicy)):
        with pytest.raises(ValueError, match="inner_axes"):
            mk("pod", policy=pol(recipe="sub3"), inner_axes=("pod",))
        with pytest.raises(ValueError, match="mesh_axes"):
            mk("pod", policy=pol(recipe="sub3", mesh_axes=("pod",)))
