"""Inputs and cases shared by ``tests/test_torch_sharded.py`` and the two
worlds it starts: ``tests/sharded_torch_rank.py`` (the port, one process
a rank) and ``tests/sharded_jax_ref.py`` (the reference, one process
with 4 host devices). numpy only: every process makes the same inputs
from the same seeds, and trees travel as npz files.
"""
import numpy as np

WORLD = 4
BLOCK = (64, 64)
# test_sharded_mor.py's cases: every recipe under GAM, the ablation
# algos, the forced reject branch and the passthrough.
QUANT_CASES = [(rec, "gam", 0.045)
               for rec in ("tensor", "sub2", "sub3", "sub4", "e4m3")]
QUANT_CASES += [("sub3", "e8m0", 0.045), ("sub3", "fp32_amax", 0.045),
                ("sub4", "e8m0", 0.045), ("tensor", "gam", 0.0),
                ("off", "gam", 0.045)]
# The 2 x 2 ('pod', 'data') mesh, reduced over both axes (named in the
# other order: one product group either way).
POD_CASE = ("sub3", "gam", 0.045)
DOT_CASES = [(rec, fuse) for rec in ("tensor", "sub3")
             for fuse in (False, True)]
EXPERT_CASES = [("sub3", False), ("sub3", True)]
TRAIN_POLICIES = ("tensor", "sub3")
# The policy whose step also runs on one device, shard by shard.
SINGLE_POLICY = "sub3"
# Reduced llama3-8b at d 128 and one layer; each rank 1 x 128 tokens, so
# a rank's rows are whole 128 x 128 blocks.
TRAIN_OVER = {"d_model": 128, "n_layers": 1}
TRAIN_SEQ = 128
# sharded_mixed_gemm (tests/test_sharded_mor.py's 256 x 256 case, 64 x 64
# blocks: a 4 x 4 grid): each lane on the 4-rank 'data' mesh, and rows
# over 'data' with columns over 'model' on the 2 x 2 ('data', 'model')
# mesh.
GEMM_CASES = [("row", {"row_axis": "data"}), ("col", {"col_axis": "data"}),
              ("contract", {"contract_axis": "data"})]
GEMM_2X2 = {"row_axis": "data", "col_axis": "model"}
# Tensor-parallel Engine(mesh=): reduced llama3-8b at the widths where
# every block grid divides 4 (sub3, quantize_min_size 4096).
ENGINE_OVER = {"d_model": 512, "n_heads": 8, "n_kv": 4, "head_dim": 64,
               "d_ff": 1024, "vocab": 512, "n_layers": 2}
# variant -> (data, model) mesh: the tied variant ties the embedding; on
# the 2 x 2 mesh the two data replicas hold the same blocks.
ENGINE_VARIANTS = {"untied": (1, 4), "tied": (1, 4), "untied_data2": (2, 2)}
ENGINE_MIN_SIZE = 4096
ENGINE_SLOTS = 2
ENGINE_PROMPTS = (5, 40, 17)
ENGINE_NEW = 4
# Stats lanes bit for bit under sharding: all but 1 (rel_err, an f32 sum
# in another association).
EXACT_LANES = [0] + list(range(2, 14))


def quant_input():
    """256 x 128 of high dynamic range (every sub3 tag), as f32 holding
    bf16 values."""
    r = np.random.RandomState(0)
    return bf16_round(r.randn(256, 128) * np.exp(r.randn(256, 128)))


def dot_inputs():
    r = np.random.RandomState(1)
    return (bf16_round(r.randn(256, 128)), bf16_round(r.randn(128, 64)),
            bf16_round(r.randn(256, 64)))


def expert_inputs():
    r = np.random.RandomState(2)
    return (bf16_round(r.randn(2, 256, 128)),
            bf16_round(r.randn(2, 128, 64)),
            bf16_round(r.randn(2, 256, 64)))


def gemm_inputs():
    """(w, x): the (N, K) weight view, of high dynamic range, and the
    activation, both 256 x 256 bf16 values."""
    r = np.random.RandomState(2)
    w = bf16_round(r.randn(256, 256) * np.exp(r.randn(256, 256)))
    return w, bf16_round(r.randn(256, 256))


def embed_table():
    """(64, 8) bf16 values with a -0.0 in every row."""
    t = bf16_round(np.random.RandomState(4).randn(64, 8))
    t[:, 3] = -0.0
    return t


def embed_ids():
    return np.random.RandomState(5).randint(0, 64, (2, 9))


def engine_prompts(vocab: int):
    rng = np.random.default_rng(11)
    return [rng.integers(0, vocab, n) for n in ENGINE_PROMPTS]


def nan_input(at: int):
    """quant_input with one NaN in the rows of rank ``at``."""
    x = quant_input().copy()
    x[at * 64 + 5, 17] = np.nan
    return x


def train_batch(vocab: int):
    rng = np.random.default_rng(5)
    return {k: rng.integers(0, vocab, (WORLD, TRAIN_SEQ))
            for k in ("tokens", "labels")}


def rows(a, rank: int, axis: int = 0):
    """Rank ``rank``'s shard of ``a`` along ``axis`` (WORLD equal parts)."""
    return np.split(a, WORLD, axis=axis)[rank]


def bf16_round(a):
    """f32 values rounded to bf16 (round to nearest even)."""
    b = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) >> 16 << 16
    return b.astype(np.uint32).view(np.float32)


def flatten(tree, prefix=""):
    """{'a/b': leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else str(k)
        out.update(flatten(v, name) if isinstance(v, dict) else {name: v})
    return out


def unflatten(flat):
    tree = {}
    for name, v in flat.items():
        *path, leaf = name.split("/")
        t = tree
        for k in path:
            t = t.setdefault(k, {})
        t[leaf] = v
    return tree
