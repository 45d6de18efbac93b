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
# make_pod_compressed_psum on the (pod 2, data 2) mesh, inner_axes
# ('data',): name -> (recipe, whether 'data' splits the leaf's rows; a
# leaf it does not split is replicated within the pod). The pods' partial
# gradients come from pod_grads; the flat path's case is "flat".
POD_PSUM_CASES = {"sub3": ("sub3", True), "sub4": ("sub4", True),
                  "sub4_nvfp4_pod0": ("sub4", True),
                  "norm_replicated": ("sub3", False)}
# The lanes a pack ships, in make_pod_compressed_psum's gather order.
POD_LANES = ("payload_q", "payload_bf16", "payload_nib", "micro_scales",
             "tags", "scales")
# Elastic re-mesh of a reduced llama3-8b checkpoint written by the
# reference at step ELASTIC_STEP: d_ff 99, so mlp/wo's 99 rows demote to
# replicated on a 'model' axis of 2 and wi's 198 columns on one of 4.
ELASTIC_OVER = {"d_ff": 99}
ELASTIC_STEP = 3
# Checkpointer.restore(shardings=) / reshard_tree on make_elastic_mesh(
# ranks, prefer_model=2): 2 x 2 over four ranks, 1 x 2 over three (ranks
# 2 and 3 outside it).
ELASTIC_MESHES = {"2x2": (0, 1, 2, 3), "1x2": (0, 1, 2)}
# elastic_restore (prefer_model 16): 1 x 4, and 1 x 3 with rank 3 lost.
ELASTIC_RESTORES = {"1x4": (0, 1, 2, 3), "1x3": (0, 1, 2)}
# A leaf each mesh demotes to replicated: (leaf, its 'model' dimension,
# that dimension's whole extent).
ELASTIC_DEMOTED = {"2x2": ("blocks/dense/mlp/wo", 1, 99),
                   "1x2": ("blocks/dense/mlp/wo", 1, 99),
                   "1x4": ("blocks/dense/mlp/wi", 2, 198),
                   "1x3": ("embed", 0, 512)}


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


def pod_grads(name):
    """(2, R, C) f32: each pod's partial gradient of case ``name``."""
    if name == "flat":  # tests/test_distributed.py's pod psum input
        return np.random.RandomState(0).randn(2, 64, 64).astype(np.float32)
    if name == "norm_replicated":  # a (1, 2048) norm scale's gradient
        r = np.random.default_rng(1)
        g = r.standard_normal((2, 1, 2048)) * np.exp2(
            r.integers(-6, 6, (2, 1, 2048)))
        return g.astype(np.float32)
    if name == "sub4_nvfp4_pod0":
        # Pod 0's first 128 rows on the E2M1 grid under per-16 scales
        # (NVFP4 blocks), the rest normal; pod 1 of a range no NVFP4
        # block keeps (all BF16).
        r = np.random.default_rng(5)
        grid = np.array([0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0])
        g0 = r.standard_normal((256, 128))
        g0[:128] = grid[r.integers(0, 7, (128, 128))] * np.exp2(
            r.integers(-9, 9, (128, 8))).repeat(16, axis=1) * np.where(
            r.standard_normal((128, 128)) > 0, 1, -1)
        g1 = r.standard_normal((256, 128)) * np.exp2(
            r.integers(-12, 12, (256, 128)))
        return np.stack([g0, g1]).astype(np.float32)
    # tests/test_compress_psum.py's pod partial sums
    r = np.random.default_rng(0)
    g = r.standard_normal((2, 256, 128)) * np.exp2(
        r.integers(-12, 12, (2, 256, 128)))
    return g.astype(np.float32)


def pod_local(name, rank: int):
    """Rank ``rank``'s leaf of case ``name`` on the (pod 2, data 2) mesh:
    its pod's gradient, its half of the rows where 'data' splits them."""
    g = pod_grads(name)[rank // 2]
    if name in POD_PSUM_CASES and POD_PSUM_CASES[name][1]:
        g = np.split(g, 2)[rank % 2]
    return g


def wire_bits(rank: int):
    """{dtype name: the integer bits rank ``rank`` gathers}: NaNs with
    payloads, +-0, subnormals and every fp8 byte, per rank."""
    b8 = (np.arange(256, dtype=np.int64) * 7 + rank * 31) % 256
    b16 = np.array([0x7FC1, 0xFFC0, 0x8000, 0x0000, 0x0001, 0x7F80,
                    0x3F80 + rank], np.int64)
    b32 = np.array([0x7FA00001, 0xFFC00000, 0x80000000, 0x00000000,
                    0x00000001, 0x7F800000, 0x3F800000 + rank], np.int64)
    return {"float8_e4m3fn": b8.astype(np.uint8),
            "float8_e5m2": b8[::-1].astype(np.uint8),
            "uint8": b8.astype(np.uint8),
            "bfloat16": b16.astype(np.uint16),
            "float32": b32.astype(np.uint32),
            "scalar": b32[:1].reshape(()).astype(np.uint32)}


def bits(a):
    """An unsigned-integer view of ``a`` of its width (bit-for-bit
    comparison, NaN payloads included)."""
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32,
                   8: np.uint64}[a.dtype.itemsize])


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
