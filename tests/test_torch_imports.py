"""The PyTorch port stands alone: no module of ``src/repro_torch`` and
not ``chip_smoke.py`` imports JAX or the JAX package (the machine with
the card has no JAX), and importing the port leaves ``jax`` unloaded."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno


def test_port_tree_is_present():
    names = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    for must in ("src/repro_torch/kernels/ops.py",
                 "src/repro_torch/serve/engine.py",
                 "src/repro_torch/sharding/rules.py",
                 "src/repro_torch/train/train_step.py",
                 "src/repro_torch/kernels/gam_quant.py",
                 "src/repro_torch/checkpoint/ckpt.py",
                 "src/repro_torch/robust/faults.py",
                 "src/repro_torch/models/blocks.py",
                 "src/repro_torch/configs/gemma_2b.py",
                 "src/repro_torch/configs/granite_moe_1b_a400m.py",
                 "src/repro_torch/configs/moonshot_v1_16b_a3b.py",
                 "src/repro_torch/configs/paligemma_3b.py",
                 "src/repro_torch/configs/whisper_tiny.py",
                 "src/repro_torch/configs/hymba_1_5b.py",
                 "src/repro_torch/configs/xlstm_350m.py",
                 "src/repro_torch/models/recurrent.py",
                 "src/repro_torch/core/collectives.py",
                 "src/repro_torch/launch/ranks.py",
                 "src/repro_torch/launch/mesh.py",
                 "src/repro_torch/sharding/elastic.py",
                 "chip_smoke.py"):
        assert must in names


@pytest.mark.parametrize(
    "path", _port_files(), ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_reference_import(path):
    bad = [(mod, line) for mod, line in _imported_roots(path)
           if mod in FORBIDDEN]
    assert not bad, f"{path}: imports {bad}"


def test_import_leaves_jax_unloaded():
    code = (
        "import sys\n"
        "import repro_torch.serve, repro_torch.models, repro_torch.convert\n"
        "import repro_torch.kernels.ops, repro_torch.train, repro_torch.data\n"
        "import repro_torch.optim, repro_torch.core.stats\n"
        "import repro_torch.checkpoint, repro_torch.robust.faults\n"
        "import repro_torch.models.blocks, repro_torch.configs\n"
        "import repro_torch.launch.mesh, repro_torch.sharding.elastic\n"
        "repro_torch.configs.list_archs()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_every_module_imports_first():
    """Any module of the port can be the first one a program imports
    (the core and kernels packages import each other's modules)."""
    mods = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        .removesuffix(".__init__")
        for p in (ROOT / "src" / "repro_torch").rglob("*.py"))
    code = (
        "import importlib, sys\n"
        f"mods = {mods!r}\n"
        "bad = []\n"
        "for m in mods:\n"
        "    for k in [k for k in sys.modules if k.startswith('repro_torch')]:\n"
        "        del sys.modules[k]\n"
        "    try:\n"
        "        importlib.import_module(m)\n"
        "    except Exception as e:\n"
        "        bad.append((m, repr(e)))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr

