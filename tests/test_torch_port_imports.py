"""PyTorch port, package boundary: the port and its chip scripts import neither JAX nor the
JAX package, and the port's top level stays a namespace package.

The top level has no ``__init__.py`` because the repository's linter (``tools/graftlint``)
expects exactly one top-level package directory with one — the JAX package.
"""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "csed_514_project_distributed_training_using_pytorch_tpu_torch"
JAX_PACKAGE = "csed_514_project_distributed_training_using_pytorch_tpu"
FORBIDDEN = ("jax", "jaxlib", "flax", JAX_PACKAGE)

SCRIPTS = [ROOT / "chip_smoke.py", ROOT / "flash_probe.py"]
SOURCES = sorted(PORT.rglob("*.py")) + SCRIPTS


def _imported_modules(path: pathlib.Path) -> list[str]:
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
    return names


def test_sources_found():
    assert len(SOURCES) >= 28
    for kernel_source in ("fused_kernels.cu", "flash_attention.cu", "paged_attention.cu"):
        assert (PORT / "csrc" / kernel_source).is_file()
    for module in ("ops/attention.py", "ops/rotary.py", "ops/flash_attention.py",
                   "models/transformer.py", "parallel/mesh.py", "train/composed.py",
                   "ops/paged_attention.py", "models/lm.py", "serving/__init__.py",
                   "serving/engine.py", "serving/pagepool.py", "serving/scheduler.py",
                   "parallel/collectives.py", "parallel/data_parallel.py",
                   "train/distributed.py", "train/launch.py", "train/smoke.py",
                   "utils/benchmarks.py", "utils/determinism.py", "bench.py",
                   "parallel/ring_attention.py"):
        assert PORT / module in SOURCES, module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    for name in _imported_modules(path):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, f"{path.relative_to(ROOT)} imports {name}"


def test_top_level_is_a_namespace_package():
    assert not (PORT / "__init__.py").exists()
    for sub in ("data", "ops", "models", "parallel", "serving", "train", "utils"):
        assert (PORT / sub / "__init__.py").is_file(), sub


@pytest.mark.parametrize("path", SCRIPTS, ids=lambda p: p.name)
def test_chip_scripts_print_no_telemetry_events(path):
    """The linter checks every dict literal with an "event" key against the JAX package's
    registry; the chip scripts have none."""
    tree = ast.parse(path.read_text(encoding="utf-8"))
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            keys = [k.value for k in node.keys if isinstance(k, ast.Constant)]
            assert "event" not in keys
