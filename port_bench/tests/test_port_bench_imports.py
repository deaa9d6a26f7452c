"""Nothing under port_bench imports JAX or the JAX package (top-level names
compared whole, so ``rtvc_tpu_torch`` passes), and the reference imports
nothing of the port."""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "rtvc_tpu"}


def imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


FILES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", FILES, ids=[str(p.relative_to(BENCH)) for p in FILES])
def test_no_jax(path):
    assert not set(imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_plain(path):
    names = set(imports(path))
    assert "rtvc_tpu_torch" not in names
    assert names <= {"__future__", "functools", "math", "re", "typing", "numpy", "scipy",
                     "torch", "port_bench"}, names
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module and node.module.startswith(
                "port_bench"):
            assert node.module.startswith("port_bench.reference"), node.module


def test_name_compare_is_whole():
    assert "rtvc_tpu_torch".split(".")[0] not in FORBIDDEN
