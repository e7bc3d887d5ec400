"""What the harness may load: nothing of JAX or of the JAX package
``repro`` (top-level names compared whole: ``repro_torch`` is the port),
and a reference free of the port."""
from __future__ import annotations

import ast
import sys

import pytest

from conftest import REPO

HARNESS = sorted(p for p in (REPO / "echo_bench").rglob("*.py") if "tests" not in p.parts)
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", HARNESS, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_and_no_jax_package(path):
    assert not set(_imports(path)) & FORBIDDEN
    assert "benchmarks/" not in path.read_text()


@pytest.mark.parametrize("name", ["reference.py", "roofline.py", "stats.py"])
def test_the_yardstick_imports_nothing_of_the_port(name):
    assert set(_imports(REPO / "echo_bench" / name)) <= {"__future__", "math", "typing",
                                                         "torch"}


def test_loaded_modules_compared_by_whole_top_level_name(monkeypatch):
    from echo_bench.run import forbidden_modules
    for name in ("repro_torch", "repro_torch.core", "jax_free", "reproduce"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert forbidden_modules() == [] or set(forbidden_modules()) <= FORBIDDEN
    before = set(forbidden_modules())
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert set(forbidden_modules()) - before == {"repro", "jaxlib"} - before
