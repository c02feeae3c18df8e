"""The benchmark measures the port alone: no module of ``bench/`` imports
jax, jaxlib, flax or the JAX package ``repro`` (top-level names compared
whole: ``repro_torch`` is not ``repro``), the reference imports nothing
of the port, nothing reads the JAX package's benchmark files, and a run
refuses to print a result if any of those got loaded."""
import ast

import pytest

from harness import manifest

FILES = sorted(manifest.BENCH.rglob("*.py"))
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _top(name):
    return name.split(".")[0]


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(manifest.BENCH)))
def test_no_jax_or_jax_package(path):
    bad = [n for n in _imports(path) if _top(n) in FORBIDDEN]
    assert not bad
    text = path.read_text()
    for mark in ("benchmarks/", "BENCH_", "scripts/"):
        assert mark not in text or path.name.startswith("test_bench_iso")


@pytest.mark.parametrize("path", sorted(
    (manifest.BENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_port(path):
    assert not [n for n in _imports(path)
                if _top(n) in ("repro_torch", "harness")]


def test_names_are_compared_whole(monkeypatch):
    import sys
    import run
    monkeypatch.setitem(sys.modules, "repro_torchlike", sys)
    assert "repro_torch" not in run.FORBIDDEN
    before = run.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "repro.kernels", sys)
    assert run.loaded_forbidden() == sorted(set(before) | {"repro.kernels"})
