"""The PyTorch port stands alone: no module of ``src/repro_torch``, not
``chip_smoke.py`` and no ``examples/*_torch.py`` imports jax or
anything of the JAX package ``repro``,
and no kernel wrapper catches an exception around a build or a launch
(a failing kernel raises; nothing falls back to the plain version)."""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + [
    ROOT / "examples" / f"{name}_torch.py"
    for name in ("train_moe", "quickstart", "serve_decode",
                 "expert_parallel_demo")]
KERNEL_FILES = sorted((PORT / "kernels").glob("*.py"))


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) \
                == "__import__" and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_the_port_has_files():
    assert len(FILES) > 20
    assert (PORT / "kernels" / "csrc").is_dir()


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [n for n in _imports(tree) if _forbidden(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
    for node in ast.walk(tree):
        # no importlib.import_module("repro....") / ("jax...") either
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and node.value.startswith(("repro.", "jax.")):
            pytest.fail(f"{path.relative_to(ROOT)} names module {node.value!r}")


def test_forbidden_names_are_detected():
    tree = ast.parse("import jax\nfrom repro.kernels import plan\n"
                     "import repro_torch.kernels\n")
    assert [n for n in _imports(tree) if _forbidden(n)] == \
        ["jax", "repro.kernels"]


@pytest.mark.parametrize("path", KERNEL_FILES, ids=lambda p: p.name)
def test_kernel_wrappers_do_not_catch(path):
    """No ``try`` in a kernel module may wrap a build (``build.load``,
    ``build.function``, ``build_all``) or a launch (a ``*_cuda`` wrapper or a library call)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if not isinstance(node, ast.Try) or path.name == "build.py" and \
                _only_catches_rename(node):
            continue
        names = {getattr(n, "attr", getattr(n, "id", "")) for b in node.body
                 for n in ast.walk(b)}
        hit = {n for n in names if n in ("load", "function", "build_all", "check")
               or n.endswith("_cuda") or n.startswith(("gmm", "quantize",
                                                       "act_quantize"))}
        assert not hit, f"{path.name}:{node.lineno} wraps {sorted(hit)} in try"


def _only_catches_rename(node):
    """build.py's one ``try`` guards the rename of a finished build
    directory against a concurrent identical build, nothing else."""
    calls = [n.func.attr for b in node.body for n in ast.walk(b)
             if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)]
    return calls == ["rename"]
