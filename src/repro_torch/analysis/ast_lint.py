"""Layer 3: AST lint over ``src/repro_torch/``, repo-specific structural
rules.

Three rules (see ``findings.RULES`` for rationale):

* **REPRO-A01**: no direct calls to kernel-internal entry points (the
  ``*_cuda`` launch wrappers and their ``*_plain`` twins) outside
  ``kernels/``: everything else calls the public functions, which pick
  by the tensor's device as ``kernels.dispatch.resolve`` does.
* **REPRO-A02**: no bare ``assert`` in kernel files (any file under a
  ``kernels`` directory): ``python -O`` strips them.
* **REPRO-A03**: no hardcoded ``block_m=``/``block_n=``/``block_k=``
  integer literals outside ``kernels/``: tile geometry lives in
  ``kernels/plan.py`` (pool, ``KernelConfig``) and kernel signatures.

Stdlib-only (``ast``), so the linter runs before torch imports.
"""
from __future__ import annotations

import ast
import os
from typing import Iterable, List, Optional

from repro_torch.analysis.findings import Finding, relpath

_KERNEL_ENTRIES = ("gmm", "gmm_quant", "gmm_bf16", "gmm_wgrad",
                   "gmm_wgrad_fp8", "act_quantize", "quantize_tilewise",
                   "flash_attention")
# kernel-internal callables: the launch wrappers, their plain twins and
# their shape-only versions.
# The public functions (gmm, act_quantize, ...) stay allowed everywhere;
# only kernels/ itself (and tests, not in the default scan scope) may
# call these.
KERNEL_INTERNAL_CALLS = frozenset(
    f"{name}_{route}" for name in _KERNEL_ENTRIES
    for route in ("cuda", "plain", "abstract"))

BLOCK_KWARGS = ("block_m", "block_n", "block_k")
_BLOCK_ALIGN = {"block_m": 8, "block_n": 128, "block_k": 128}


def is_kernel_file(path: str) -> bool:
    parts = os.path.normpath(path).split(os.sep)
    return "kernels" in parts


def _call_name(node: ast.Call) -> Optional[str]:
    fn = node.func
    if isinstance(fn, ast.Name):
        return fn.id
    if isinstance(fn, ast.Attribute):
        return fn.attr
    return None


def scan_source(source: str, path: str) -> "List[Finding]":
    """Lint one module's source text (``path`` is only used for reporting
    and for the kernel-file predicate, handy for fixture tests)."""
    rel = relpath(path)
    kernel = is_kernel_file(rel)
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding("REPRO-A00", rel, e.lineno or 1,
                        f"unparseable module: {e.msg}",
                        "fix the syntax error so the linter can run")]
    findings: "List[Finding]" = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            name = _call_name(node)
            if name in KERNEL_INTERNAL_CALLS and not kernel:
                findings.append(Finding(
                    "REPRO-A01", rel, node.lineno,
                    f"direct call to kernel-internal {name}() outside "
                    f"kernels/",
                    "call the public function of the kernel module "
                    "(gmm / gmm_quant / act_quantize / quantize_tilewise "
                    "/ ...), which picks the route by the tensor's "
                    "device as kernels.dispatch.resolve does"))
            if not kernel:
                for kw in node.keywords:
                    if (kw.arg in BLOCK_KWARGS
                            and isinstance(kw.value, ast.Constant)
                            and isinstance(kw.value.value, int)
                            and not isinstance(kw.value.value, bool)):
                        val = kw.value.value
                        align = _BLOCK_ALIGN[kw.arg]
                        mis = ("" if val % align == 0 else
                               f" (and {val} is not a multiple of "
                               f"{align})")
                        findings.append(Finding(
                            "REPRO-A03", rel, kw.value.lineno,
                            f"hardcoded {kw.arg}={val} outside "
                            f"kernels/{mis}",
                            "take the tile shape from a KernelConfig / "
                            "the plan.py pool (autotune or "
                            "KernelConfig.default()) instead of a "
                            "literal"))
        elif isinstance(node, ast.Assert) and kernel:
            findings.append(Finding(
                "REPRO-A02", rel, node.lineno,
                "bare assert in a kernel file (stripped under python -O)",
                "raise ValueError with a shape message instead"))
    return findings


def scan_file(path: str) -> "List[Finding]":
    with open(path, encoding="utf-8") as f:
        return scan_source(f.read(), path)


def iter_py_files(paths: Iterable[str]):
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                yield p
        else:
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = sorted(d for d in dirnames
                                     if d != "__pycache__")
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        yield os.path.join(dirpath, fn)


def default_scan_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def scan_paths(paths: "Optional[Iterable[str]]" = None) -> "List[Finding]":
    """Lint every ``.py`` under ``paths`` (default: ``src/repro_torch/``)."""
    if paths is None:
        paths = [default_scan_root()]
    findings: "List[Finding]" = []
    for f in iter_py_files(paths):
        findings.extend(scan_file(f))
    return findings
