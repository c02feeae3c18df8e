"""Layer 5: prepare-once contracts (REPRO-T01..T03).

The JAX package's layer 5 counts jit traces: a shape-stable repeat call
must hit the jit cache.  The port runs eagerly and calls no
``torch.compile``, so nothing is traced; what it does prepare once, and
what must not recur on a shape-stable repeat call, is:

* ``kernel_build``: a build of the CUDA kernel libraries
  (``kernels/build.py``'s ``build_all``, on a miss only);
* ``kernel_load``: a library loaded into the process (``build.load``, on
  a miss only);
* ``plan_cache_build``: a static plan shape built by ``PLAN_CACHE``
  (``shared_plan``; a replay builds none);
* ``autotune_measure``: an autotune that measures candidates on the card;
* ``decode_select``: an Engine's decode-tile selection.

Each is an event on the :mod:`repro_torch.analysis.events` bus.  A
:class:`CompileContract` declares, for one call sequence, how many of
each may occur after its first ``warmup`` calls:

* **REPRO-T01**: ``grouped_linear`` / ``grouped_linear_ffn`` fwd+bwd
  prepare nothing after the first call across routing changes of one
  shape;
* **REPRO-T02**: a second same-shape ``Engine.generate`` prepares
  nothing;
* **REPRO-T03**: the padded baseline builds one plan-cache shape per
  ``padded_m`` bucket.

Product modules register their compile contracts at import time next to
their layer-1 ``Contract``s (``core/grouped_gemm.py``,
``serve/engine.py``, ``core/padding_baseline.py``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import sys
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis import events as ev
from repro_torch.analysis.findings import Finding, relpath

#: modules whose import registers compile contracts (superset of the
#: layer-1 list: the padded baseline carries only a compile contract)
COMPILE_CONTRACT_MODULES = ("repro_torch.core.grouped_gemm",
                            "repro_torch.core.moe",
                            "repro_torch.serve.engine",
                            "repro_torch.core.padding_baseline")

#: what the port prepares once, by tally name
PREPARES = ("kernel_build", "kernel_load", "plan_cache_build",
            "autotune_measure", "decode_select")


def prepare_name(e: "ev.Event") -> Optional[str]:
    """The tally name of a prepare-once event, None for any other event
    (a per-call ``plan_build`` of ``make_tile_plan`` is no preparation)."""
    if e.kind == "plan_build":
        return "plan_cache_build" if e.data.get("shared") else None
    return e.kind if e.kind in PREPARES else None


def tally(events: "List[ev.Event]") -> "Counter":
    """Prepare-once events by tally name."""
    return Counter(n for n in map(prepare_name, events) if n is not None)


@contextlib.contextmanager
def trace_compiles():
    """A capture window yielding the live list of the prepare-once events
    emitted while it is open (:func:`tally` counts them)."""
    with ev.capture() as captured:
        prepares: "List[ev.Event]" = []
        yield prepares
        prepares.extend(e for e in captured if prepare_name(e))


@dataclasses.dataclass(frozen=True)
class CompileContract:
    """Exact prepare counts for one call sequence.

    ``build(device)`` returns ``(fn, calls)`` where ``calls`` is a sequence
    of argument tuples; the checker runs ``fn(*args)`` for each and
    compares the tally of the calls after the first ``warmup`` against
    ``expected``.  Prepare kinds not named in ``expected`` are
    unconstrained."""
    name: str
    description: str = ""
    build: "Optional[Callable[[Any], Tuple[Callable, Sequence[tuple]]]]" = None
    expected: "Dict[str, int]" = dataclasses.field(default_factory=dict)
    warmup: int = 0
    rule: str = "REPRO-T01"
    path: str = ""
    line: int = 1


COMPILE_CONTRACTS: "dict[str, CompileContract]" = {}
_loaded = False


def register_compile_contract(name: str, **kw) -> CompileContract:
    """Register a compile contract (product modules call this at import).
    The registration site becomes the finding location."""
    frame = sys._getframe(1)
    kw.setdefault("path", relpath(frame.f_code.co_filename))
    kw.setdefault("line", frame.f_lineno)
    c = CompileContract(name=name, **kw)
    COMPILE_CONTRACTS[name] = c
    return c


def load_registered() -> "dict[str, CompileContract]":
    global _loaded
    if not _loaded:
        for mod in COMPILE_CONTRACT_MODULES:
            importlib.import_module(mod)
        _loaded = True
    return COMPILE_CONTRACTS


def _tally_findings(counts: "Counter", expected: "Dict[str, int]",
                    c_name: str, rule: str, path: str,
                    line: int) -> "List[Finding]":
    findings = []
    for name, want in sorted(expected.items()):
        got = counts.get(name, 0)
        if got != want:
            findings.append(Finding(
                rule, path, line,
                f"[{c_name}] {name!r} occurred {got} time(s) over the "
                f"counted calls; prepare-once bounds it to {want}",
                "a shape-stable repeat call must reuse what the first "
                "call prepared: check for a cache key that varies per "
                "call (a shape, dtype or device drift) or a cache that "
                "is cleared or bypassed"))
    return findings


def check_compile_contract(c: CompileContract,
                           device=None) -> "List[Finding]":
    """Run one compile contract on ``device`` (default: the card): build,
    then the call sequence, each inside a prepare-once window; compare
    the counted calls' tally against ``expected``."""
    from repro_torch.device import resolve_device
    if c.build is None:
        raise ValueError(f"compile contract {c.name!r} has no build()")
    fn, calls = c.build(resolve_device(device))
    counts: "Counter" = Counter()
    for i, args in enumerate(calls):
        with trace_compiles() as prepares:
            fn(*args)
        if i >= c.warmup:
            counts.update(tally(prepares))
    return _tally_findings(counts, c.expected, c.name, c.rule, c.path,
                           c.line)


def run_registered(names: "Optional[Sequence[str]]" = None,
                   device=None) -> "List[Finding]":
    registry = load_registered()
    if names is None:
        names = sorted(registry)
    findings: "List[Finding]" = []
    for name in names:
        findings.extend(check_compile_contract(registry[name], device))
    return findings


def check_fixture(path: str) -> "List[Finding]":
    """Check a fixture module declaring ``EXPECTED_PREPARES`` (name ->
    count) and ``run()`` (its every prepare counted).  Used by the
    known-bad fixture tests: a shape-varying loop trips REPRO-T01."""
    spec = importlib.util.spec_from_file_location("_retrace_fixture", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with trace_compiles() as prepares:
        mod.run()
    return _tally_findings(tally(prepares), mod.EXPECTED_PREPARES,
                           getattr(mod, "NAME", path), "REPRO-T01",
                           relpath(path), 1)
