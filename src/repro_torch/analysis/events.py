"""Event bus for counting structural actions of the port.

Product modules (``kernels.plan``, ``core.quantization``) emit one event
per structurally interesting action: a TilePlan schedule build, a
standalone tilewise quantization.  A :func:`capture` window around a call
observes exactly one event per occurrence, so a test can pin the
plan-once and quantize-once counts without patching anything.

Zero-cost by default: :func:`emit` is a no-op (one truthiness check on a
module-level list) unless a capture window is open.  This module is
stdlib-only and imported by hot-path modules; keep it free of torch
imports.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Iterator, List


@dataclasses.dataclass(frozen=True)
class Event:
    """One emitted occurrence.  ``data`` holds only static (Python-level)
    values: shapes, block sizes, group counts, never tensors."""
    kind: str
    data: "dict[str, Any]"


# stack of open capture windows; emit() appends to every open one so
# nested captures stay correct
_SINKS: "List[List[Event]]" = []


def emit(kind: str, **data: Any) -> None:
    """Record one occurrence.  No-op unless a capture window is open."""
    if _SINKS:
        ev = Event(kind, data)
        for sink in _SINKS:
            sink.append(ev)


@contextlib.contextmanager
def capture() -> Iterator["List[Event]"]:
    """Open a capture window; yields the (live) list of events emitted
    while the window is open."""
    sink: "List[Event]" = []
    _SINKS.append(sink)
    try:
        yield sink
    finally:
        _SINKS.remove(sink)


def count(events: "List[Event]", kind: str) -> int:
    return sum(1 for e in events if e.kind == kind)


def of_kind(events: "List[Event]", kind: str) -> "List[Event]":
    return [e for e in events if e.kind == kind]
