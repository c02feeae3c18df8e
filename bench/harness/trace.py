"""The device trace of a window and the host's spans beside it.

:class:`Spans` keeps the host's spans of a run (name, start, end on the
host clock) and CUDA-event spans around calls into the program's layers.
:func:`traced` profiles the device alone (``torch.profiler`` with CUDA
activity only: kernels, copies and fills), and :func:`read_trace` turns
the profile into the device ops of the window, the time the device was
busy (the union of their intervals), the ops that took most time and the
idle gaps labelled by the host span they fall in.  The first device op
of the window is a marker fill launched at the window's start on the
host clock, which aligns the two clocks.
"""
from __future__ import annotations

import contextlib
import time

import torch

#: a device op's name in the breakdown is cut to this many characters
NAME_CHARS = 160


class Spans:
    """Host spans (``with spans.host(name):``) and device-timed spans
    (``spans.cuda(name)``: CUDA events around the call, summed once the
    window closes)."""

    def __init__(self):
        self.host_spans = []          # (name, t0_ns, t1_ns)
        self.events = {}              # name -> [(start event, end event)]

    @contextlib.contextmanager
    def host(self, name: str):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.host_spans.append((name, t0, time.perf_counter_ns()))

    @contextlib.contextmanager
    def cuda(self, name: str):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        try:
            yield
        finally:
            b.record()
            self.events.setdefault(name, []).append((a, b))

    def cuda_ms(self, name: str) -> list:
        """Each recorded span's device milliseconds (after a sync)."""
        return [a.elapsed_time(b) for a, b in self.events.get(name, ())]


@contextlib.contextmanager
def traced(enabled: bool):
    """A device-only profile of the block (None where not ``enabled``)."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        yield prof


def marker(device) -> int:
    """Launch the window's marker fill; returns its host time (ns)."""
    torch.cuda.synchronize()
    t = time.perf_counter_ns()
    torch.empty(1, device=device).fill_(0.0)
    return t


def device_ops(prof) -> list:
    """(name, start_us, end_us) of every device op of the profile, by
    start: read from the profiler's raw events where it has them, which
    skips building an event tree of millions of kernels."""
    from torch.autograd import DeviceType
    raw = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    try:
        ops = [(e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3)
               for e in raw.events() if e.device_type() == DeviceType.CUDA
               and not getattr(e, "is_hidden_event", lambda: False)()]
    except AttributeError:        # no raw events in this version
        ops = [(e.name, e.time_range.start, e.time_range.end)
               for e in prof.events() if e.device_type == DeviceType.CUDA]
    ops.sort(key=lambda o: o[1])
    return ops


def read_trace(prof, spans: Spans, t_window_ns: int, window_s: float,
               top: int = 10) -> dict:
    """The window's ``ops`` (name, start_s, end_s from the window's
    start), their seconds ``by_name``, ``busy_s``, and the breakdown:
    ``device_ops`` (the ``top`` names by summed seconds) and
    ``idle_gaps`` (seconds of idle device time by the host span it fell
    in)."""
    ops = device_ops(prof)
    if not ops:
        return {"ops": [], "by_name": {}, "busy_s": 0.0, "device_ops": [],
                "idle_gaps": []}
    t0 = ops[0][1]                       # the marker
    end = window_s * 1e6
    win = [(n, (s - t0) / 1e6, (e - t0) / 1e6) for n, s, e in ops
           if s - t0 < end]
    busy, gaps, cur_s, cur_e = 0.0, [], None, None
    for _, s, e in win:
        e = min(e, window_s)
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    if cur_e < window_s:
        gaps.append((cur_e, window_s))
    by_name = {}
    for n, s, e in win:
        by_name[n] = by_name.get(n, 0.0) + (min(e, window_s) - s)
    host = [(n, (a - t_window_ns) / 1e9, (b - t_window_ns) / 1e9)
            for n, a, b in spans.host_spans]
    idle = {}
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        label = next((n for n, a, b in reversed(host) if a <= mid <= b),
                     "outside any span")
        idle[label] = idle.get(label, 0.0) + (g1 - g0)
    return {"ops": win, "by_name": by_name, "busy_s": busy,
            "device_ops": sorted(([n[:NAME_CHARS], t]
                                  for n, t in by_name.items()),
                                 key=lambda r: -r[1])[:top],
            "idle_gaps": sorted(([n, t] for n, t in idle.items()),
                                key=lambda r: -r[1])[:top]}


def kernel_seconds(by_name: dict, marks: list) -> float:
    """Summed seconds of the ops whose name holds one of ``marks``
    (``by_name``: seconds by op name, as :func:`read_trace` gives)."""
    return sum(t for n, t in by_name.items() if any(m in n for m in marks))
