"""The reading of a device trace: busy time as the union of the ops'
intervals inside the window, idle gaps labelled by the host span they
fall in, ops summed by name."""
import types

from torch.autograd import DeviceType

from harness import trace as tr


def _prof(ops):
    events = [types.SimpleNamespace(
        name=n, device_type=DeviceType.CUDA,
        time_range=types.SimpleNamespace(start=s, end=e)) for n, s, e in ops]
    events.append(types.SimpleNamespace(
        name="host op", device_type=DeviceType.CPU,
        time_range=types.SimpleNamespace(start=0, end=10 ** 9)))
    return types.SimpleNamespace(events=lambda: events)


def test_busy_gaps_and_names():
    # us from the marker at 1000: marker, a, b overlapping a, a gap of
    # 2 ms, c, then one op past the window's 10 ms
    ops = [("fill marker", 1000, 1001), ("a", 1100, 3100),
           ("b", 2100, 4100), ("c", 6100, 7100), ("a", 7100, 8100),
           ("late", 20000, 21000)]
    spans = tr.Spans()
    t0 = 5_000_000_000
    spans.host_spans = [("step", t0, t0 + 4_000_000),
                        ("sync", t0 + 4_000_000, t0 + 10_000_000)]
    r = tr.read_trace(_prof(ops), spans, t0, 0.010)
    # busy: marker 1 us, a|b 3000 us, c|a 2000 us
    assert abs(r["busy_s"] - 0.005001) < 1e-9
    assert [n for n, _ in r["device_ops"]] == ["a", "b", "c",
                                               "fill marker"]
    assert abs(r["device_ops"][0][1] - 0.003) < 1e-9
    idle = dict(r["idle_gaps"])
    # gaps: 0.001-0.1 ms, 3.1-5.1 ms (mid in "sync"), 7.1-10 ms
    assert abs(idle["sync"] - (0.002 + 0.0029)) < 1e-9
    assert abs(idle["step"] - 0.000099) < 1e-9
    assert "late" not in [n for n, _, _ in r["ops"]]
    assert abs(tr.kernel_seconds(r["by_name"], ["b", "c"]) - 0.003) < 1e-9


def test_the_raw_events_read_as_the_parsed_ones():
    ops = [("fill marker", 1000, 1001), ("a", 1100, 3100), ("c", 6100, 7100)]

    def raw(n, s, e, dev=DeviceType.CUDA, hidden=False):
        return types.SimpleNamespace(
            name=lambda: n, device_type=lambda: dev,
            start_ns=lambda: s * 1000, end_ns=lambda: e * 1000,
            is_hidden_event=lambda: hidden)
    events = [raw(*o) for o in reversed(ops)]
    events += [raw("host op", 0, 10 ** 9, DeviceType.CPU),
               raw("hidden", 1500, 1600, hidden=True)]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    assert tr.device_ops(prof) == tr.device_ops(_prof(ops)) == \
        [(n, float(s), float(e)) for n, s, e in ops]
