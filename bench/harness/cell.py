"""One run of one cell: set-up and window (:mod:`harness.drivers`), the
end-to-end metrics, the per-layer metrics of a traced run (each read by
its own file under ``metrics/``), then, with the program's state freed,
the check of outputs against the plain reference."""
from __future__ import annotations

import dataclasses
import gc

import torch

from harness import check, drivers, manifest
from harness import trace as tr
from harness.model import port_config, shape

GIB = 2 ** 30


@dataclasses.dataclass
class Run:
    """What a per-layer metric's reader reads."""
    workload: dict
    shape: object
    traffic: dict
    window: drivers.Window
    trace: dict                  # harness.trace.read_trace's, or {}
    active: dict                 # experts with rows, by rows routed at
                                 # once (the check's reference routing)

    def kernel_seconds(self, *list_names: str) -> float:
        """Device seconds of the ops named in any of the lists."""
        marks = [k for n in list_names for k in manifest.kernel_names(n)]
        return tr.kernel_seconds(self.trace["by_name"], marks)

    def device_seconds(self) -> float:
        return sum(self.trace["by_name"].values())


def end_to_end(m: dict, w: dict, win: drivers.Window) -> dict:
    work = win.work
    values = {"setup_s": win.setup_s,
              "peak_mem_gib": win.peak_bytes / GIB}
    if work["kind"] == "train":
        values["train_tok_s"] = work["tokens"] / win.window_s
    elif work["max_new_tokens"] > 1:
        values["decode_tok_s"] = work["generated"] / win.window_s
    else:
        ttft = sorted(work["ttft_ms"])
        values["ttft_p95_ms"] = ttft[min(len(ttft) - 1,
                                         int(0.95 * len(ttft)))]
    units = {e["name"]: e["unit"] for e in m["end_to_end"]}
    return {k: {"value": values[k], "unit": units[k]}
            for k in manifest.end_to_end_of(m, w["name"])}


def per_layer(m: dict, run_: Run) -> dict:
    """Each per-layer metric of the cell, read by its own file; a reader
    that finds nothing to read returns None and the metric is left out."""
    units = {p["name"]: p["unit"] for p in m["per_layer"]}
    out = {}
    for name in manifest.per_layer_of(m, run_.workload["name"]):
        value = manifest.metric_reader(name)(run_, name)
        if value is not None:
            out[name] = {"value": value, "unit": units[name]}
    return out


def run(m: dict, workload: str, *, seed: int, seconds: float, trace: bool,
        device, t_start: float, limits=None, control=None) -> tuple:
    """Returns ``(result, compared, readings)``: the result line's object,
    the compared numbers, each ``(name, value, limit)``, and all that the
    check of outputs read (with ``control``, a grid, the control's too:
    the calibration of the limits)."""
    w = manifest.cell(m, workload)
    cj = manifest.config_of(m, w)
    traffic = manifest.traffic_of(w)
    s = shape(cj)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ctx = drivers.Ctx(device=torch.device(device), seed=seed,
                      seconds=seconds, trace=trace, shape=s,
                      port_cfg=port_config(cj), traffic=traffic,
                      t_start=t_start)
    win = drivers.DRIVERS[traffic["kind"]](ctx)
    metrics = end_to_end(m, w, win)
    result = {"correct": False, "attempted": win.attempted,
              "failed": win.failed}
    dev = {"platform": "gpu" if ctx.device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(ctx.device)
                    if ctx.device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": win.peak_bytes}
    tdata = None
    if trace:
        if win.prof is None:
            raise RuntimeError("a traced run needs the card's profiler")
        tdata = tr.read_trace(win.prof, win.spans, win.t_window_ns,
                              win.window_s)
        dev.update(busy_s=tdata["busy_s"], window_s=win.window_s)
        result["breakdown"] = {"device_ops": tdata["device_ops"],
                               "idle_gaps": tdata["idle_gaps"]}
    # the program's state is gone with its driver; the profile and the
    # outputs go before the reference runs
    outputs, win.prof, win.outputs = win.outputs, None, None
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    readings = compare(s, traffic, win.work, outputs, seed, ctx.device,
                       control)
    del outputs
    if trace:
        metrics = per_layer(m, Run(w, s, traffic, win, tdata,
                                   readings.get("active_experts", {})))
    ok, compared = check.verdict(
        readings, manifest.checks_of(w) if limits is None else limits)
    result.update(correct=ok, metrics=metrics, device=dev)
    result["check"] = {n: {"value": v, "limit": lim}
                       for n, v, lim in compared}
    return result, compared, readings


def compare(s, traffic, work, outputs, seed, device, control=None) -> dict:
    """The compared numbers (and, with ``control``, the control's)."""
    if work["kind"] == "train":
        r = check.reference_train(s, traffic, seed, device, "e4m3")
        out = check.train_readings(outputs, r)
        if control is not None:
            c = check.reference_train(s, traffic, seed, device, control)
            out["control"] = check.train_readings(c, r)
        return out
    return check.serve_readings(outputs, s, seed, device, "e4m3", control)
