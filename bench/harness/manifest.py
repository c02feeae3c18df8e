"""The manifest (``BENCHMARK.json``) and the files it names by name.

A cell of ``workloads`` names a configuration and a traffic mix; the
harness finds ``configs/<config file>``, ``traffic/<traffic>.json``,
``checks/<workload>.json`` (the limits of the check of outputs) and, in a
traced run, ``metrics/<metric>.py`` for each per-layer metric of the
cell (``metrics/<base>.py`` for a metric named ``<base>.<suffix>``).  A
new configuration, mix, cell or metric is new files and new entries, no
edit of a file that is there.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES_E2E = ("host_clock", "device_trace")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


class ManifestError(ValueError):
    pass


def load(path: Path = ROOT / "BENCHMARK.json") -> dict:
    m = json.loads(Path(path).read_text())
    validate(m)
    return m


def _line(text, what):
    if not isinstance(text, str) or not 1 <= len(text) <= 200 \
            or "\n" in text or "\t" in text:
        raise ManifestError(f"{what}: 1 to 200 characters on one line")


def _name(name, what):
    if not isinstance(name, str) or not NAME.match(name):
        raise ManifestError(f"{what} {name!r}: not a valid name")


def _keys(entry, allowed, what, optional=()):
    keys = set(entry)
    if not set(allowed) <= keys or not keys <= set(allowed) | set(optional):
        raise ManifestError(f"{what}: keys {sorted(keys)}, expected "
                            f"{sorted(allowed)} (optional {list(optional)})")


def validate(m: dict) -> None:
    """Raise :class:`ManifestError` where ``m`` breaks the benchmark's
    rules on names, units, sources and which cells report what."""
    if set(m) != TOP_KEYS:
        raise ManifestError(f"top-level keys {sorted(m)}")
    if not 1 <= m["run_seconds"] <= 51 or int(m["run_seconds"]) != \
            m["run_seconds"]:
        raise ManifestError("run_seconds: a whole number from 1 to 51")
    configs = {}
    for c in m["configs"]:
        _keys(c, ("name", "source", "file", "reduced", "why"), "config")
        _name(c["name"], "config")
        _line(c["source"], "source")
        _line(c["why"], "why")
        for k in c["reduced"]:
            _name(k, "reduced key")
        if c["name"] in configs:
            raise ManifestError(f"config {c['name']} twice")
        configs[c["name"]] = c
    cells, pairs = {}, set()
    for w in m["workloads"]:
        _keys(w, ("name", "config", "traffic", "chips", "why"), "workload")
        for k in ("name", "config", "traffic"):
            _name(w[k], k)
        _line(w["why"], "why")
        if w["config"] not in configs or w["chips"] not in (1, 4):
            raise ManifestError(f"workload {w['name']}: config or chips")
        if w["name"] in cells or (w["config"], w["traffic"]) in pairs:
            raise ManifestError(f"workload {w['name']} twice")
        cells[w["name"]] = w
        pairs.add((w["config"], w["traffic"]))
    names = set()
    e2e = {}
    for e in m["end_to_end"]:
        _keys(e, ("name", "unit", "better", "bound", "source"), "metric",
              ("workloads",))
        if e["source"] not in SOURCES_E2E:
            raise ManifestError(f"{e['name']}: end-to-end source")
        if not 0 < e["bound"] <= 0.25:
            raise ManifestError(f"{e['name']}: bound")
        e2e[e["name"]] = e
    for e in m["end_to_end"] + m["per_layer"]:
        _name(e["name"], "metric")
        if not UNIT.match(e["unit"]) or e["better"] not in ("lower",
                                                            "higher"):
            raise ManifestError(f"{e['name']}: unit or better")
        if e["name"] in names:
            raise ManifestError(f"metric {e['name']} twice")
        names.add(e["name"])
        for w in e.get("workloads", ()):
            if w not in cells:
                raise ManifestError(f"{e['name']}: unknown cell {w}")
    if "setup_s" not in e2e:
        raise ManifestError("setup_s is missing")
    for p in m["per_layer"]:
        _keys(p, ("name", "unit", "better", "source", "layer", "moves"),
              "metric", ("workloads",))
        if p["source"] not in SOURCES:
            raise ManifestError(f"{p['name']}: source")
        _line(p["layer"], "layer")
        if p["moves"] not in e2e or p["moves"] == "setup_s":
            raise ManifestError(f"{p['name']}: moves {p['moves']}")
        for w in p.get("workloads", cells):
            if p["moves"] not in end_to_end_of(m, w):
                raise ManifestError(f"{p['name']} moves {p['moves']}, "
                                    f"which cell {w} does not report")
    for w in cells:
        mine = end_to_end_of(m, w)
        if "setup_s" not in mine or len(mine) < 2 or not per_layer_of(m, w):
            raise ManifestError(f"cell {w}: setup_s, another end-to-end "
                                f"metric and a per-layer metric")


def end_to_end_of(m: dict, workload: str) -> list:
    return [e["name"] for e in m["end_to_end"]
            if workload in e.get("workloads", [workload])]


def per_layer_of(m: dict, workload: str) -> list:
    return [p["name"] for p in m["per_layer"]
            if workload in p.get("workloads", [workload])]


def cell(m: dict, workload: str) -> dict:
    for w in m["workloads"]:
        if w["name"] == workload:
            return w
    raise ManifestError(f"no workload {workload!r} in BENCHMARK.json")


def config_of(m: dict, w: dict) -> dict:
    c = next(c for c in m["configs"] if c["name"] == w["config"])
    return json.loads((ROOT / c["file"]).read_text())


def traffic_of(w: dict) -> dict:
    return json.loads((BENCH / "traffic" / f"{w['traffic']}.json")
                      .read_text())


def checks_of(w: dict) -> dict:
    """The limits of the cell's check of outputs: name -> limit."""
    return json.loads((BENCH / "checks" / f"{w['name']}.json")
                      .read_text())["limits"]


def metric_reader(name: str):
    """The ``read(run, name)`` function of ``metrics/<name>.py``, else of
    ``metrics/<base>.py`` for ``<base>.<suffix>``."""
    for stem in (name, name.split(".")[0]):
        path = BENCH / "metrics" / f"{stem}.py"
        if path.is_file():
            spec = importlib.util.spec_from_file_location(
                f"bench_metric_{stem.replace('.', '_')}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise ManifestError(f"no reader for metric {name!r} under "
                        f"{BENCH / 'metrics'}")


def kernel_names(list_name: str) -> list:
    """The marks listed in ``kernels/<list_name>.txt`` (one a line)."""
    text = (BENCH / "kernels" / f"{list_name}.txt").read_text()
    return [ln.strip() for ln in text.splitlines()
            if ln.strip() and not ln.startswith("#")]
