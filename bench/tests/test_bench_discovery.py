"""A new configuration, traffic mix, per-layer metric and cell are new
files and new manifest entries: in a temp copy of the benchmark, the
harness runs the new cell and reads the new metric with no edit to any
file that was there."""
import hashlib
import json
import os
import shutil
import subprocess
import sys

import smoke_cells as sc
from harness import manifest

DRIVE = r"""
import json, sys, time
sys.path[:0] = ["bench", "src"]
import torch
from harness import cell, manifest
m = manifest.load(manifest.ROOT / "BENCHMARK.json")
result, _, _ = cell.run(m, "dummy.cell", seed=2 ** 31 + 21, seconds=0.2,
                        trace=False, device="cpu",
                        t_start=time.perf_counter())
w = manifest.cell(m, "dummy.cell")
run = cell.Run(w, None, None, None, {"ops": [], "by_name": {},
                                         "busy_s": 0.0}, {})
print(json.dumps({"result": result, "per_layer": cell.per_layer(m, run)}))
"""


def _digests(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_new_cell_is_files_and_entries(tmp_path):
    shutil.copytree(manifest.BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(manifest.ROOT / "BENCHMARK.json", tmp_path)
    os.symlink(manifest.ROOT / "src", tmp_path / "src")
    before = _digests(tmp_path / "bench")
    b = tmp_path / "bench"
    (b / "configs" / "dummy-smoke.json").write_text(json.dumps(sc.DS_SMOKE))
    (b / "traffic" / "dummy_mix.json").write_text(json.dumps(sc.DECODE))
    (b / "checks" / "dummy.cell.json").write_text(
        json.dumps({"limits": sc.LIMITS_SERVE}))
    (b / "metrics" / "dummy_metric.py").write_text(
        "def read(run, name):\n    return 42.0\n")
    m = json.loads((tmp_path / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "dummy-smoke", "source": "smoke",
                         "file": "bench/configs/dummy-smoke.json",
                         "reduced": [], "why": "a test"})
    m["workloads"].append({"name": "dummy.cell", "config": "dummy-smoke",
                           "traffic": "dummy_mix", "chips": 1,
                           "why": "a test"})
    next(e for e in m["end_to_end"]
         if e["name"] == "decode_tok_s")["workloads"].append("dummy.cell")
    m["per_layer"].append({"name": "dummy_metric", "unit": "%",
                           "better": "higher", "source": "device_trace",
                           "layer": "kernels", "moves": "decode_tok_s",
                           "workloads": ["dummy.cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    out = subprocess.run([sys.executable, "-c", DRIVE], cwd=tmp_path,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.splitlines()[-1])
    assert got["result"]["correct"] is True
    assert set(got["result"]["metrics"]) == {"decode_tok_s", "peak_mem_gib",
                                             "setup_s"}
    assert got["per_layer"] == {"dummy_metric": {"value": 42.0, "unit": "%"}}
    after = _digests(tmp_path / "bench")
    assert {p: d for p, d in after.items() if p in before} == before
