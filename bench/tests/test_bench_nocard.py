"""Without a card, or outside a checkout with the port, a run exits
nonzero and prints no result."""
import json
import shutil
import subprocess
import sys

import pytest
import torch

from harness import manifest


def _run(cwd):
    return subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "ds16b.train",
         "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def _no_result(out):
    for line in out.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run(manifest.ROOT)
    assert out.returncode != 0
    _no_result(out)


def test_only_the_benchmark_files_no_result(tmp_path):
    shutil.copytree(manifest.BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(manifest.ROOT / "BENCHMARK.json", tmp_path)
    out = _run(tmp_path)
    assert out.returncode != 0
    _no_result(out)
