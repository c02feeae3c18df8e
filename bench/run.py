"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 bench/run.py --workload ds16b.train --seed 1 --seconds 20 \\
        --trace 0

Runs on the machine it is started on, from the root of a checkout that
holds ``src/repro_torch``; it needs as many CUDA cards as the cell asks
for and exits nonzero, printing no result, without them.  The last line
of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics), ``device`` and, last, ``check``:
each number the check of outputs compared, with its limit (also the last
lines of standard error).  Kernel builds stay in the checkout
(``build/``); the decode-tile cache is a fresh file under ``TMPDIR``.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: the caching allocator grows its segments rather than splitting fixed
#: ones: the training cell's peak fits the card only without that
#: fragmentation (11.6 GiB reserved but unusable at 65.4 GiB allocated)
ALLOC_CONF = "expandable_segments:True"


def loaded_forbidden() -> list:
    """Modules loaded in this process whose top-level name is one of
    :data:`FORBIDDEN`, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({n for n in sys.modules if n.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(BENCH))
    from harness import manifest
    m = manifest.load(ROOT / "BENCHMARK.json")
    w = manifest.cell(m, args.workload)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", ALLOC_CONF)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < w["chips"]:
        print(f"bench: {args.workload} needs {w['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"bench: no src/repro_torch under {ROOT}", file=sys.stderr)
        return 3
    sys.path.insert(0, str(ROOT / "src"))
    with tempfile.TemporaryDirectory(prefix="bench-tileplan-") as tmp:
        os.environ["REPRO_TORCH_TILEPLAN_CACHE"] = str(
            Path(tmp) / "tileplan_cache.json")
        from harness import cell
        result, compared, _ = cell.run(
            m, args.workload, seed=args.seed, seconds=args.seconds,
            trace=bool(args.trace), device="cuda", t_start=T_START)
    bad = loaded_forbidden()
    if bad:
        print(f"bench: the process loaded {bad}", file=sys.stderr)
        return 4
    for name, value, limit in compared:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
