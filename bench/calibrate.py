"""The readings the limits of the check of outputs are set from.

    python3 bench/calibrate.py --workload ds16b.train --seeds 11,12,13 \\
        --control 3 --seconds 3

For each seed, in one process, a run of the cell as ``run.py`` makes it
(:func:`harness.cell.run`: set-up, a window of ``--seconds``, the check
of outputs), with the compared numbers of the program against the
reference and, for the first ``--control`` seeds, the control's: the
reference at the ``int4`` grid in the program's place.  One JSON line a
seed, with the run's result line.  Not run by the benchmark itself.
"""
import argparse
import contextlib
import json
import os
import sys
import tempfile
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent


def readings(m, workload, seed, seconds, device, control) -> dict:
    """The compared numbers of one run of ``workload`` from ``seed``
    (with ``control``, a grid, the control's too), through the run's own
    path (:func:`harness.cell.run`), and its result line's object under
    ``"result"``."""
    from harness import cell
    result, _, r = cell.run(m, workload, seed=seed, seconds=seconds,
                            trace=False, device=device,
                            t_start=time.perf_counter(), control=control)
    return {**r, "result": result}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--grid", default="int4")
    ap.add_argument("--fault", default=None,
                    help="plant a fault of faults.FAULTS underneath")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(BENCH))
    sys.path.insert(0, str(BENCH.parent / "src"))
    from run import ALLOC_CONF
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", ALLOC_CONF)
    from faults import FAULTS
    from harness import manifest
    m = manifest.load(BENCH.parent / "BENCHMARK.json")
    fault = FAULTS[args.fault] if args.fault else contextlib.nullcontext
    with tempfile.TemporaryDirectory(prefix="bench-tileplan-") as tmp:
        os.environ["REPRO_TORCH_TILEPLAN_CACHE"] = str(
            Path(tmp) / "tileplan_cache.json")
        for i, seed in enumerate(int(x) for x in args.seeds.split(",")):
            t0 = time.perf_counter()
            with fault():
                r = readings(m, args.workload, seed, args.seconds,
                             args.device,
                             args.grid if i < args.control else None)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "fault": args.fault,
                              "seconds": time.perf_counter() - t0, **r}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
