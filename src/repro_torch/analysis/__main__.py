"""Command line of the port's kernel contract checker.

    python -m repro_torch.analysis [--contracts] [--registry] [--ast]
                                   [--resources] [--retrace] [--all]
                                   [--paths P ...] [--baseline FILE]
                                   [--json] [--list-rules]
                                   [--no-run-contracts] [--device D]

Exit status 0 iff no findings outside the baseline.  Layers:

* ``--contracts``  layer 1: contracts over the fp8 entry points, run on
  ``--device`` (includes one real Engine generate unless
  ``--no-run-contracts``)
* ``--registry``   layer 2: operator-registry + tile-pool alignment lint
* ``--ast``        layer 3: AST lint over ``--paths`` (default
  src/repro_torch)
* ``--resources``  layer 4: the Hopper resource model over the registered
  operators x the whole tile pool (pure arithmetic)
* ``--retrace``    layer 5: prepare-once contracts (they execute, so
  ``--no-run-contracts`` skips them)
* ``--all``        everything; also the default

``--device`` is where the executing layers run: ``cuda`` (the default:
the kernels launch) or ``cpu`` (their plain versions).
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.analysis import findings as fmod


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="kernel contract checker of the PyTorch port "
                    "(padding-free / quantize-once / alignment / resource "
                    "invariants)")
    p.add_argument("--contracts", action="store_true",
                   help="run layer 1 contracts")
    p.add_argument("--registry", action="store_true",
                   help="run layer 2 registry/alignment lint")
    p.add_argument("--ast", action="store_true",
                   help="run layer 3 AST lint")
    p.add_argument("--resources", action="store_true",
                   help="run layer 4 kernel-resource lint (Hopper model)")
    p.add_argument("--retrace", action="store_true",
                   help="run layer 5 prepare-once contracts")
    p.add_argument("--all", action="store_true",
                   help="run every layer (default when no layer given)")
    p.add_argument("--paths", nargs="*", default=None,
                   help="files/dirs for the AST layer (default: "
                        "src/repro_torch)")
    p.add_argument("--baseline", default=None,
                   help="JSON baseline of accepted finding keys")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="emit findings as JSON")
    p.add_argument("--list-rules", action="store_true",
                   help="print every rule ID with its rationale and exit")
    p.add_argument("--no-run-contracts", action="store_true",
                   help="skip the executing checks (the Engine generate "
                        "and the layer 5 contracts)")
    p.add_argument("--device", default="cuda",
                   help="where the contracts run: cuda (default) or cpu")
    args = p.parse_args(argv)

    if args.list_rules:
        print(fmod.describe_rules())
        return 0

    if not (args.contracts or args.registry or args.ast
            or args.resources or args.retrace):
        args.all = True
    if args.all:
        args.contracts = args.registry = args.ast = True
        args.resources = args.retrace = True

    layers: "dict[str, list]" = {}
    pruned = None
    if args.ast:
        from repro_torch.analysis import ast_lint
        layers["ast"] = ast_lint.scan_paths(args.paths)
    if args.registry:
        from repro_torch.analysis import registry_lint
        layers["registry"] = registry_lint.run()
    if args.resources:
        from repro_torch.analysis import resource_lint
        pruned_entries: list = []
        layers["resources"] = resource_lint.run(pruned=pruned_entries)
        pruned = len(pruned_entries)
    if args.contracts:
        from repro_torch.analysis import contracts
        layers["contracts"] = contracts.run_registered(
            include_run_mode=not args.no_run_contracts, device=args.device)
    if args.retrace and not args.no_run_contracts:
        from repro_torch.analysis import retrace
        layers["retrace"] = retrace.run_registered(device=args.device)

    findings = [f for fs in layers.values() for f in fs]
    baseline = fmod.load_baseline(args.baseline)
    live = fmod.filter_baselined(findings, baseline)
    suppressed = len(findings) - len(live)

    if args.as_json:
        print(json.dumps({"findings": [f.to_dict() for f in live],
                          "suppressed": suppressed,
                          "layers": {k: len(v) for k, v in layers.items()},
                          "resources_pruned": pruned}, indent=2))
    else:
        for f in live:
            print(f.format())
        tail = f" ({suppressed} baselined)" if suppressed else ""
        if pruned is not None:
            tail += (f"; {pruned} pool entries pruned by the resource "
                     f"model (no CUDA variant)")
        print(f"repro_torch.analysis: {len(live)} finding(s){tail}")
    return 1 if live else 0


if __name__ == "__main__":
    sys.exit(main())
