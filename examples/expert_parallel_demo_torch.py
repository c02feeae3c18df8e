"""Expert parallelism demo of the PyTorch port on 4 ranks.

The padding-free MoE layer runs with its 8 experts sharded 4 ways (2 a
rank) over a (1, 4) mesh of gloo ranks; every rank checks its output
against the single-rank layer, and the collectives each rank made are
printed (the reference's demo prints the ones in its compiled HLO).

  PYTHONPATH=src python examples/expert_parallel_demo_torch.py
  PYTHONPATH=src python examples/expert_parallel_demo_torch.py --device cpu

By default the four ranks share ``cuda:0`` (gloo: NCCL takes one rank a
device) and launch the CUDA kernels; with ``--device cpu`` each rank
runs the kernels' plain versions.
"""
import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.core.moe import (MoEConfig, init_moe_params,  # noqa: E402
                                  moe_apply, slice_moe_params)
from repro_torch.distributed import context as dctx  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.ranks import run_ranks  # noqa: E402

CFG = MoEConfig(num_experts=8, top_k=2, d_model=256, d_ff_expert=128,
                num_shared_experts=1, capacity_factor=8.0, precision="bf16")
EP = 4


def rank_main(rank, world, device):
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_moe_params(CFG, generator=gen, device=dev)
    x = torch.randn((16 * 128, CFG.d_model), generator=gen, device=dev)
    with torch.inference_mode():
        y_ref, _ = moe_apply(params, x, CFG)          # single rank
        mesh = make_mesh((1, EP), ("data", "model"))
        local = slice_moe_params(params, CFG, mesh)
        dctx.reset_collectives()
        y, aux = moe_apply(local, x, CFG, ep_rank=mesh.coord("model"),
                           ep_size=EP, group=mesh.group("model"))
    err = float((y - y_ref).abs().max())
    rel = err / max(float(y_ref.abs().max()), 1e-6)
    return {"err": err, "rel": rel, "collectives": dict(dctx.COLLECTIVES),
            "experts": local["w_gate"].shape[0],
            "dropped_fraction": float(aux["dropped_fraction"])}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available")
    results = run_ranks(rank_main, EP, args=(args.device,), timeout=300)
    for r, res in enumerate(results):
        print(f"rank {r}: {res['experts']} experts, EP({EP}-way) vs "
              f"single-rank max |err| {res['err']:.2e} (rel "
              f"{res['rel']:.2e}), dropped {res['dropped_fraction']:.3f}, "
              f"collectives {res['collectives']}")
        # relative criterion: the ranks' partials are summed in another
        # order than one rank adds its experts
        if not res["rel"] < 1e-3:
            raise SystemExit(f"rank {r}: EP output differs by {res['rel']}")
    print("OK: padding-free MoE is EP-sharded and numerically faithful")


if __name__ == "__main__":
    main()
