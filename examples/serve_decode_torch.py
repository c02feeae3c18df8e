"""Batched serving on the PyTorch port: prefill a batch of prompts, then
decode with temperature sampling; exercises the KV-cache (and
recurrent-state) serving path (``examples/serve_decode.py`` of the JAX
package, on ``src/repro_torch``).

  PYTHONPATH=src python examples/serve_decode_torch.py --arch recurrentgemma-2b
  PYTHONPATH=src python examples/serve_decode_torch.py --device cpu

Sampling draws from a seeded ``torch.Generator`` on the model's device.
On a CUDA card (the default) the model runs the port's kernels; on the
CPU their plain versions.
"""
import argparse

import torch

from repro_torch.configs import smoke_config
from repro_torch.models.model_zoo import make_model, synthetic_batch
from repro_torch.serve.engine import Engine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="recurrentgemma-2b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch)
    model = make_model(cfg, args.device)
    params = model.init_params(
        torch.Generator(device=model.device).manual_seed(0))
    engine = Engine(model, params, max_new_tokens=args.max_new,
                    temperature=args.temperature, device=model.device)

    batch = synthetic_batch(
        torch.Generator(device=model.device).manual_seed(1), cfg,
        args.prompt_len, args.batch)
    res = engine.generate(
        batch, generator=torch.Generator(device=model.device).manual_seed(42))
    for i in range(args.batch):
        print(f"request {i}: {res.tokens[i].tolist()}")
    kind = "recurrent" if cfg.family in ("ssm", "hybrid") else "KV-cache"
    print(f"{int(res.num_generated.sum())} tokens generated "
          f"({cfg.name}, {kind} decode)")
    return res


if __name__ == "__main__":
    main()
