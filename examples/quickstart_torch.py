"""Quickstart on the PyTorch port: train a small dense LM for a few
steps, then generate (``examples/quickstart.py`` of the JAX package, on
``src/repro_torch``).

  PYTHONPATH=src python examples/quickstart_torch.py [--steps 60]
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu --steps 20

Uses the public API only: configs registry -> model zoo -> data
pipeline -> trainer -> serving engine.  Trains the reduced qwen3-1.7b
in f32 and asserts that the loss fell.  On a CUDA card (the default)
the model runs the port's kernels; on the CPU their plain versions.
"""
import argparse
import dataclasses

import torch

from repro_torch.configs import smoke_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models.model_zoo import make_model, synthetic_batch
from repro_torch.optim import adamw
from repro_torch.serve.engine import Engine
from repro_torch.train.trainer import make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = dataclasses.replace(smoke_config(args.arch), dtype=torch.float32)
    model = make_model(cfg, args.device)
    params = model.init_params(
        torch.Generator(device=model.device).manual_seed(0))
    print(f"{cfg.name} (reduced): {cfg.param_count()/1e6:.1f}M params")

    opt_cfg = adamw.OptConfig(lr=1e-3, total_steps=args.steps,
                              warmup_steps=5, use_master=False)
    opt_state = adamw.init_opt_state(params, opt_cfg)
    step_fn = make_train_step(model.loss, opt_cfg)

    data = SyntheticLM(DataConfig(seed=0, batch_size=8, seq_len=128), cfg,
                       device=model.device)
    first = last = None
    for step in range(args.steps):
        params, opt_state, m = step_fn(params, opt_state,
                                       data.batch_at(step))
        if step == 0:
            first = float(m["loss"])
        last = float(m["loss"])
        if step % 10 == 0:
            print(f"step {step:3d}  loss {float(m['loss']):.4f}")
    print(f"loss: {first:.3f} -> {last:.3f} "
          f"({'improved' if last < first else 'NOT improved'})")

    engine = Engine(model, params, max_new_tokens=12, device=model.device)
    batch = synthetic_batch(
        torch.Generator(device=model.device).manual_seed(7), cfg, 32, 2)
    res = engine.generate(batch)
    print("generated tokens:", res.tokens[0].tolist())
    if not last < first:
        raise SystemExit("training did not reduce loss")
    return first, last, res


if __name__ == "__main__":
    main()
