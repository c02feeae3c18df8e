"""End-to-end MoE training on the PyTorch port, with the paper's
padding-free fp8 grouped GEMM (``examples/train_moe.py`` of the JAX
package, on ``src/repro_torch``).

  PYTHONPATH=src python examples/train_moe_torch.py --steps 40 --precision fp8
  PYTHONPATH=src python examples/train_moe_torch.py --device cpu --steps 5

Trains a reduced deepseek-moe (fine-grained experts, the paper's target
workload) in f32 and reports the padding the grouped GEMM avoided each
step.  On a CUDA card the expert GEMMs run the port's kernels; on the
CPU their plain PyTorch versions.
"""
import argparse
import dataclasses

import torch

from repro_torch.configs import smoke_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models.model_zoo import make_model
from repro_torch.optim import adamw
from repro_torch.train.trainer import make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--precision", default="bf16", choices=["bf16", "fp8"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = dataclasses.replace(smoke_config("deepseek-moe-16b"),
                              precision=args.precision, dtype=torch.float32)
    model = make_model(cfg, args.device)
    params = model.init_params(
        torch.Generator(device=model.device).manual_seed(0))

    opt_cfg = adamw.OptConfig(lr=1e-3, total_steps=args.steps,
                              warmup_steps=5, use_master=False)
    opt_state = adamw.init_opt_state(params, opt_cfg)
    step_fn = make_train_step(model.loss, opt_cfg)
    data = SyntheticLM(DataConfig(seed=0, batch_size=args.batch,
                                  seq_len=args.seq), cfg, device=model.device)

    # padding the baseline WOULD have added (per MoE layer, per step):
    e = cfg.moe.num_experts
    tokens = args.batch * args.seq * cfg.moe.top_k
    exp_pad_rows = e * (128 - 1) / 2          # expected pad rows @ block 128
    print(f"precision={args.precision}  experts={e} top_k={cfg.moe.top_k}")
    print(f"grouped GEMM rows/step/layer: {tokens} "
          f"(padding baseline would add ~{exp_pad_rows:.0f} rows "
          f"= {exp_pad_rows / tokens * 100:.1f}% waste)")

    first = last = None
    for step in range(args.steps):
        params, opt_state, m = step_fn(params, opt_state,
                                       data.batch_at(step))
        if step == 0:
            first = float(m["loss"])
        last = float(m["loss"])
        if step % 10 == 0:
            print(f"step {step:3d}  loss {float(m['loss']):.4f}  "
                  f"gnorm {float(m['grad_norm']):.2f}")
    print(f"loss: {first:.3f} -> {last:.3f}")
    if not last < first:
        raise SystemExit("training did not reduce loss")
    return first, last


if __name__ == "__main__":
    main()
