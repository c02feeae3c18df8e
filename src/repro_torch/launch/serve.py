"""Batched serving command line of the port.

  PYTHONPATH=src python -m repro_torch.launch.serve --device cuda \
      --arch qwen2-moe-a2.7b --batch 4 --prompt-len 64 --max-new 16

``--arch`` takes every architecture of ``repro_torch.configs.ARCHS``;
``--smoke`` takes the reduced config; ``--device cpu`` runs the plain
PyTorch versions of the kernels on the CPU.  The batch carries the stub
frontends' inputs (whisper's ``frames``, a VLM's ``patch_embeds``).  An
xLSTM prompt must satisfy ``S % min(256, S) == 0`` (its mLSTM chunks).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.models.model_zoo import make_model, synthetic_batch
from repro_torch.serve.engine import Engine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-moe-a2.7b", choices=ARCHS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = make_model(cfg, args.device)
    gen = torch.Generator(device=model.device).manual_seed(args.seed)
    params = model.init_params(gen)
    engine = Engine(model, params, max_new_tokens=args.max_new,
                    temperature=args.temperature, device=model.device)
    batch = synthetic_batch(gen, cfg, args.prompt_len, args.batch)

    def run():
        res = engine.generate(batch, generator=gen)
        if model.device.type == "cuda":
            torch.cuda.synchronize(model.device)
        return res

    run()    # warm-up: builds the kernels on first use
    t0 = time.perf_counter()
    res = run()
    dt = time.perf_counter() - t0
    total_new = int(res.num_generated.sum())
    print(f"arch={cfg.name} device={model.device} batch={args.batch} "
          f"prompt={args.prompt_len} new={args.max_new}")
    print(f"generated {total_new} tokens in {dt * 1e3:.1f} ms "
          f"({total_new / dt:.1f} tok/s)")
    print("sample:", res.tokens[0][:16].tolist())
    return res


if __name__ == "__main__":
    main()
