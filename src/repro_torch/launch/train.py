"""Training command line of the port.

  PYTHONPATH=src python -m repro_torch.launch.train --device cuda \
      --arch qwen2-moe-a2.7b --steps 100 --batch 8 --seq 512

``--arch`` takes every architecture of ``repro_torch.configs.ARCHS``
(the data pipeline's batches carry whisper's ``frames`` and a VLM's
``patch_embeds``; an xLSTM ``--seq`` must satisfy ``S % min(256, S) ==
0``); ``--smoke`` takes the reduced config; ``--device cpu`` runs the
plain PyTorch versions of the kernels on the CPU.  The loop lives in
:func:`train`, which a caller can drive with a config of its own (for
example a depth-cut one).

Fault tolerance, as in the JAX package's trainer: with ``--ckpt-dir`` the
run resumes from the directory's latest complete checkpoint (params and
AdamW state) at the step after it, and saves one after every step with
``(step + 1) % save_every == 0``; the data pipeline is stateless
(``batch_at(step)``), so the resumed run consumes exactly the batches it
would have.  ``--fail-at-step`` injects a crash before that step runs.

Distributed, under ``torchrun`` (``WORLD_SIZE > 1``):

  torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --arch deepseek-moe-16b --dist-backend nccl

initialises the process group with ``--dist-backend`` (``nccl`` on CUDA
and ``gloo`` on the CPU unless given; a failure raises, nothing runs
alone), places rank r on ``cuda:{LOCAL_RANK % device_count}``, builds
``local_mesh()`` over every rank as the JAX package does, and trains
with the MoE layers sharded over its model axis and the batch over its
data axis (:func:`train` takes any mesh, e.g. ``make_mesh_for(4,
model_parallel=2)``).  Every rank draws the same params and keeps its
slice; rank 0 logs and writes the checkpoints, which hold the full
logical arrays and restore onto any mesh.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.distributed import context as dctx
from repro_torch.distributed.sharding import tree_specs
from repro_torch.launch.mesh import local_mesh
from repro_torch.models.model_zoo import make_model
from repro_torch.models.transformer import storage_specs
from repro_torch.optim import adamw
from repro_torch.train.trainer import make_train_step


@dataclasses.dataclass
class TrainRun:
    params: dict
    opt_state: dict
    step_fn: object          # (params, opt_state, batch) -> (.., .., metrics)
    data: SyntheticLM
    history: list            # per step run: step, loss, grad_norm, lr, step_ms


class _StepTimer:
    """Time of one step: CUDA events on a card, the host clock on the CPU;
    :meth:`stop` waits for the step to finish."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def start(self):
        if self.cuda:
            self.t0 = torch.cuda.Event(enable_timing=True)
            self.t0.record()
        else:
            self.t0 = time.perf_counter()

    def stop(self) -> float:
        if self.cuda:
            t1 = torch.cuda.Event(enable_timing=True)
            t1.record()
            t1.synchronize()
            return self.t0.elapsed_time(t1)
        return (time.perf_counter() - self.t0) * 1e3


def train(cfg: ModelConfig, *, steps: int, batch: int, seq: int,
          grad_accum: int = 1, lr: float = 3e-4, seed: int = 0,
          log_every: int = 10, device=None,
          warmup_steps: Optional[int] = None,
          wgrad_precision: Optional[str] = None,
          ckpt_dir: Optional[str] = None, save_every: int = 50,
          fail_at_step: int = -1, log=print, mesh=None,
          fsdp: bool = False) -> TrainRun:
    """Train ``cfg`` from random weights (drawn from ``seed``) on the
    synthetic pipeline up to step ``steps``.  Warmup defaults to the JAX
    package's ``max(steps // 20, 5)``; bf16 models keep f32 masters.  The
    optimizer config depends on the arguments alone, so a resumed run's
    schedule is the uninterrupted one's; its history starts at the
    resumed step.  On a ``mesh`` (process groups built) the run is
    sharded (``fsdp``: the big leaves over ``data`` too, the reference's
    FSDP rule, on leaves of ``sharding.FSDP_MIN_SIZE`` elements or
    more): only rank 0 calls ``log`` and writes checkpoints."""
    model = make_model(cfg, device, mesh, fsdp=fsdp)
    gen = torch.Generator(device=model.device).manual_seed(seed)
    params = model.init_params(gen)
    if mesh is not None and mesh.rank != 0:
        log = _silent
    opt_cfg = adamw.OptConfig(
        lr=lr, total_steps=steps,
        warmup_steps=(max(steps // 20, 5) if warmup_steps is None
                      else warmup_steps),
        use_master=cfg.dtype == torch.bfloat16)
    opt_state = adamw.init_opt_state(params, opt_cfg)
    state = {"params": params, "opt": opt_state}
    pspecs = None if mesh is None else storage_specs(
        params, cfg, mesh, fsdp=fsdp)
    specs = None if mesh is None else tree_specs(state, pspecs)
    step_fn = make_train_step(model.loss, opt_cfg, grad_accum=grad_accum,
                              wgrad_precision=wgrad_precision, mesh=mesh,
                              specs=pspecs)
    start_step = 0
    if ckpt_dir:
        restored, _, s = ckpt.restore_latest(ckpt_dir, state, mesh=mesh,
                                             specs=specs)
        if restored is not None:
            start_step = s + 1
            log(f"[resume] restored step {s} from {ckpt_dir}")
    data = SyntheticLM(DataConfig(seed=seed, batch_size=batch, seq_len=seq),
                       cfg, device=model.device)
    timer = _StepTimer(model.device)
    history = []
    t0 = time.perf_counter()
    for step in range(start_step, steps):
        if step == fail_at_step:
            raise SystemExit(f"[injected failure] at step {step}")
        b = data.batch_at(step)
        timer.start()
        params, opt_state, metrics = step_fn(params, opt_state, b)
        rec = {"step": step, "step_ms": timer.stop(),
               **{k: float(metrics[k]) for k in ("loss", "grad_norm", "lr")}}
        history.append(rec)
        if step % log_every == 0 or step == steps - 1:
            tps = len(history) * batch * seq / max(time.perf_counter() - t0,
                                                   1e-9)
            log(f"step {step:5d}  loss {rec['loss']:.4f}  "
                f"gnorm {rec['grad_norm']:.3f}  lr {rec['lr']:.2e}  "
                f"step {rec['step_ms']:.1f} ms  tok/s {tps:,.0f}")
        if ckpt_dir and save_every and (step + 1) % save_every == 0:
            path = ckpt.save(ckpt_dir, step,
                             {"params": params, "opt": opt_state},
                             mesh=mesh, specs=specs)
            log(f"[ckpt] step {step} -> {path}")
    return TrainRun(params, opt_state, step_fn, data, history)


def _silent(*_):
    pass


def init_distributed(backend: Optional[str], device: Optional[str]):
    """Under ``torchrun`` (``WORLD_SIZE > 1`` in the environment):
    initialise the default process group with ``backend`` (default
    :func:`~repro_torch.distributed.context.default_backend` of the
    device) unless the caller has, place this rank on
    ``cuda:{LOCAL_RANK % device_count}``,
    and return ``(local_mesh(), device)``; one process: ``(None,
    device)``.  A group that fails to initialise raises."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1:
        return None, device
    dev = torch.device(device or "cuda")
    if dev.type == "cuda":
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("no CUDA device is available")
        local = int(os.environ.get("LOCAL_RANK", "0"))
        dev = torch.device("cuda", local % n)
        torch.cuda.set_device(dev)
        if world > n and local == 0:
            print(f"[dist] {world} ranks share {n} card(s): local rank r "
                  f"runs on cuda:(r % {n})", flush=True)
    if not dist.is_initialized():
        dist.init_process_group(backend or dctx.default_backend(dev))
    return local_mesh(), str(dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-moe-a2.7b", choices=ARCHS)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--precision", default=None, choices=[None, "bf16", "fp8"])
    ap.add_argument("--dtype", default=None, choices=[None, "f32", "bf16"])
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--fail-at-step", type=int, default=-1,
                    help="inject a crash (restart testing)")
    ap.add_argument("--dist-backend", default=None,
                    choices=[None, "nccl", "gloo"],
                    help="process-group backend under torchrun (default: "
                         "nccl on CUDA, gloo on the CPU)")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    repl = {}
    if args.precision:
        repl["precision"] = args.precision
    if args.dtype:
        repl["dtype"] = torch.float32 if args.dtype == "f32" \
            else torch.bfloat16
    if repl:
        cfg = dataclasses.replace(cfg, **repl)
    mesh, device = init_distributed(args.dist_backend, args.device)
    run = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                grad_accum=args.grad_accum, lr=args.lr, seed=args.seed,
                log_every=args.log_every, device=device,
                ckpt_dir=args.ckpt_dir, save_every=args.save_every,
                fail_at_step=args.fail_at_step, mesh=mesh)
    if mesh is None or mesh.rank == 0:
        print("done.")
    return run


if __name__ == "__main__":
    main()
