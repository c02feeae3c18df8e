"""The cell's set-up and measured window, by the kind of its traffic.

Each driver builds the port's model over the benchmark's weights, warms
up the cell's shapes (set-up), runs a closed loop for ``seconds`` (the
window closes at the end of the step in flight, or of the round of
batches in flight: one batch, or one length of every stratum) and returns
what the metrics and the check of outputs read: the window's length and
work, the spans, the outputs to compare.  Nothing is compiled inside the
window: the kernels are built on their first call, in set-up.
"""
from __future__ import annotations

import dataclasses
import random
import time

import torch

from harness import trace as tr
from harness.model import change_norms, leaf_paths, make_params
from harness.traffic import (Tokens, length_schedule, prompt_lengths,
                             round_length)


@dataclasses.dataclass
class Ctx:
    device: torch.device
    seed: int
    seconds: float
    trace: bool
    shape: object            # harness.model.Shape
    port_cfg: object         # the port's ModelConfig
    traffic: dict
    t_start: float           # perf_counter at process start


@dataclasses.dataclass
class Window:
    setup_s: float
    window_s: float
    attempted: int
    failed: int
    work: dict               # what the window did (steps, batches)
    spans: tr.Spans
    t_window_ns: int
    prof: object             # the profile, or None
    outputs: dict            # what the check of outputs compares
    peak_bytes: int


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def _start(ctx: Ctx) -> int:
    if ctx.device.type == "cuda":
        return tr.marker(ctx.device)
    return time.perf_counter_ns()


def _peak(device) -> int:
    return torch.cuda.max_memory_allocated() if device.type == "cuda" else 0


def run_train(ctx: Ctx) -> Window:
    from repro_torch.models.model_zoo import make_model
    from repro_torch.optim import adamw
    from repro_torch.train.trainer import make_train_step
    s, t = ctx.shape, ctx.traffic
    model = make_model(ctx.port_cfg, ctx.device)
    params = make_params(s, ctx.seed, ctx.device)
    opt = adamw.OptConfig(**t["opt"], use_master=True)
    state = adamw.init_opt_state(params, opt)
    step = make_train_step(model.loss, opt, grad_accum=t["grad_accum"])
    tokens = Tokens(s.vocab, ctx.seed, ctx.device)

    def batch():
        x = tokens.draw(t["batch"], t["seq"])
        return {"tokens": x, "labels": x}

    # set-up: the check's first steps through the window's own call
    losses, grad_norms = [], None
    for i in range(t["check_steps"]):
        params, state, met = step(params, state, batch())
        losses.append(met["loss"].float())
        if i == 0:
            grad_norms = [torch.linalg.vector_norm(m.float()) / (1 - opt.b1)
                          for _, m in leaf_paths(state["m"])]
    outputs = {"paths": [p for p, _ in leaf_paths(state["m"])],
               "loss": [float(x) for x in losses],
               "grad_norm": [float(x) for x in grad_norms],
               "change_norm": change_norms(state["master"], s, ctx.seed,
                                           ctx.device)}
    sync(ctx.device)
    setup_s = time.perf_counter() - ctx.t_start

    spans = tr.Spans()
    steps = 0
    with tr.traced(ctx.trace) as prof:
        t0 = _start(ctx)
        while True:
            b = batch()
            if ctx.trace:
                with spans.host("train.grad_fn"), spans.cuda("grad_fn"):
                    (_, _), grads = step.grad_fn(params, b)
                with spans.host("train.update"), spans.cuda("update"):
                    params, state, _ = step.update(params, grads, state)
                del grads
            else:
                with spans.host("train.step"):
                    params, state, _ = step(params, state, b)
            with spans.host("train.sync"):
                sync(ctx.device)
            steps += 1
            if time.perf_counter_ns() - t0 >= ctx.seconds * 1e9:
                break
        window_s = (time.perf_counter_ns() - t0) / 1e9
    peak = _peak(ctx.device)
    return Window(setup_s, window_s, steps, 0,
                  {"kind": "train", "steps": steps, "batch": t["batch"],
                   "seq": t["seq"], "grad_accum": t["grad_accum"],
                   "remat": ctx.port_cfg.remat,
                   "tokens": steps * t["batch"] * t["seq"]},
                  spans, t0, prof, outputs, peak)


def run_generate(ctx: Ctx) -> Window:
    from repro_torch.models.model_zoo import make_model
    from repro_torch.serve.engine import Engine
    s, t = ctx.shape, ctx.traffic
    model = make_model(ctx.port_cfg, ctx.device)
    params = make_params(s, ctx.seed, ctx.device)
    b, new = t["batch"], t["max_new_tokens"]
    engine = Engine(model, params, max_new_tokens=new, eos_id=t["eos_id"],
                    decode_batch_size=b, device=ctx.device)
    warm = Tokens(s.vocab, ctx.seed + 1, ctx.device)
    for length in sorted(set(prompt_lengths(t["prompt"])), reverse=True):
        engine.generate({"tokens": warm.draw(b, length)})
    sync(ctx.device)
    setup_s = time.perf_counter() - ctx.t_start

    tokens = Tokens(s.vocab, ctx.seed, ctx.device)
    lengths = length_schedule(t["prompt"], ctx.seed)
    per_round = round_length(t["prompt"])
    spans = tr.Spans()
    batches = []
    with tr.traced(ctx.trace) as prof:
        t0 = _start(ctx)
        while True:
            length = next(lengths)
            prompts = tokens.draw(b, length)
            t_sub = time.perf_counter_ns()
            with spans.host("serve.generate"):
                res = engine.generate({"tokens": prompts})
            with spans.host("serve.sync"):
                sync(ctx.device)
            t_done = time.perf_counter_ns()
            batches.append({"length": length, "prompts": prompts,
                            "tokens": res.tokens,
                            "ttft_ms": (t_done - t_sub) / 1e6})
            if t_done - t0 >= ctx.seconds * 1e9 and \
                    len(batches) % per_round == 0:
                break
        window_s = (time.perf_counter_ns() - t0) / 1e9
    peak = _peak(ctx.device)
    work = {"kind": "generate", "batch": b, "max_new_tokens": new,
            "lengths": [x["length"] for x in batches],
            "generated": sum(x["tokens"].numel() for x in batches),
            "ttft_ms": [x["ttft_ms"] for x in batches for _ in range(b)]}
    rng = random.Random(ctx.seed * 31 + 7)
    top = max(x["length"] for x in batches)
    longest = rng.choice([i for i, x in enumerate(batches)
                          if x["length"] == top])
    pick = [longest] + rng.sample(
        [i for i in range(len(batches)) if i != longest],
        min(t["check_batches"], len(batches)) - 1)
    outputs = {"batches": [(batches[i]["prompts"], batches[i]["tokens"])
                           for i in sorted(pick)],
               "all_tokens": [x["tokens"] for x in batches],
               "vocab": s.vocab, "max_new_tokens": new}
    return Window(setup_s, window_s, len(batches) * b, 0, work, spans, t0,
                  prof, outputs, peak)


DRIVERS = {"train": run_train, "generate": run_generate}
