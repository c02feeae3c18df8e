#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py --quick    # probe, build and kernel checks only

Phases, each printing one JSON line:
  1. probe   card name and power limit, torch/CUDA versions, nvcc;
  2. build   every CUDA kernel from ``src/repro_torch/kernels/csrc``;
  3. kernel  each kernel against its plain PyTorch version on the card at
             the serving path's shapes: max error, mismatches, times and
             the bound of the work;
  4. forward the full-width qwen2-moe-a2.7b cut to 2 layers: prefill
             logits through the kernels against the plain versions;
  5. serve   the full 24-layer qwen2-moe-a2.7b in fp8 with random weights:
             batch 4, prompt 64, 16 new tokens, greedy; the launch counts
             of the run are asserted.
Then the ``{"kernels": [...]}`` line, the card's ``nvidia-smi`` name and
power limit, and last ``{"ok": true, "device": {...}}``.  Any failure
raises and the script exits non-zero.  Without a CUDA device, or without
the package beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 peak bandwidth
FP8_FLOP_PER_S = 1979e12        # dense fp8 tensor-core peak
L2_BYTES = 50 * 2 ** 20         # H100 L2 cache
REPLACES = {
    "quantize_tilewise": "src/repro/kernels/quant_kernel.py:44",
    "act_quantize": "src/repro/kernels/epilogue_kernel.py:80",
    "gmm": "src/repro/kernels/grouped_gemm_kernel.py:150",
}
SOURCES = {
    "quantize_tilewise": "src/repro_torch/kernels/csrc/quant.cu",
    "act_quantize": "src/repro_torch/kernels/csrc/act_quant.cu",
    "gmm": "src/repro_torch/kernels/csrc/grouped_gemm.cu",
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, *, iters=20, warmup=3) -> float:
    """Mean time of ``fn(i)`` for i in 0..iters-1, back-to-back eager
    calls timed by CUDA events: the device time, or the host's launch time
    per call where that is longer."""
    import torch
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, *, iters=20, replays=5) -> float:
    """Device time of ``fn(i)``: calls i = 0..iters-1 captured in one CUDA
    graph, replayed and timed by CUDA events, so host overhead drops out."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def rotation(make, nbytes) -> list:
    """Distinct copies of a kernel's inputs (``make()``, ``nbytes`` each),
    enough that cycling through them moves three L2s of data between two
    uses of one copy: each call then reads its inputs from HBM, as the
    byte bound assumes."""
    return [make() for _ in range(max(2, -(-3 * L2_BYTES // nbytes)))]


def kernels():
    from repro_torch.kernels import epilogue_kernel, grouped_gemm_kernel, \
        quant_kernel
    return {"quantize_tilewise": quant_kernel.quantize_tilewise_cuda,
            "act_quantize": epilogue_kernel.act_quantize_cuda,
            "gmm": grouped_gemm_kernel.gmm_cuda}


def reset_counts() -> None:
    for fn in kernels().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in kernels().items()}


@contextlib.contextmanager
def plain_kernels():
    """Route the serving path through the plain PyTorch versions (on the
    same card) by swapping the kernel modules' public functions."""
    from repro_torch.kernels import epilogue_kernel as ek
    from repro_torch.kernels import grouped_gemm_kernel as gk
    from repro_torch.kernels import quant_kernel as qk
    saved = (qk.quantize_tilewise, ek.act_quantize, gk.gmm)
    qk.quantize_tilewise = qk.quantize_tilewise_plain

    def act_plain(g, u=None, *, s_g=None, s_u=None, act="silu_mul"):
        return ek.act_quantize_plain(g, u, act=act)
    ek.act_quantize = act_plain
    gk.gmm = gk.gmm_plain
    try:
        yield
    finally:
        qk.quantize_tilewise, ek.act_quantize, gk.gmm = saved


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------

def e4m3_step(q):
    """Spacing of e4m3 values at |q| (2^-9 in the subnormal range)."""
    import torch
    a = q.float().abs()
    e = torch.floor(torch.log2(torch.clamp(a, min=2.0 ** -6)))
    return torch.exp2(e - 3)


def check_quantize(gen, rows):
    import torch
    from repro_torch.kernels import quant_kernel as qk
    out = []
    for m, k in rows:
        x = torch.randn((m, k), generator=gen, device="cuda") * 3.0
        x[0, :128] = 0.0                       # an all-zero tile: scale 1
        q, s = qk.quantize_tilewise_cuda(x)
        qp, sp = qk.quantize_tilewise_plain(x)
        torch.cuda.synchronize()
        mism = int((q.view(torch.uint8) != qp.view(torch.uint8)).sum()) \
            + int((s != sp).sum())
        err = (q.float() * torch.repeat_interleave(s, 128, dim=1)
               - qp.float() * torch.repeat_interleave(sp, 128, dim=1)).abs()
        if mism:
            raise AssertionError(f"quantize [{m},{k}]: {mism} payload/scale "
                                 "values differ from the plain version")
        out.append({"shape": [m, k], "mismatches": 0,
                    "max_abs_err": float(err.max())})
    return out


def check_act_quantize(gen, rows):
    import torch
    from repro_torch.kernels import epilogue_kernel as ek
    out = []
    for m, k, act in rows:
        g = (torch.randn((m, k), generator=gen, device="cuda") * 2).bfloat16()
        u = None if act == "gelu" else \
            (torch.randn((m, k), generator=gen, device="cuda") * 2).bfloat16()
        q, s = ek.act_quantize_cuda(g, u, act=act)
        qp, sp = ek.act_quantize_plain(g, u, act=act)
        torch.cuda.synchronize()
        dq = q.float() * torch.repeat_interleave(s, 128, dim=1)
        dp = qp.float() * torch.repeat_interleave(sp, 128, dim=1)
        step = torch.maximum(e4m3_step(q) * torch.repeat_interleave(s, 128, 1),
                             e4m3_step(qp) * torch.repeat_interleave(sp, 128, 1))
        err = (dq - dp).abs()
        worst = float((err / step).max())
        differ = float((q.view(torch.uint8) != qp.view(torch.uint8))
                       .float().mean())
        # one e4m3 step, with room for the two scales differing by an ulp
        if worst > 1.0 + 1e-5:
            raise AssertionError(f"act_quantize {act} [{m},{k}]: a dequantized "
                                 f"value differs by {worst:.3f} e4m3 steps")
        out.append({"shape": [m, k], "act": act, "max_abs_err": float(err.max()),
                    "max_err_in_e4m3_steps": worst,
                    "payload_bytes_differing": differ})
    return out


def ragged_sizes(gen, m, g, total, empty):
    """``g`` group sizes summing to ``total`` <= m, ``empty`` of them 0."""
    import torch
    live = torch.randperm(g, generator=gen)[:g - empty]
    w = torch.rand((g - empty,), generator=gen) + 0.2
    sizes = torch.zeros(g, dtype=torch.int64)
    share = torch.floor(w / w.sum() * total).long()
    share[0] += total - int(share.sum())
    sizes[live] = share
    return sizes.to(torch.int32)


def gemm_case(gen, m, k, n, sizes, block_m, out_dtype):
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.plan import make_tile_plan
    g = sizes.numel()
    a8, sa = ref.quantize_tilewise_ref(
        torch.randn((m, k), generator=gen, device="cuda"))
    b8, sb = ref.quantize_blockwise_ref(
        torch.randn((g, k, n), generator=gen, device="cuda") * k ** -0.5)
    gs = sizes.cuda()
    plan = make_tile_plan(gs, m, block_m=block_m, num_groups=g)
    args = (a8, sa, b8, sb, gs)
    kw = dict(num_groups=g, block_m=block_m, out_dtype=out_dtype, plan=plan)
    return args, kw, plan


def compare_gemm(name, args, kw, plan, *, nan_out=False):
    import torch
    from repro_torch.kernels import grouped_gemm_kernel as gk
    m, n = args[0].shape[0], args[2].shape[2]
    out = None
    if nan_out:
        out = torch.full((m, n), float("nan"), dtype=kw["out_dtype"],
                         device="cuda")
    y = gk.gmm_cuda(*args, out=out, **kw).float()
    yp = gk.gmm_plain(*args, **kw).float()
    torch.cuda.synchronize()
    total = int(plan.total_rows())
    if torch.isnan(y).any():
        raise AssertionError(f"gmm {name}: NaN rows left in the output")
    if (y[total:] != 0).any():
        raise AssertionError(f"gmm {name}: rows >= total={total} are not zero")
    err = (y - yp).abs()
    # the two sum each 128-K block in another order (tensor cores against
    # an f32 matmul, ~1e-6 relative), which can flip the final bf16
    # rounding: one bf16 step (2^-7 relative) plus an absolute floor for
    # cancellation near zero
    scale = float(yp.abs().max()) if yp.numel() else 0.0
    tol = yp.abs() * 2.0 ** -7 + 1e-4 * scale + 1e-30
    bad = int((err > tol).sum())
    if bad:
        raise AssertionError(f"gmm {name}: {bad} elements beyond tolerance "
                             f"(max err {float(err.max())})")
    mism = int((err > 0).sum())
    return {"case": name, "shape": [m, args[0].shape[1], n],
            "groups": args[2].shape[0], "total_rows": total,
            "block_m": kw["block_m"], "max_abs_err": float(err.max()) if
            err.numel() else 0.0, "rel_to_max": float(err.max()) / scale
            if scale else 0.0, "mismatches": mism}


def phase_kernels(full: bool):
    import torch
    from repro_torch.kernels import epilogue_kernel as ek
    from repro_torch.kernels import grouped_gemm_kernel as gk
    from repro_torch.kernels import quant_kernel as qk
    gen = torch.Generator(device="cuda").manual_seed(1)
    cpu_gen = torch.Generator().manual_seed(2)
    results = {}

    # quantize: routed xs at prefill/decode, the shared experts' x
    results["quantize_tilewise"] = check_quantize(
        gen, [(1024, 2048), (256, 2048), (16, 2048), (4, 2048)])
    results["act_quantize"] = check_act_quantize(
        gen, [(1024, 1408, "silu_mul"), (256, 5632, "silu_mul"),
              (16, 1408, "silu_mul"), (4, 5632, "silu_mul"),
              (1024, 1408, "gelu")])

    gemm = []
    pre = ragged_sizes(cpu_gen, 1024, 60, 1000, empty=8)
    dec = ragged_sizes(cpu_gen, 16, 60, 16, empty=48)
    cases = {
        "prefill_gate": (1024, 2048, 1408, pre, 128, torch.bfloat16),
        "prefill_down": (1024, 1408, 2048, pre, 128, torch.bfloat16),
        "decode_gate": (16, 2048, 1408, dec, 16, torch.bfloat16),
        "decode_down": (16, 1408, 2048, dec, 16, torch.bfloat16),
        "shared_gate": (256, 2048, 5632, torch.tensor([256], dtype=torch.int32),
                        128, torch.bfloat16),
        "shared_down_f32": (256, 5632, 2048,
                            torch.tensor([256], dtype=torch.int32), 128,
                            torch.float32),
        # decode's shared experts: 4 rows, fewer than the 16-row tile
        "shared_decode_gate": (4, 2048, 5632,
                               torch.tensor([4], dtype=torch.int32), 16,
                               torch.bfloat16),
        "shared_decode_down_f32": (4, 5632, 2048,
                                   torch.tensor([4], dtype=torch.int32), 16,
                                   torch.float32),
        "all_empty": (256, 256, 256, torch.zeros(4, dtype=torch.int32), 128,
                      torch.bfloat16),
    }
    setups = {}
    for name, (m, k, n, sizes, bm, dt) in cases.items():
        args, kw, plan = gemm_case(gen, m, k, n, sizes, bm, dt)
        setups[name] = (args, kw, plan)
        gemm.append(compare_gemm(name, args, kw, plan))
    args, kw, plan = setups["prefill_gate"]
    gemm.append(compare_gemm("prefill_gate_nan_out", args, kw, plan,
                             nan_out=True))
    # the kernel is built for block_m 16 and 128 only; other tiles raise
    for bm in (24, 64):
        try:
            gk.gmm_cuda(*args, **{**kw, "block_m": bm, "plan": None})
            raise AssertionError(f"gmm accepted block_m={bm}")
        except ValueError:
            pass
    results["gmm"] = gemm
    for name, rows in results.items():
        emit({"phase": "kernel", "kernel": name, "checks": rows})

    # the largest error over every case checked above
    worst = {name: max(r["max_abs_err"] for r in rows)
             for name, rows in results.items()}
    timing = {}
    if not full:
        return timing
    # times at the routed prefill shapes (the main path's largest calls);
    # the quantizers cycle through copies of their inputs that overflow
    # the L2, so their times hold against the HBM byte bound
    m, k = 1024, 2048
    nbytes = 4 * m * k + m * k + 4 * m * k // 128
    xs = rotation(lambda: torch.randn((m, k), generator=gen, device="cuda"),
                  nbytes)
    n_x = len(xs)
    timing["quantize_tilewise"] = dict(
        shape=[m, k], input_copies=n_x,
        ms=graph_ms(lambda i: qk.quantize_tilewise_cuda(xs[i % n_x]),
                    iters=2 * n_x),
        eager_ms=cuda_ms(lambda i: qk.quantize_tilewise_cuda(xs[i % n_x]),
                         iters=2 * n_x),
        plain_ms=graph_ms(lambda i: qk.quantize_tilewise_plain(xs[i % n_x]),
                          iters=2 * n_x),
        bytes=nbytes, flops=0, max_abs_err=worst["quantize_tilewise"])
    del xs
    m, k = 1024, 1408
    nbytes = 2 * 2 * m * k + m * k + 4 * m * k // 128
    gus = rotation(lambda: tuple(
        torch.randn((m, k), generator=gen, device="cuda").bfloat16()
        for _ in range(2)), nbytes)
    n_gu = len(gus)
    timing["act_quantize"] = dict(
        shape=[m, k], input_copies=n_gu,
        ms=graph_ms(lambda i: ek.act_quantize_cuda(*gus[i % n_gu]),
                    iters=2 * n_gu),
        eager_ms=cuda_ms(lambda i: ek.act_quantize_cuda(*gus[i % n_gu]),
                         iters=2 * n_gu),
        plain_ms=graph_ms(lambda i: ek.act_quantize_plain(*gus[i % n_gu]),
                          iters=2 * n_gu),
        bytes=nbytes, flops=0, max_abs_err=worst["act_quantize"])
    del gus
    # the GEMM's visited weights (52 experts, 150 MB) overflow the L2 alone
    args, kw, plan = setups["prefill_gate"]
    a8, _, b8, _, gs = args
    m, k = a8.shape
    n = b8.shape[2]
    rows = int(plan.total_rows())
    visited = int((gs > 0).sum())
    timing["gmm"] = dict(
        shape=[m, k, n], groups=b8.shape[0],
        ms=graph_ms(lambda i: gk.gmm_cuda(*args, **kw)),
        eager_ms=cuda_ms(lambda i: gk.gmm_cuda(*args, **kw)),
        # reads the group offsets back to the host, so no graph: eager
        plain_ms=cuda_ms(lambda i: gk.gmm_plain(*args, **kw), iters=3),
        bytes=m * k + visited * k * n + 2 * m * n, flops=2 * rows * k * n,
        max_abs_err=worst["gmm"])
    for name, t in timing.items():
        t_bytes = t["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = t["flops"] / FP8_FLOP_PER_S * 1e3
        t["bound_ms"] = max(t_bytes, t_ops)
        t["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        emit({"phase": "kernel_time", "kernel": name, **t})
    return timing


# ---------------------------------------------------------------------------
# phases 4 and 5: the model
# ---------------------------------------------------------------------------

def phase_forward():
    """Full widths, 2 layers: prefill logits through the kernels against
    the same forward through the plain versions, on the card."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import make_model, synthetic_batch
    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b"), num_layers=2)
    model = make_model(cfg, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    params = model.init_params(gen)
    batch = synthetic_batch(gen, cfg, 64, 4)
    with torch.inference_mode():
        reset_counts()
        logits_k, _ = model.prefill(params, batch, cache_capacity=80)
        torch.cuda.synchronize()
        counts = read_counts()
        with plain_kernels():
            logits_p, _ = model.prefill(params, batch, cache_capacity=80)
        torch.cuda.synchronize()
        if read_counts() != counts:
            raise AssertionError("the plain forward launched a kernel")
    lk, lp = logits_k.float(), logits_p.float()
    if not torch.isfinite(lk).all():
        raise AssertionError("non-finite logits through the kernels")
    rel = float((lk - lp).abs().max() / lp.abs().max())
    # the quantizer is bitwise, act_quant within one e4m3 step and the GEMM
    # within one bf16 step; through 2 layers and the bf16 residual stream
    # that stays a few bf16 steps of the largest logit
    bound = 2e-2
    emit({"phase": "forward", "layers": 2, "batch": 4, "prompt": 64,
          "logits_shape": list(lk.shape), "rel_to_max_err": rel,
          "bound": bound, "launches": counts})
    if rel > bound:
        raise AssertionError(f"kernel vs plain logits rel-to-max {rel} > {bound}")
    del params, model


def profile_breakdown(fn, top=8):
    """One call of ``fn`` under torch.profiler: wall ms, summed device
    kernel ms, the device's busy share and the kernels by device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        # kernel rows only: an operator's row repeats its kernels' time
        if e.device_type != DeviceType.CUDA:
            continue
        rows.append((e.self_device_time_total / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows)
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "busy_share": device_ms / wall_ms if wall_ms else None,
            "top": [{"name": k[:80], "ms": ms, "calls": c}
                    for ms, c, k in rows[:top]]}


def phase_serve():
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import quantization as q
    from repro_torch.kernels.plan import KernelConfig
    from repro_torch.models.model_zoo import make_model, synthetic_batch
    from repro_torch.serve.engine import Engine
    cfg = get_config("qwen2-moe-a2.7b")
    batch_size, prompt, new = 4, 64, 16
    model = make_model(cfg, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = model.init_params(gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = synthetic_batch(gen, cfg, prompt, batch_size)
    engine = Engine(model, params, max_new_tokens=new,
                    kernel_config=KernelConfig(),
                    decode_kernel_config=KernelConfig(block_m=16))
    engine.generate(batch)                   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res = engine.generate(batch)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    with torch.inference_mode():
        t0 = time.perf_counter()
        last, _ = engine.prefill(batch, prompt + new)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        # the per-call blockwise weight quantization of one forward
        lp = params["layers"][0]["moe"]

        def quant_weights():
            for key in ("w_gate", "w_up", "w_down", "shared_gate",
                        "shared_up", "shared_down"):
                w = lp[key]
                q.quantize_blockwise_batched(w if w.dim() == 3 else w[None])
        wq_layer_ms = cuda_ms(lambda i: quant_weights(), iters=5, warmup=1)
        _, cache = engine.prefill(batch, prompt + new)
        tok = res.tokens[:, 0]
        prof = {"prefill": profile_breakdown(
                    lambda: engine.prefill(batch, prompt + new)),
                "decode_step": profile_breakdown(
                    lambda: engine.decode_step(tok, cache))}
    forwards = new
    expect = {"quantize_tilewise": forwards * cfg.num_layers * 2,
              "gmm": forwards * cfg.num_layers * 6,
              "act_quantize": forwards * cfg.num_layers * 2}
    toks = res.tokens
    ok_tokens = (tuple(toks.shape) == (batch_size, new)
                 and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size)
    emit({"phase": "serve", "arch": cfg.name, "layers": cfg.num_layers,
          "params": cfg.param_count(), "precision": cfg.precision,
          "batch": batch_size, "prompt": prompt, "max_new_tokens": new,
          "init_s": init_s, "generate_ms": gen_s * 1e3,
          "prefill_ms": prefill_s * 1e3,
          "decode_ms_per_step": (gen_s - prefill_s) * 1e3 / (new - 1),
          "tok_per_s": batch_size * new / gen_s,
          "weight_quant_ms_per_forward": wq_layer_ms * cfg.num_layers,
          "max_memory_allocated_gb": peak / 1e9,
          "launches": counts, "expected_launches": expect,
          "tokens_ok": ok_tokens, "sample": toks[0].tolist()})
    for name, br in prof.items():
        emit({"phase": "profile", "of": name, **br})
    if counts != expect:
        raise AssertionError(f"launch counts {counts} != expected {expect}")
    if not ok_tokens or not torch.isfinite(last.float()).all():
        raise AssertionError("serve produced malformed tokens or logits")
    return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="probe, build and kernel checks only")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import device
    from repro_torch.kernels import build

    info = device.probe()
    emit({"phase": "probe", **info})
    t0 = time.perf_counter()
    build.build_all()
    notes = build.LAST_BUILD.get("ptxas", {})
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "dir": os.path.relpath(str(build.build_all()), HERE),
          "ptxas": {src: [ln.strip() for ln in out.splitlines()
                          if "registers" in ln or "spill" in ln]
                    for src, out in notes.items()}})
    timing = phase_kernels(full=not args.quick)
    counts = {}
    if not args.quick:
        phase_forward()
        torch.cuda.empty_cache()
        counts = phase_serve()
        emit({"kernels": [
            {"name": name, "route": "cuda", "source": SOURCES[name],
             "replaces": REPLACES[name], "launches": counts[name],
             "max_abs_err": timing[name]["max_abs_err"],
             "ms": timing[name]["ms"], "plain_ms": timing[name]["plain_ms"],
             "bound_ms": timing[name]["bound_ms"],
             "bound_by": timing[name]["bound_by"], "library_ms": None}
            for name in SOURCES]})
    print(info["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
