#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py --quick    # probe, build, kernel, autotune,
                                     # analysis checks

Eight configurations at full width are driven, built with
``dataclasses.replace`` on the registry's configs.  Of qwen2-moe-a2.7b:
``fp8`` (the fused activation epilogue), ``fp8_fused``
(``KernelConfig(fuse_producer=True)``: the gate/up GEMMs store fp8
directly), ``bf16`` (``precision="bf16"``, the bf16 grouped GEMM),
``fp8_flash`` (fp8 with ``attn_backend="flash"``) and ``fp8_dense``
(fp8 with ``moe_dispatch="dense"``: GShard's capacity buckets as plain
batched products, the shared experts on the fp8 kernels); ``qwen3_flash``, the
dense GQA qwen3-1.7b (bf16) with ``attn_backend="flash"``; and of
deepseek-moe-16b (64 routed experts top-6, 2 shared, a dense first
layer), ``ds_fp8`` and ``ds_fp8_padded`` (``gemm_backend=
"padded_baseline"``: the paper's baseline, every fp8 GEMM padded per
group to its tile, run on the same GEMM kernel, unpadded).  The rest of
the zoo, forward and serve only (``ZOO``): ``rg_fp8`` (recurrentgemma-2b,
fp8: RG-LRU blocks and a sliding-window MQA layer), ``xlstm_bf16``
(xlstm-350m: no MLP, so no kernel), ``whisper_fp8_flash`` (whisper-tiny:
encoder-decoder, the fused quantizer's gelu mode, flash at head dim 64),
``pixtral_fp8_flash`` (pixtral-12b: 256 patch embeddings prepended),
``yi_fp8_flash`` (yi-9b: GQA 32/4), ``minitron_fp8`` and
``qwen110_fp8`` (qwen1.5-110b: the G = 1 GEMMs at K / N 8192 / 49152).
Flash attention runs where S % 128 == 0, in prefill and training, never
in decode, never in a windowed layer.  Phases, each printing JSON lines:
  1. probe   card name and power limit, torch/CUDA versions, nvcc;
  2. build   every CUDA kernel from ``src/repro_torch/kernels/csrc``;
  3. kernel  each kernel against its plain PyTorch version on the card at
             the serving and training paths' shapes (both wgrads at
             both output dtypes; the grouped GEMMs also at every owned
             span of a tile, into NaN-prefilled outputs): max error,
             mismatches, times and the bound of the work (the grouped
             GEMMs timed at prefill, decode, training and dgrad shapes);
             the one PyTorch call computing a kernel's function, where
             there is one, checked against the plain version and timed;
             the fused activation quantizer also at the decode step's
             and the training path's shapes, beside the graph-replayed
             time of a one-element kernel (the launch floor);
             the quantizing GEMM bitwise against the quantizer applied to
             the GEMM; flash attention also built without its lo product,
             for timing only;
             the padded baseline against the padding-free GEMM at
             deepseek-moe-16b's routed shapes (prefill at batch 4 x
             prompt 512 and 64, decode) and the paper's (M 8192 and
             32768, K = N = 4096, G 8 and 32): every owned row bitwise
             equal; the pad pass, the padded GEMM, the unpad pass, their
             sum, the whole pipeline and the padding-free GEMM timed, the
             GEMM also over exactly the padded groups' rows; the peak
             memory of each pipeline beside the padding's own bytes
             ("padded" lines; the gate runs with --quick too);
  4. autotune  the tuning layer (``kernels/plan.py``, ``resources.py``):
             every built kernel variant's shared memory in the static
             resource model against the kernel library's own
             ``kernel_resources`` query, its threads, and its registers
             fitting one SM at its CTAs an SM; B2, B5 and B7 at block_m
             16 against 128 (the qwen2-moe routed prefill and decode,
             minitron-8b's dense decode) within their gates, and whether
             bitwise equal; a measured autotune under ``build/`` of the
             grouped GEMMs at the qwen2-moe and deepseek-moe-16b routed
             shapes and of the wgrads at the training shapes, every
             candidate's measured ms beside the cost model's, nothing
             skipped, then a cache hit that measures nothing; the aten
             ops and eager ms of one padded GEMM with the plan cache
             against a fresh plan;
  5. analysis  the kernel contract checker (``repro_torch.analysis``):
             its command line's every layer in process on the card, a
             line a layer with its findings; each contract alone on the
             card (event counts, the kernels it launched: B1, B2, B3, B4,
             B6 and B7 must) and on the CPU, the counts equal; the padded
             baseline reporting REPRO-C03 on the card; no live finding
             (runs with --quick too);
  6. forward each configuration cut to 2 layers (deepseek-moe-16b: its
             dense layer and one MoE layer): prefill logits through the
             kernels against the plain versions (prompt 64, and 128 for
             the flash configurations); ``ds_fp8_padded``'s logits
             bitwise ``ds_fp8``'s; ``fp8_dense`` only here; then each
             zoo recipe at batch 4, cut as ``ZOO_FORWARD`` says (one
             cycle of recurrentgemma-2b at prompt 2304, past its 2048
             window; one cycle of xlstm-350m at 512; whisper-tiny whole
             over 1500 frames at 128; the others 2 layers), logits at
             the same bounds, launch counts exact, whisper's fused
             quantizer in gelu mode;
  7. serve   batch 4, 16 new tokens, greedy, random weights: the 24-layer
             qwen2-moe-a2.7b on one param tree, at prompt 64 in ``fp8``,
             ``fp8_fused`` and ``bf16``, at prompt 512 in ``fp8`` and
             ``fp8_flash`` (attention the only difference); then the
             28-layer qwen3-1.7b at prompt 512 in ``qwen3_flash``; then
             the 28-layer deepseek-moe-16b on one param tree at prompt 64
             and 512, each in ``ds_fp8`` and ``ds_fp8_padded`` (tokens
             equal between the two; one padded generate under
             ``torch.cuda.set_sync_debug_mode("error")``); then each zoo
             recipe as ``ZOO_SERVE`` says (yi-9b p512, minitron-8b p64,
             qwen1.5-110b p64 cut to 4 layers, pixtral-12b 256 patches +
             p128, recurrentgemma-2b batch 2 p2304, xlstm-350m p512,
             whisper-tiny 1500 frames + p128; every other one whole),
             each on a tree of its own, with a profile of a prefill and
             of a decode step; the qwen2-moe fp8 p64 generate (and its
             engine's construction) under the engine contract scaled to
             24 layers (one decode selection, 2 x 24 x 16 plan builds,
             the decode ones on 16 rows); the launch counts of each run are
             asserted; every engine selects its decode tiles (an MoE
             model once, 16 rows, its tokens bitwise those of an engine
             pinned to the fixed 16-row rule; a dense model none, on the
             model's 128-row tiles, its decode step also profiled on 16);
             the padded deepseek serve builds each static plan shape once
             (``PLAN_CACHE.builds``) and none after its warm-up; then the
             window gate: recurrentgemma-2b, one
             cycle, bf16, decoding position 2305 after a prefill of 2304
             (a ring cache) gives the prefill-of-2305 logits;
  8. train-parity  each configuration cut to 2 layers, batch 2, seq 256:
             loss and gradients of one train step through the kernels
             against the plain versions; ``ds_fp8_padded``'s loss
             bitwise ``ds_fp8``'s, and which gradients are bitwise;
  9. train   batch 8, seq 512: the MoE configurations cut to 4 layers (the
             depth one card's 80 GB holds with bf16 params and f32 AdamW
             state; deepseek-moe-16b's dense layer and 3 MoE layers),
             qwen3-1.7b at its full 28 layers: 8 steps through
             ``launch/train.py``'s ``train`` (loss must fall, launch
             counts asserted; a profile of one step and its forward /
             backward / AdamW split), the same 8 steps through the plain
             versions for comparison (not for ``ds_fp8_padded``, which is
             held against ``ds_fp8``: step 0's loss bitwise, every loss
             and grad norm within 1e-3); for ``fp8`` and ``ds_fp8`` then
             the same 8 steps with the fp8 wgrad (launch counts asserted,
             a profile of one step);
  10. checkpoint  ``ds_fp8`` cut to 2 layers trained 4 steps through
             ``train`` with a checkpoint after the last, under ``build/``:
             restored into a fresh tree, every leaf equal to the live
             state and the next batch's loss bitwise the live params';
             then ``train`` resumes from it and runs one more step; the
             bytes written and the save and restore seconds.
Each phase's seconds are printed.  Then the ``{"kernels": [...]}`` line,
the card's ``nvidia-smi`` name and power limit, and last ``{"ok": true,
"device": {...}}``.  Any failure raises and the script exits non-zero.
Without a CUDA device, or without the package beside it, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 peak bandwidth
FP8_FLOP_PER_S = 1979e12        # dense fp8 tensor-core peak
BF16_FLOP_PER_S = 989e12        # dense bf16 tensor-core peak
L2_BYTES = 50 * 2 ** 20         # H100 L2 cache
# profiler kernel names -> category, first match wins
KERNEL_CATEGORIES = (
    ("flash attention", ("flash_attention_kernel",)),
    ("grouped GEMMs (gmm, gmm_quant, gmm_bf16)", ("gmm_fp8_tma_kernel",
                                                  "gmm_bf16_tma_kernel")),
    ("wgrad", ("wgrad_bf16_kernel", "wgrad_fp8_kernel")),
    ("quantize + act_quantize", ("quantize_tilewise_kernel",
                                 "act_quantize_kernel")),
    ("cuBLAS matmuls", ("gemm", "nvjet", "xmma", "cutlass")),
)
REPLACES = {
    "quantize_tilewise": "src/repro/kernels/quant_kernel.py:44",
    "act_quantize": "src/repro/kernels/epilogue_kernel.py:80",
    "act_quantize_fp8": "src/repro/kernels/epilogue_kernel.py:80",
    "gmm": "src/repro/kernels/grouped_gemm_kernel.py:150",
    "gmm_quant": "src/repro/kernels/grouped_gemm_kernel.py:454",
    "gmm_bf16": "src/repro/kernels/grouped_gemm_kernel.py:306",
    "wgrad": "src/repro/kernels/wgrad_kernel.py:219",
    "wgrad_fp8": "src/repro/kernels/wgrad_kernel.py:331",
    "flash_attention": "src/repro/kernels/flash_attention_kernel.py:75",
}
SOURCES = {
    "quantize_tilewise": "src/repro_torch/kernels/csrc/quant.cu",
    "act_quantize": "src/repro_torch/kernels/csrc/act_quant.cu",
    "act_quantize_fp8": "src/repro_torch/kernels/csrc/act_quant.cu",
    "gmm": "src/repro_torch/kernels/csrc/grouped_gemm.cu",
    "gmm_quant": "src/repro_torch/kernels/csrc/grouped_gemm.cu",
    "gmm_bf16": "src/repro_torch/kernels/csrc/gmm_bf16.cu",
    "wgrad": "src/repro_torch/kernels/csrc/wgrad_bf16.cu",
    "wgrad_fp8": "src/repro_torch/kernels/csrc/wgrad.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
}
# the configurations driven: ModelConfig fields replaced on the registry's
# qwen2-moe-a2.7b, qwen3-1.7b or deepseek-moe-16b (the kernel configs are
# filled in by variant_config); fp8_dense runs the forward phase only
VARIANTS = ("fp8", "fp8_fused", "bf16", "fp8_flash", "qwen3_flash")
DS_VARIANTS = ("ds_fp8", "ds_fp8_padded")
DENSE_VARIANT = "fp8_dense"
ARCH = {"qwen3_flash": "qwen3-1.7b", "ds_fp8": "deepseek-moe-16b",
        "ds_fp8_padded": "deepseek-moe-16b"}   # the others: qwen2-moe-a2.7b
FLASH = {"attn_backend": "flash"}
# launch counts per layer of one forward (serving) and of one train step
# (deepseek-moe-16b: per MoE layer; its dense first layer's d_ff, 10944,
# is no multiple of 128, so that layer launches none); flash attention
# runs once a layer in a forward at S % 128 == 0 (never in decode), and
# once a layer in a train step: the backward recomputes the plain oracle,
# as the reference does, and the port has no remat.  The padded baseline
# launches what the padding-free path does: one GEMM a padded GEMM.  The
# dense dispatch launches only the shared experts' kernels: one
# quantization of x, the gate and up GEMMs, the fused activation and the
# down GEMM
SERVE_PER_LAYER = {
    "fp8": {"quantize_tilewise": 2, "act_quantize": 2, "gmm": 6},
    "fp8_fused": {"quantize_tilewise": 2, "gmm_quant": 4,
                  "act_quantize_fp8": 2, "gmm": 2},
    "bf16": {"gmm_bf16": 3},
    "fp8_flash": {"quantize_tilewise": 2, "act_quantize": 2, "gmm": 6,
                  "flash_attention": 1},
    "qwen3_flash": {"flash_attention": 1},
    "ds_fp8": {"quantize_tilewise": 2, "act_quantize": 2, "gmm": 6},
    "ds_fp8_padded": {"quantize_tilewise": 2, "act_quantize": 2, "gmm": 6},
    "fp8_dense": {"quantize_tilewise": 1, "act_quantize": 1, "gmm": 3},
}
TRAIN_PER_LAYER = {
    "fp8": {"quantize_tilewise": 8, "act_quantize": 2, "gmm": 12,
            "wgrad": 6},
    "fp8_fused": {"quantize_tilewise": 8, "gmm_quant": 4,
                  "act_quantize_fp8": 2, "gmm": 8, "wgrad": 6},
    "bf16": {"gmm_bf16": 6, "wgrad": 3},
    "fp8_flash": {"quantize_tilewise": 8, "act_quantize": 2, "gmm": 12,
                  "wgrad": 6, "flash_attention": 1},
    "qwen3_flash": {"flash_attention": 1},
    "ds_fp8": {"quantize_tilewise": 8, "act_quantize": 2, "gmm": 12,
               "wgrad": 6},
    "ds_fp8_padded": {"quantize_tilewise": 8, "act_quantize": 2, "gmm": 12,
                      "wgrad": 6},
}
# training depth: the MoE models cut to 4 layers (deepseek-moe-16b: the
# dense layer and 3 MoE layers), qwen3-1.7b whole
TRAIN_LAYERS = {"qwen3_flash": 28}


def variant_config(variant: str, **kw):
    """The configuration ``variant``, with ``kw`` (e.g. a depth cut)
    replaced too."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.plan import KernelConfig
    repl = {"fp8": {}, "fp8_fused": {"kernel_config":
                                     KernelConfig(fuse_producer=True)},
            "bf16": {"precision": "bf16"}, "fp8_flash": FLASH,
            "qwen3_flash": FLASH, "ds_fp8": {},
            "ds_fp8_padded": {"gemm_backend": "padded_baseline"},
            "fp8_dense": {"moe_dispatch": "dense"}}[variant]
    return dataclasses.replace(get_config(ARCH.get(variant,
                                                   "qwen2-moe-a2.7b")),
                               **repl, **kw)


def kernel_layers(cfg) -> int:
    """The layers whose kernels SERVE_PER_LAYER and TRAIN_PER_LAYER count:
    all but an MoE model's dense first layers."""
    return cfg.num_layers - (cfg.moe.first_dense_layers if cfg.moe else 0)


def expected(per_layer: dict, times: int) -> dict:
    """Expected launch counts of every kernel: ``per_layer`` times
    ``times`` (layers x forwards or steps), 0 for the others."""
    return {name: per_layer.get(name, 0) * times for name in SOURCES}


def serve_expected(variant: str, layers: int, prompt: int, new: int) -> dict:
    """Launch counts of one generate: every kernel once per forward (the
    prefill and ``new - 1`` decode steps), flash attention in the prefill
    alone and only at a prompt that is a multiple of 128."""
    per = dict(SERVE_PER_LAYER[variant])
    flash = per.pop("flash_attention", 0)
    out = expected(per, layers * new)
    out["flash_attention"] = flash * layers if prompt % 128 == 0 else 0
    return out


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


def counters() -> dict:
    """name -> (wrapper, attribute) of each kernel's launch count; the
    fused activation quantizer counts its two input modes apart."""
    from repro_torch.kernels import epilogue_kernel, flash_attention_kernel, \
        grouped_gemm_kernel, quant_kernel, wgrad_kernel
    return {"quantize_tilewise": (quant_kernel.quantize_tilewise_cuda,
                                  "launches"),
            "act_quantize": (epilogue_kernel.act_quantize_cuda, "launches"),
            "act_quantize_fp8": (epilogue_kernel.act_quantize_cuda,
                                 "fp8_launches"),
            "gmm": (grouped_gemm_kernel.gmm_cuda, "launches"),
            "gmm_quant": (grouped_gemm_kernel.gmm_quant_cuda, "launches"),
            "gmm_bf16": (grouped_gemm_kernel.gmm_bf16_cuda, "launches"),
            "wgrad": (wgrad_kernel.gmm_wgrad_cuda, "launches"),
            "wgrad_fp8": (wgrad_kernel.gmm_wgrad_fp8_cuda, "launches"),
            "flash_attention": (flash_attention_kernel.flash_attention_cuda,
                                "launches")}


def reset_counts() -> None:
    for fn, attr in counters().values():
        setattr(fn, attr, 0)


def read_counts() -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in counters().items()}


@contextlib.contextmanager
def plain_kernels():
    """Route the serving and training paths through the plain PyTorch
    versions (on the same card) by swapping the kernel modules' public
    functions."""
    from repro_torch.kernels import epilogue_kernel as ek
    from repro_torch.kernels import flash_attention_kernel as fk
    from repro_torch.kernels import grouped_gemm_kernel as gk
    from repro_torch.kernels import quant_kernel as qk
    from repro_torch.kernels import wgrad_kernel as wk
    saved = (qk.quantize_tilewise, ek.act_quantize, gk.gmm, gk.gmm_quant,
             gk.gmm_bf16, wk.gmm_wgrad, wk.gmm_wgrad_fp8, fk.flash_attention)
    qk.quantize_tilewise = qk.quantize_tilewise_plain
    ek.act_quantize = ek.act_quantize_plain
    gk.gmm = gk.gmm_plain
    gk.gmm_quant = gk.gmm_quant_plain
    gk.gmm_bf16 = gk.gmm_bf16_plain
    wk.gmm_wgrad = wk.gmm_wgrad_plain
    wk.gmm_wgrad_fp8 = wk.gmm_wgrad_fp8_plain
    fk.flash_attention = fk.flash_attention_plain
    try:
        yield
    finally:
        (qk.quantize_tilewise, ek.act_quantize, gk.gmm, gk.gmm_quant,
         gk.gmm_bf16, wk.gmm_wgrad, wk.gmm_wgrad_fp8,
         fk.flash_attention) = saved


@contextlib.contextmanager
def flash_outputs():
    """Collect, in call order, the output (f32) of every flash attention
    the model runs, through the kernel or the plain version."""
    from repro_torch.models import attention as tattn
    real, outs = tattn.flash_attention_trainable, []

    def keep(*args):
        out = real(*args)
        outs.append(out.float())
        return out
    tattn.flash_attention_trainable = keep
    try:
        yield outs
    finally:
        tattn.flash_attention_trainable = real


@contextlib.contextmanager
def timed(name: str):
    """Print the seconds the phase ``name`` took, once it is done."""
    t0 = time.perf_counter()
    yield
    emit({"phase": "seconds", "of": name,
          "seconds": time.perf_counter() - t0})


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


def routed_sizes(gen, tokens, top_k, g):
    """Group sizes as the router draws them: each of ``tokens`` tokens
    sends its row to ``top_k`` distinct experts of ``g``."""
    import torch
    picks = torch.stack([torch.randperm(g, generator=gen)[:top_k]
                         for _ in range(tokens)])
    return torch.bincount(picks.flatten(), minlength=g).to(torch.int32)


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


def wgrad_case(gen, m, k, n, sizes, fp8, *, nan_tail=False):
    """Operands of one wgrad call: bf16 x, dy or their 1x128 fp8
    quantizations, the group sizes on the card and the forward's plan.
    With ``nan_tail`` every row past sum(sizes) holds NaN (payload and
    scales)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.plan import make_tile_plan
    x = torch.randn((m, k), generator=gen, device="cuda")
    dy = torch.randn((m, n), generator=gen, device="cuda") * 1e-2
    total = int(sizes.sum())
    gs = sizes.cuda()
    plan = make_tile_plan(gs, m, block_m=128, num_groups=sizes.numel())
    if fp8:
        args = [*ref.quantize_tilewise_ref(x), *ref.quantize_tilewise_ref(dy)]
    else:
        args = [x.bfloat16(), dy.bfloat16()]
    if nan_tail:
        for t in args:
            if t.dtype == torch.float8_e4m3fn:
                t.view(torch.uint8)[total:] = 0x7F      # e4m3 NaN
            else:
                t[total:] = float("nan")
    return (*args, gs), plan


def compare_wgrad(name, fp8, args, plan, out_dtype=None):
    """Kernel against plain version: within 1e-4 of the largest |dw| plus
    1e-6 (both sum exact products in f32, in another order; the fp8
    kernel's scaled dy enters as a bf16 hi + lo pair, ~2^-16 relative);
    a bf16 dw (the kernel's f32 sum rounded once) against the plain f32 dw
    within that plus half a bf16 step (2^-8 of the value); two launches
    bitwise equal; empty groups exactly zero; no NaN."""
    import torch
    from repro_torch.kernels import wgrad_kernel as wk
    cuda = wk.gmm_wgrad_fp8_cuda if fp8 else wk.gmm_wgrad_cuda
    plain = wk.gmm_wgrad_fp8_plain if fp8 else wk.gmm_wgrad_plain
    out_dtype = out_dtype or torch.float32
    dw = cuda(*args, plan=plan, out_dtype=out_dtype)
    dw2 = cuda(*args, plan=plan, out_dtype=out_dtype)
    want = plain(*args, plan=plan)
    torch.cuda.synchronize()
    label = f"{'wgrad_fp8' if fp8 else 'wgrad'} {name} {str(out_dtype)[6:]}"
    if dw.dtype != out_dtype:
        raise AssertionError(f"{label}: dw is {dw.dtype}")
    if not torch.equal(dw, dw2):
        raise AssertionError(f"{label}: two launches differ")
    if not torch.isfinite(dw).all():
        raise AssertionError(f"{label}: non-finite values in dw")
    empty = (args[-1] == 0).nonzero().flatten()
    if (dw[empty] != 0).any():
        raise AssertionError(f"{label}: an empty group's dw is not zero")
    err = (dw.float() - want).abs()
    scale = float(want.abs().max())
    tol = 1e-4 * scale + 1e-6
    if out_dtype == torch.bfloat16:
        tol = tol + want.abs() * 2.0 ** -8
    bad = int((err > tol).sum())
    if bad:
        raise AssertionError(f"{label}: {bad} elements beyond tolerance "
                             f"(max err {float(err.max())})")
    x, dy = args[0], args[2] if fp8 else args[1]
    return {"case": name, "out_dtype": str(out_dtype)[6:],
            "shape": [x.shape[0], x.shape[1], dy.shape[1]],
            "groups": int(args[-1].numel()), "empty_groups": int(empty.numel()),
            "total_rows": int(args[-1].sum()),
            "max_abs_err": float(err.max()), "rel_to_max":
            float(err.max()) / scale if scale else 0.0, "bitwise_repeat": True}


def check_wgrad(gen, cpu_gen, routed):
    """B4 and B6, each at both output dtypes, at the training path's shapes
    (``routed``: 16384 slots over 60 groups, 8 of them empty; the shared
    experts' G = 1 over 4096 rows) and the edge cases.  Returns the rows
    and the routed gate's operands."""
    import torch
    shared = torch.tensor([4096], dtype=torch.int32)
    cases = {
        "routed_gate_up": (16384, 2048, 1408, routed, {}),
        "routed_down": (16384, 1408, 2048, routed, {}),
        "shared_gate_up": (4096, 2048, 5632, shared, {}),
        "shared_down": (4096, 5632, 2048, shared, {}),
        "nan_tail": (4096, 2048, 1408,
                     ragged_sizes(cpu_gen, 4096, 60, 3900, empty=8),
                     {"nan_tail": True}),
        "all_empty": (1024, 256, 256, torch.zeros(8, dtype=torch.int32), {}),
        "mid_chunk": (300, 256, 384,
                      torch.tensor([1, 37, 0, 200, 5, 57], dtype=torch.int32),
                      {}),
    }
    rows = {"wgrad": [], "wgrad_fp8": []}
    keep = {}
    for fp8, key in ((False, "wgrad"), (True, "wgrad_fp8")):
        for name, (m, k, n, sizes, kw) in cases.items():
            args, plan = wgrad_case(gen, m, k, n, sizes, fp8, **kw)
            for dt in (torch.bfloat16, torch.float32):
                rows[key].append(compare_wgrad(name, fp8, args, plan, dt))
            if name == "routed_gate_up":
                keep[key] = (args, plan)
            del args
        rows[key].append(check_wgrad_nan_owned(gen, fp8))
    return rows, keep


def check_wgrad_nan_owned(gen, fp8):
    """A NaN in an owned row of x reaches dw where the plain version puts
    it (x[m, k] times every dy[m, n]: the whole row k of the group's dw),
    at both output dtypes; the rest within compare_wgrad's tolerance."""
    import torch
    from repro_torch.kernels import wgrad_kernel as wk
    sizes = torch.tensor([1, 37, 0, 200, 5, 57], dtype=torch.int32)
    args, plan = wgrad_case(gen, 300, 256, 384, sizes, fp8)
    x = args[0]
    if fp8:
        x.view(torch.uint8)[50, 130] = 0x7F            # e4m3 NaN, group 3
    else:
        x[50, 130] = float("nan")
    cuda = wk.gmm_wgrad_fp8_cuda if fp8 else wk.gmm_wgrad_cuda
    plain = wk.gmm_wgrad_fp8_plain if fp8 else wk.gmm_wgrad_plain
    want = plain(*args, plan=plan)
    label = f"{'wgrad_fp8' if fp8 else 'wgrad'} nan_owned"
    worst = 0.0
    for dt in (torch.bfloat16, torch.float32):
        dw = cuda(*args, plan=plan, out_dtype=dt).float()
        torch.cuda.synchronize()
        nan = torch.isnan(dw)
        if not torch.equal(nan, torch.isnan(want)) or not nan.any():
            raise AssertionError(f"{label} {str(dt)[6:]}: NaN positions "
                                 "differ from the plain version's")
        ok = ~nan
        err = (dw[ok] - want[ok]).abs()
        tol = 1e-4 * float(want[ok].abs().max()) + 1e-6
        if dt == torch.bfloat16:
            tol = tol + want[ok].abs() * 2.0 ** -8
        if (err > tol).any():
            raise AssertionError(f"{label} {str(dt)[6:]}: finite elements "
                                 f"beyond tolerance (max err "
                                 f"{float(err.max())})")
        worst = max(worst, float(err.max()))
    return {"case": "nan_owned", "shape": [300, 256, 384],
            "groups": int(sizes.numel()), "nan_elements":
            int(torch.isnan(want).sum()), "max_abs_err": worst}


def dequant(q, s):
    import torch
    return q.float() * torch.repeat_interleave(s, 128, dim=1)


def check_act_quantize_fp8(gen, rows):
    """B3's fp8-input mode against its plain version, bitwise (payload and
    scales): both dequantize as float(q) * s and run B3's activation and
    B1's quantizer."""
    import torch
    from repro_torch.kernels import epilogue_kernel as ek
    from repro_torch.kernels import ref
    out = []
    for m, k, act in rows:
        g8, sg = ref.quantize_tilewise_ref(
            torch.randn((m, k), generator=gen, device="cuda") * 2)
        u8, su = (None, None) if act == "gelu" else ref.quantize_tilewise_ref(
            torch.randn((m, k), generator=gen, device="cuda") * 2)
        q, s = ek.act_quantize_cuda(g8, u8, s_g=sg, s_u=su, act=act)
        qp, sp = ek.act_quantize_plain(g8, u8, s_g=sg, s_u=su, act=act)
        torch.cuda.synchronize()
        mism = int((q.view(torch.uint8) != qp.view(torch.uint8)).sum()) \
            + int((s != sp).sum())
        if mism:
            raise AssertionError(f"act_quantize fp8 {act} [{m},{k}]: {mism} "
                                 "payload/scale values differ from the plain "
                                 "version")
        out.append({"shape": [m, k], "act": act, "mismatches": 0,
                    "max_abs_err": float((dequant(q, s)
                                          - dequant(qp, sp)).abs().max())})
    return out


def compare_gemm_quant(name, args, kw, plan, *, nan_out=False):
    """B7 bitwise against B1 applied to B2's output (payload bytes and
    scales), and against its plain version within one e4m3 step plus the
    GEMM's one-bf16-step tolerance; tail rows payload 0 and scale 1.
    ``nan_out``: into a payload and scales prefilled with NaN, so a row
    left unwritten shows."""
    import torch
    from repro_torch.kernels import grouped_gemm_kernel as gk
    from repro_torch.kernels import quant_kernel as qk
    m, n = args[0].shape[0], args[2].shape[2]
    out = None
    if nan_out:
        out = (torch.full((m, n), 0x7F, dtype=torch.uint8,
                          device="cuda").view(torch.float8_e4m3fn),
               torch.full((m, n // 128), float("nan"), device="cuda"))
    q, s = gk.gmm_quant_cuda(*args, out=out, **kw)
    q2, s2 = qk.quantize_tilewise_cuda(gk.gmm_cuda(*args, **kw).float())
    qp, sp = gk.gmm_quant_plain(*args, **kw)
    torch.cuda.synchronize()
    total = int(plan.total_rows())
    qb = q.view(torch.uint8)
    mism = int((qb != q2.view(torch.uint8)).sum()) + int((s != s2).sum())
    if mism:
        raise AssertionError(f"gmm_quant {name}: {mism} payload/scale values "
                             "differ from the quantizer applied to gmm")
    if (qb[total:] != 0).any() or (s[total:] != 1).any():
        raise AssertionError(f"gmm_quant {name}: rows >= total={total} are "
                             "not payload 0 / scale 1")
    if ((qb & 0x7F) == 0x7F).any() or not torch.isfinite(s).all():
        raise AssertionError(f"gmm_quant {name}: NaN in the output")
    dq, dp = dequant(q, s), dequant(qp, sp)
    step = torch.maximum(e4m3_step(q) * torch.repeat_interleave(s, 128, 1),
                         e4m3_step(qp) * torch.repeat_interleave(sp, 128, 1))
    scale = float(dp.abs().max()) if dp.numel() else 0.0
    err = (dq - dp).abs()
    tol = step + dp.abs() * 2.0 ** -7 + 1e-4 * scale + 1e-30
    bad = int((err > tol).sum())
    if bad:
        raise AssertionError(f"gmm_quant {name}: {bad} dequantized values "
                             f"beyond tolerance of the plain version (max "
                             f"err {float(err.max())})")
    return {"case": name, "shape": [m, args[0].shape[1], n],
            "groups": args[2].shape[0], "total_rows": total,
            "block_m": kw["block_m"], "bitwise_vs_quantize_of_gmm": True,
            "max_abs_err": float(err.max()) if err.numel() else 0.0,
            "rel_to_max": float(err.max()) / scale if scale else 0.0}


def check_gemm_quant(gen, cases):
    import torch
    from repro_torch.kernels import grouped_gemm_kernel as gk
    out = []
    for name, (m, k, n, sizes, bm, nan_tail) in cases.items():
        args, kw, plan = gemm_case(gen, m, k, n, sizes, bm, torch.bfloat16)
        if nan_tail:
            # rows past sum(sizes) hold NaN: they must not be read into
            # any owned row, and come back as payload 0 / scale 1
            total = int(sizes.sum())
            args[0].view(torch.uint8)[total:] = 0x7F
            args[1][total:] = float("nan")
        out.append(compare_gemm_quant(name, args, kw, plan,
                                      nan_out=name.startswith("spans")))
        if name in ("prefill_gate_up", "train_gate_up"):
            repeat_bitwise("gmm_quant " + name, gk.gmm_quant_cuda, args, kw)
        del args
    return out


def repeat_bitwise(label, fn, args, kw):
    """Two launches of ``fn`` on the same operands give the same bits."""
    import torch
    y1, y2 = fn(*args, **kw), fn(*args, **kw)
    if not isinstance(y1, tuple):
        y1, y2 = (y1,), (y2,)
    for a, b in zip(y1, y2):
        if not torch.equal(a.view(torch.uint8), b.view(torch.uint8)):
            raise AssertionError(f"{label}: two launches differ")


def spans_cases(dtypes):
    """"spans": every owned span 1..block_m of a tile, so every descriptor
    of a TMA store pool stores (tile i holds groups of i + 1 and
    block_m - 1 - i rows), then a partial tile of owned rows and zero
    rows, with M not a multiple of 64; at block_m 128 and 16, for each
    output dtype: name -> (m, k, n, sizes, block_m, dtype)."""
    import torch
    cases = {}
    for bm in (128, 16):
        spans = [s for i in range(bm) for s in (i + 1, bm - 1 - i)]
        sizes = torch.tensor(spans + [bm // 8 + 4], dtype=torch.int32)
        m = bm * bm + bm // 4 + 5
        for dt in dtypes:
            cases[f"spans_bm{bm}_{str(dt)[6:]}"] = (m, 256, 256, sizes, bm, dt)
    return cases


def bf16_case(gen, m, k, n, sizes, block_m, out_dtype, k_major=False):
    """Operands of one B5 call; ``k_major``: w is ``transpose(1, 2)`` of a
    contiguous [G, N, K], as the bf16 dgrad hands it over."""
    import torch
    from repro_torch.kernels.plan import make_tile_plan
    g = sizes.numel()
    x = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
    shape = (g, n, k) if k_major else (g, k, n)
    w = (torch.randn(shape, generator=gen, device="cuda")
         * k ** -0.5).bfloat16()
    if k_major:
        w = w.transpose(1, 2)
    gs = sizes.cuda()
    plan = make_tile_plan(gs, m, block_m=block_m, num_groups=g)
    kw = dict(num_groups=g, block_m=block_m, out_dtype=out_dtype, plan=plan)
    return (x, w, gs), kw, plan


def compare_gemm_bf16(name, args, kw, plan, *, nan_out=False):
    """B5 against its plain version: one bf16 step (2^-7 of the value +
    1e-4 of the max) for a bf16 output, 1e-5 of the max for an f32 one
    (the two sum each 128-K block in another order); tail rows exactly 0."""
    import torch
    from repro_torch.kernels import grouped_gemm_kernel as gk
    x, w, _ = args
    m, n = x.shape[0], w.shape[2]
    out = None
    if nan_out:
        out = torch.full((m, n), float("nan"), dtype=kw["out_dtype"],
                         device="cuda")
    y = gk.gmm_bf16_cuda(*args, out=out, **kw).float()
    yp = gk.gmm_bf16_plain(*args, **kw).float()
    torch.cuda.synchronize()
    total = int(plan.total_rows())
    if torch.isnan(y).any():
        raise AssertionError(f"gmm_bf16 {name}: NaN rows left in the output")
    if (y[total:] != 0).any():
        raise AssertionError(f"gmm_bf16 {name}: rows >= total={total} are "
                             "not zero")
    err = (y - yp).abs()
    scale = float(yp.abs().max()) if yp.numel() else 0.0
    if kw["out_dtype"] == torch.float32:
        tol = 1e-5 * scale + 1e-30
    else:
        tol = yp.abs() * 2.0 ** -7 + 1e-4 * scale + 1e-30
    bad = int((err > tol).sum())
    if bad:
        raise AssertionError(f"gmm_bf16 {name}: {bad} elements beyond "
                             f"tolerance (max err {float(err.max())})")
    return {"case": name, "shape": [m, x.shape[1], n], "groups": w.shape[0],
            "total_rows": total, "block_m": kw["block_m"],
            "out_dtype": str(kw["out_dtype"]),
            "w_layout": "K-contiguous" if gk.weight_layout(w) else
            "N-contiguous",
            "max_abs_err": float(err.max()) if err.numel() else 0.0,
            "rel_to_max": float(err.max()) / scale if scale else 0.0,
            "mismatches": int((err > 0).sum())}


# B5's timed cases (bf16_cases below) and their timing keys
BF16_TIMED = (("prefill_gate", "gmm_bf16"), ("train_gate_up", "gmm_bf16_train"),
              ("decode_gate", "gmm_bf16_decode"),
              ("train_dgrad_gate_up_f32_wT", "gmm_bf16_dgrad"))


# flash attention: the shapes checked (the MoE serve prefill, the qwen3
# train step, MQA, D 64) and the shapes timed (each model's serve prefill,
# batch 4 x prompt 512, and train step, batch 8 x 512): b, hq, hkv, s, d
FLASH_CASES = {
    "moe_serve_prefill": (4, 16, 16, 512, 128),
    "qwen3_train": (8, 16, 8, 512, 128),
    "mqa": (4, 16, 1, 512, 128),
    "d64": (4, 16, 4, 512, 64),
}
FLASH_TIMED = {
    "moe_serve_prefill": (4, 16, 16, 512, 128),
    "moe_train": (8, 16, 16, 512, 128),
    "qwen3_serve_prefill": (4, 16, 8, 512, 128),
    "qwen3_train": (8, 16, 8, 512, 128),
}


def flash_inputs(gen, b, hq, hkv, s, d):
    import torch
    return tuple(torch.randn(shape, generator=gen, device="cuda").bfloat16()
                 for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d)))


def flash_tol(want):
    """One bf16 step of the value (2^-7 relative) plus 1e-4 of the max:
    kernel and plain version both round an f32 result to bf16, and their
    f32 results differ by the order of the sums and by p entering P.V as
    a bf16 hi + lo pair (~2^-16 relative), which can flip that rounding."""
    return want.abs() * 2.0 ** -7 + 1e-4 * want.abs().max()


def check_flash(gen):
    """B8 against its plain version, causal and not, at FLASH_CASES: within
    :func:`flash_tol`, two launches bitwise equal, finite; what the kernel
    does not take raises."""
    import torch
    from repro_torch.kernels import flash_attention_kernel as fk
    rows = []
    for name, shape in FLASH_CASES.items():
        q, k, v = flash_inputs(gen, *shape)
        for causal in (True, False):
            o = fk.flash_attention_cuda(q, k, v, causal=causal)
            o2 = fk.flash_attention_cuda(q, k, v, causal=causal)
            want = fk.flash_attention_plain(q, k, v, causal=causal).float()
            torch.cuda.synchronize()
            label = f"flash_attention {name} causal={causal}"
            if not torch.equal(o, o2):
                raise AssertionError(f"{label}: two launches differ")
            if not torch.isfinite(o.float()).all():
                raise AssertionError(f"{label}: non-finite output")
            err = (o.float() - want).abs()
            bad = int((err > flash_tol(want)).sum())
            if bad:
                raise AssertionError(f"{label}: {bad} elements beyond "
                                     f"tolerance (max err {float(err.max())})")
            rows.append({"case": name, "shape": list(shape), "causal": causal,
                         "max_abs_err": float(err.max()),
                         "rel_to_max": float(err.max() / want.abs().max()),
                         "mismatches": int((err > 0).sum()),
                         "bitwise_repeat": True})
        del q, k, v
    x = torch.zeros((1, 2, 128, 128), device="cuda", dtype=torch.bfloat16)
    for bad, err in ((dict(q=x.float(), k=x.float(), v=x.float()), TypeError),
                     (dict(q=x[..., :96].contiguous(), k=x[..., :96]
                           .contiguous(), v=x[..., :96].contiguous()),
                      ValueError),
                     (dict(q=x.transpose(2, 3), k=x, v=x), ValueError)):
        try:
            fk.flash_attention_cuda(**bad)
            raise AssertionError("flash_attention_cuda took what it does not "
                                 "take")
        except err:
            pass
    return rows


def flash_hi_only():
    """B8 built without its lo product, so that p enters P.V in plain bf16
    as SDPA's does: ``csrc/flash_attention.cu`` with the two lines marked
    "the lo product" removed, compiled as ``build.py`` compiles the
    kernels.  For timing only; the port never builds or calls it.
    Returns a launcher ``(q, k, v) -> o``."""
    import ctypes
    import subprocess
    import torch
    from repro_torch.kernels import build
    lines = (build.CSRC / "flash_attention.cu").read_text().splitlines()
    kept = [ln for ln in lines if "// the lo product" not in ln]
    if len(kept) != len(lines) - 2:
        raise AssertionError("flash_attention.cu: the two lo products are "
                             "not marked")
    out_dir = build.build_all() / "hi_only"
    out_dir.mkdir(exist_ok=True)
    cu = out_dir / "flash_attention_hi_only.cu"
    cu.write_text("\n".join(kept) + "\n")
    so = out_dir / "libflash_attention_hi_only.so"
    r = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I",
                        str(build.CSRC), "-o", str(so), str(cu)],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"hi-only flash build failed:\n{r.stdout}{r.stderr}")
    fn = ctypes.CDLL(str(so)).flash_attention_bf16
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + \
        [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(q, k, v):
        o = torch.empty_like(q)
        b, hq, s, d = q.shape
        build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       o.data_ptr(), b, hq, k.shape[1], s, d, 1, d ** -0.5,
                       build.stream_ptr(q.device)), "flash hi-only")
        return o
    return run


def time_flash(gen, worst):
    """B8's times at FLASH_TIMED (causal): the kernel in a CUDA graph with
    inputs rotated through more than the L2, eager, the plain version
    eager; ``F.scaled_dot_product_attention`` (the one PyTorch call of the
    same function, which the port never calls) checked against the plain
    version and timed the same two ways; and B8 built without its lo
    product (:func:`flash_hi_only`), graph-timed, with its error against
    the plain version (not gated)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention_kernel as fk
    hi_only = flash_hi_only()
    shapes = {}
    for label, (b, hq, hkv, s, d) in FLASH_TIMED.items():
        nbytes = 2 * (2 * b * hq * s * d + 2 * b * hkv * s * d)
        ins = rotation(lambda: flash_inputs(gen, b, hq, hkv, s, d), nbytes)
        n = len(ins)

        def sdpa(i):
            return F.scaled_dot_product_attention(*ins[i % n], is_causal=True,
                                                  enable_gqa=True)
        # SDPA's flash kernel feeds p to P.V in plain bf16 (2^-9 relative
        # an element), which moves an output by up to ~2^-9 of max|v|
        # beyond the bf16 rounding: held at one bf16 step plus 2^-8 of
        # max|v|
        vmax = float(ins[0][2].float().abs().max())
        lib_ms, note = library_call(
            sdpa, fk.flash_attention_plain(*ins[0]),
            lambda w: w.abs() * 2.0 ** -7 + 2.0 ** -8 * vmax)
        lib_eager = lib_ms
        if lib_ms is not None:
            lib_ms = graph_ms(sdpa, iters=2 * n)
            lib_eager = cuda_ms(sdpa, iters=2 * n)
        hi_err = float((hi_only(*ins[0]).float()
                        - fk.flash_attention_plain(*ins[0]).float())
                       .abs().max())
        shapes[label] = dict(
            shape=[b, hq, hkv, s, d], input_copies=n,
            ms=graph_ms(lambda i: fk.flash_attention_cuda(*ins[i % n]),
                        iters=2 * n),
            hi_only_ms=graph_ms(lambda i: hi_only(*ins[i % n]), iters=2 * n),
            hi_only_max_abs_err=hi_err,
            eager_ms=cuda_ms(lambda i: fk.flash_attention_cuda(*ins[i % n]),
                             iters=2 * n),
            plain_ms=cuda_ms(lambda i: fk.flash_attention_plain(*ins[i % n]),
                             iters=n, warmup=1),
            bytes=nbytes, flops=2 * b * hq * s * s * d,
            library_ms=lib_ms, library_eager_ms=lib_eager,
            library_note="F.scaled_dot_product_attention(q, k, v, "
                         f"is_causal=True, enable_gqa=True): {note}")
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = shapes[label]["flops"] / BF16_FLOP_PER_S * 1e3
        shapes[label].update(bound_ms=max(t_bytes, t_ops),
                             bound_by="bytes" if t_bytes >= t_ops
                             else "operations")
        del ins
    # the kernels line's row: the MoE serve prefill; its bound and library
    # columns are filled in as every kernel's are
    main = {k: v for k, v in shapes["moe_serve_prefill"].items()
            if not k.startswith(("library", "bound"))}
    lib = (shapes["moe_serve_prefill"]["library_ms"],
           shapes["moe_serve_prefill"]["library_note"])
    return dict(main, shapes=shapes, peak_flop_per_s=BF16_FLOP_PER_S,
                max_abs_err=worst), lib


def gemm_sizes(cpu_gen) -> dict:
    """The grouped GEMMs' group sizes (60 groups): "prefill" 1000 of 1024
    rows, 8 groups empty; "decode_ragged" 16 rows over 12 groups;
    "train" 16384 routed slots, 8 groups empty (drawn in that order from
    ``cpu_gen``); "decode" decode's 16 rows grouped as the router groups
    them (batch 4, top-4 of 60: ~14 visited experts), drawn apart."""
    import torch
    out = {"prefill": ragged_sizes(cpu_gen, 1024, 60, 1000, empty=8),
           "decode_ragged": ragged_sizes(cpu_gen, 16, 60, 16, empty=48),
           "train": ragged_sizes(cpu_gen, 16384, 60, 16384, empty=8)}
    out["decode"] = routed_sizes(torch.Generator().manual_seed(3), 4, 4, 60)
    return out


# B2's and B7's timed shapes, where the serving and training paths run
# them: timing key -> (group sizes, M, K, N, block_m, output dtype); the
# routed gate at prefill, at decode and in training, the training
# dgrad of the gate/up (dx = dy @ w^T, f32 out)
GMM_FP8_TIMED = {
    "gmm": ("prefill", 1024, 2048, 1408, 128, "bfloat16"),
    "gmm_decode": ("decode", 16, 2048, 1408, 16, "bfloat16"),
    "gmm_train": ("train", 16384, 2048, 1408, 128, "bfloat16"),
    "gmm_dgrad": ("train", 16384, 1408, 2048, 128, "float32"),
    "gmm_quant": ("prefill", 1024, 2048, 1408, 128, "bfloat16"),
    "gmm_quant_decode": ("decode", 16, 2048, 1408, 16, "bfloat16"),
    "gmm_quant_train": ("train", 16384, 2048, 1408, 128, "bfloat16"),
}


def time_gmm_fp8(gen, sizes) -> dict:
    """Times of B2 (``gmm*``) and B7 (``gmm_quant*``) at GMM_FP8_TIMED's
    shapes: CUDA-graph replays ("ms") and back-to-back eager calls, each
    call on its own copy of A and B (with their scales), enough copies
    that each call reads them from HBM; the plain version's eager time;
    the bytes (each input read once, each output written once) and the
    products' operations, which the caller turns into the bound at the
    rate of the operands' type, fp8 (the kernels' f16 products on
    widened operands are a choice of their design, not of the work).
    B7 at prefill also times B2 then B1, the unfused pair it replaces."""
    import torch
    from repro_torch.kernels import grouped_gemm_kernel as gk
    from repro_torch.kernels import quant_kernel as qk
    out = {}
    for key, (which, m, k, n, bm, dt) in GMM_FP8_TIMED.items():
        quant = key.startswith("gmm_quant")
        dt = getattr(torch, dt)
        args, kw, plan = gemm_case(gen, m, k, n, sizes[which], bm, dt)
        gs = args[4]
        rows = int(plan.total_rows())
        visited = int((gs > 0).sum())
        kb, nb = k // 128, n // 128
        in_bytes = m * k + 4 * m * kb + visited * (k * n + 4 * kb * nb)
        copies = rotation(lambda: tuple(t.clone() for t in args[:4]),
                          in_bytes)
        iters = len(copies) * -(-10 // len(copies))
        cuda = gk.gmm_quant_cuda if quant else gk.gmm_cuda
        plain = gk.gmm_quant_plain if quant else gk.gmm_plain

        def call(i, cuda=cuda, copies=copies, gs=gs, kw=kw):
            return cuda(*copies[i % len(copies)], gs, **kw)
        row = dict(
            shape=[m, k, n], groups=int(gs.numel()), total_rows=rows,
            visited_groups=visited, block_m=bm, out_dtype=str(dt)[6:],
            input_copies=len(copies),
            ms=graph_ms(call, iters=iters), eager_ms=cuda_ms(call, iters=iters),
            # reads the group offsets back to the host, so no graph: eager
            plain_ms=cuda_ms(lambda i, plain=plain, args=args, kw=kw:
                             plain(*args, **kw), iters=3, warmup=1),
            bytes=in_bytes + (m * n + 4 * m * nb if quant
                              else dt.itemsize * m * n),
            flops=2 * rows * k * n)
        if key == "gmm_quant":
            row["gmm_then_quantize_ms"] = graph_ms(
                lambda i: qk.quantize_tilewise_cuda(
                    gk.gmm_cuda(*copies[i % len(copies)], gs, **kw).float()),
                iters=iters)
        out[key] = row
        del args, copies
    return out


def time_act_quantize(gen, m, k, fp8, copies=None) -> dict:
    """B3 (silu_mul) at [m, k], bf16 g/u or e4m3 g/u with their scales:
    CUDA-graph replays cycling through copies of the inputs (enough to be
    read from HBM, or ``copies`` of them), back-to-back eager calls, the
    plain version graph-replayed, and the bytes of the work."""
    import torch
    from repro_torch.kernels import epilogue_kernel as ek
    from repro_torch.kernels import ref as kref
    scales = 4 * m * k // 128
    if fp8:
        nbytes = 2 * (m * k + scales) + m * k + scales

        def make():
            return tuple(t for _ in range(2) for t in kref.quantize_tilewise_ref(
                torch.randn((m, k), generator=gen, device="cuda")))
    else:
        nbytes = 2 * 2 * m * k + m * k + scales

        def make():
            return tuple(torch.randn((m, k), generator=gen,
                                     device="cuda").bfloat16()
                         for _ in range(2))
    ins = [make() for _ in range(copies)] if copies else rotation(make,
                                                                  nbytes)
    n = len(ins)

    def call(fn, i):
        t = ins[i % n]
        return fn(t[0], t[2], s_g=t[1], s_u=t[3]) if fp8 else fn(*t)
    return dict(
        shape=[m, k], input_copies=n,
        ms=graph_ms(lambda i: call(ek.act_quantize_cuda, i), iters=2 * n),
        eager_ms=cuda_ms(lambda i: call(ek.act_quantize_cuda, i),
                         iters=2 * n),
        plain_ms=graph_ms(lambda i: call(ek.act_quantize_plain, i),
                          iters=2 * n),
        bytes=nbytes, flops=0)


def launch_floor_ms() -> float:
    """Device time of a one-element ``zero_()``, CUDA-graph replayed as the
    kernels are timed: a kernel with next to no work, the floor under a
    small kernel's time."""
    import torch
    t = torch.ones(1, device="cuda")
    return graph_ms(lambda i: t.zero_(), iters=128)


def add_bound(t: dict) -> None:
    """Set a timing row's ``bound_ms``, the least time the card could take
    for its ``bytes`` and ``flops`` (at its ``peak_flop_per_s``, fp8's by
    default), and ``bound_by``, the term that binds."""
    t_bytes = t["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = t["flops"] / t.pop("peak_flop_per_s", FP8_FLOP_PER_S) * 1e3
    t["bound_ms"] = max(t_bytes, t_ops)
    t["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"


def library_call(fn, want, tol_fn):
    """Time ``fn(i)`` (call ``i``), the one PyTorch call computing a
    kernel's function, after checking ``fn(0)`` against ``want`` (the
    plain version's output).
    Returns ``(ms, note)``; ``ms`` is None with the reason where the call
    raises or computes something else."""
    import torch
    try:
        got = fn(0)
        torch.cuda.synchronize()
    except Exception as exc:                   # noqa: BLE001 - recorded
        return None, f"{type(exc).__name__}: " + \
            (str(exc).strip().splitlines() or [""])[0][:200]
    if tuple(got.shape) != tuple(want.shape):
        return None, f"computes another shape {tuple(got.shape)}"
    err = (got.float() - want.float()).abs()
    bad = int((err > tol_fn(want.float())).sum()) + \
        int((~torch.isfinite(got.float())).sum())
    if bad:
        return None, (f"computes something else: {bad} elements beyond the "
                      f"kernel's tolerance (max err {float(err.max())})")
    return cuda_ms(fn, iters=10), "matches the plain version"


def phase_library(gmm_setup, wgrad_setup, bf16_setups):
    """The library column: ``F.scaled_grouped_mm`` (1x128 A, 128x128 B,
    ``offs``) for the fp8 grouped GEMM, ``F.grouped_mm(x, w, offs=...)``
    for the bf16 grouped GEMM (owned rows only: it has no tail) at each
    shape B5 is timed at (``bf16_setups``, by timing key: the routed
    prefill, the training path's 16384 rows, decode with its weights
    alternated between two copies as B5's time does, and the dgrad on
    the K-contiguous ``w^T``, whose f32 output it may refuse; the training
    path casts dx to bf16 at once, so bf16 output is what it consumes),
    ``F.grouped_mm(x.T, dy, offs=...)`` for the bf16 wgrad; no single
    PyTorch call computes the quantizers, the fused activation quantizer,
    the quantizing GEMM or the wgrad on fp8 operands whose scales run
    along the contracted axis."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import grouped_gemm_kernel as gk
    from repro_torch.kernels import wgrad_kernel as wk
    out = {name: (None, "no single PyTorch call computes this function")
           for name in (*SOURCES, "wgrad_fp8_f32")
           if name != "flash_attention"}
    args, kw, plan = gmm_setup
    a8, sa, b8, sb, gs = args
    ends = torch.cumsum(gs, 0).to(torch.int32)
    want = gk.gmm_plain(*args, **kw)
    total = int(plan.total_rows())
    # B column-major, as the fp8 grouped GEMMs take it
    b8_cm = b8.transpose(1, 2).contiguous().transpose(1, 2)
    if hasattr(F, "scaled_grouped_mm"):
        st = F.ScalingType
        out["gmm"] = library_call(
            lambda i: F.scaled_grouped_mm(
                a8[:total], b8_cm, sa[:total], st.BlockWise1x128, sb,
                st.BlockWise128x128, offs=ends,
                output_dtype=torch.bfloat16),
            want[:total],
            lambda w: w.abs() * 2.0 ** -7 + 1e-4 * w.abs().max())
    else:
        out["gmm"] = (None, "torch.nn.functional has no scaled_grouped_mm")
    for key, ((x16, w16, bgs), bkw, bplan) in bf16_setups.items():
        if not hasattr(F, "grouped_mm"):
            out[key] = (None, "torch.nn.functional has no grouped_mm")
            continue
        bends = torch.cumsum(bgs, 0).to(torch.int32)
        xo = x16[:int(bplan.total_rows())]
        bwant = gk.gmm_bf16_plain(x16, w16, bgs, **bkw)[:xo.shape[0]]
        ws = [w16, w16.clone()] if key == "gmm_bf16_decode" else [w16]
        bf16_tol = (lambda w: w.abs() * 2.0 ** -7 + 1e-4 * w.abs().max())
        if bkw["out_dtype"] == torch.bfloat16:
            out[key] = library_call(
                lambda i: F.grouped_mm(xo, ws[i % len(ws)], offs=bends),
                bwant, bf16_tol)
            continue
        ms, note = library_call(
            lambda i: F.grouped_mm(xo, w16, offs=bends,
                                   out_dtype=torch.float32),
            bwant, lambda w: 1e-5 * w.abs().max() + 1e-30)
        if ms is None:
            f32_note = note
            ms, note = library_call(
                lambda i: F.grouped_mm(xo, w16, offs=bends), bwant, bf16_tol)
            note = (f"bf16 output, the dtype the training path consumes "
                    f"({note}); with out_dtype=f32: {f32_note}")
        out[key] = (ms, note)
        del ws
    (x, dy, wgs), wplan = wgrad_setup["wgrad"]
    wends = torch.cumsum(wgs, 0).to(torch.int32)
    wwant = wk.gmm_wgrad_plain(x, dy, wgs, plan=wplan)
    if hasattr(F, "grouped_mm"):
        # bf16 dw, the dtype the training path takes (within half a bf16
        # step of the plain f32 dw, as B4's bf16 output is held), and f32
        out["wgrad"] = library_call(
            lambda i: F.grouped_mm(x.T, dy, offs=wends), wwant,
            lambda w: w.abs() * 2.0 ** -8 + 1e-4 * w.abs().max() + 1e-6)
        out["wgrad_f32"] = library_call(
            lambda i: F.grouped_mm(x.T, dy, offs=wends,
                                   out_dtype=torch.float32),
            wwant, lambda w: 1e-4 * w.abs().max() + 1e-6)
    else:
        out["wgrad"] = out["wgrad_f32"] = (
            None, "torch.nn.functional has no grouped_mm")
    for name, (ms, note) in out.items():
        emit({"phase": "library", "kernel": name, "library_ms": ms,
              "note": note})
    return out


def phase_kernels(full: bool):
    import torch
    from repro_torch.kernels import grouped_gemm_kernel as gk
    from repro_torch.kernels import quant_kernel as qk
    from repro_torch.kernels import wgrad_kernel as wk
    gen = torch.Generator(device="cuda").manual_seed(1)
    cpu_gen = torch.Generator().manual_seed(2)
    results = {}

    # quantize: routed xs at prefill/decode, the shared experts' x; in
    # training (batch 8 x seq 512) the routed xs [16384, 2048] and the
    # shared x [4096, 2048], and every dy of the backward: routed gate/up
    # [16384, 1408] and down [16384, 2048], shared gate/up [4096, 5632]
    # and down [4096, 2048]
    results["quantize_tilewise"] = check_quantize(
        gen, [(1024, 2048), (256, 2048), (16, 2048), (4, 2048),
              (16384, 2048), (16384, 1408), (4096, 5632), (4096, 2048)])
    results["act_quantize"] = check_act_quantize(
        gen, [(1024, 1408, "silu_mul"), (256, 5632, "silu_mul"),
              (16, 1408, "silu_mul"), (4, 5632, "silu_mul"),
              (1024, 1408, "gelu"),
              (16384, 1408, "silu_mul"), (4096, 5632, "silu_mul")])

    gemm = []
    drawn = gemm_sizes(cpu_gen)
    pre, dec, routed = drawn["prefill"], drawn["decode_ragged"], drawn["train"]
    shared = torch.tensor([4096], dtype=torch.int32)
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
        # the training step's forward (bf16 out) and dgrads (dx = dy @ w^T,
        # f32 out): routed at 16384 rows, shared at 4096
        "train_gate_up": (16384, 2048, 1408, routed, 128, torch.bfloat16),
        "train_down": (16384, 1408, 2048, routed, 128, torch.bfloat16),
        "train_dgrad_gate_up_f32": (16384, 1408, 2048, routed, 128,
                                    torch.float32),
        "train_dgrad_down_f32": (16384, 2048, 1408, routed, 128,
                                 torch.float32),
        "train_shared_gate_up": (4096, 2048, 5632, shared, 128,
                                 torch.bfloat16),
        "train_shared_down": (4096, 5632, 2048, shared, 128, torch.bfloat16),
        "train_shared_dgrad_gate_up_f32": (4096, 5632, 2048, shared, 128,
                                           torch.float32),
        "train_shared_dgrad_down_f32": (4096, 2048, 5632, shared, 128,
                                        torch.float32),
        # into NaN-prefilled outputs, at both output dtypes
        **spans_cases((torch.bfloat16, torch.float32)),
    }
    setups = {}
    for name, (m, k, n, sizes, bm, dt) in cases.items():
        args, kw, plan = gemm_case(gen, m, k, n, sizes, bm, dt)
        gemm.append(compare_gemm(name, args, kw, plan,
                                 nan_out=name.startswith("spans")))
        # deterministic: two launches bitwise equal
        if name in ("prefill_gate", "decode_gate", "train_gate_up",
                    "train_dgrad_gate_up_f32"):
            repeat_bitwise("gmm " + name, gk.gmm_cuda, args, kw)
        if not name.startswith(("train", "spans")):   # kept for below
            setups[name] = (args, kw, plan)
        del args
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
    # deepseek-moe-16b (64 experts, top-6) where its serving path runs the
    # GEMM: the routed gate and down at batch 4 x prompt 64 (1536 rows)
    # and 512 (12288 rows) and at decode (24 rows, 16-row tiles), the
    # shared experts' gate/up (N 2 x 1408) and down (f32 out); drawn from
    # generators of their own
    ds_gen = torch.Generator(device="cuda").manual_seed(11)
    ds_cpu = torch.Generator().manual_seed(12)
    ds64, ds512, dsdec = (routed_sizes(ds_cpu, t, 6, 64)
                          for t in (256, 2048, 4))
    for name, (m, k, n, sizes, bm, dt) in {
            "ds_prefill_gate": (1536, 2048, 1408, ds64, 128, torch.bfloat16),
            "ds_prefill_down": (1536, 1408, 2048, ds64, 128, torch.bfloat16),
            "ds_p512_gate": (12288, 2048, 1408, ds512, 128, torch.bfloat16),
            "ds_decode_gate": (24, 2048, 1408, dsdec, 16, torch.bfloat16),
            "ds_decode_down": (24, 1408, 2048, dsdec, 16, torch.bfloat16),
            "ds_shared_gate": (256, 2048, 2816,
                               torch.tensor([256], dtype=torch.int32), 128,
                               torch.bfloat16),
            "ds_shared_down_f32": (256, 2816, 2048,
                                   torch.tensor([256], dtype=torch.int32),
                                   128, torch.float32)}.items():
        args, kw, plan = gemm_case(ds_gen, m, k, n, sizes, bm, dt)
        gemm.append(compare_gemm(name, args, kw, plan))
        del args
    results["quantize_tilewise"] += check_quantize(
        ds_gen, [(1536, 2048), (12288, 2048), (24, 2048), (2048, 2048)])
    results["act_quantize"] += check_act_quantize(
        ds_gen, [(1536, 1408, "silu_mul"), (12288, 1408, "silu_mul"),
                 (24, 1408, "silu_mul"), (256, 2816, "silu_mul"),
                 (2048, 2816, "silu_mul"), (4, 2816, "silu_mul")])
    results["gmm"] = gemm
    wrows, wsetups = check_wgrad(gen, cpu_gen, routed)
    results.update(wrows)

    # B3's fp8-input mode: the fused-producer path's routed g/u at prefill
    # and in training, the shared experts' in training
    results["act_quantize_fp8"] = check_act_quantize_fp8(
        gen, [(1024, 1408, "silu_mul"), (16384, 1408, "silu_mul"),
              (4096, 5632, "silu_mul"), (16, 1408, "silu_mul"),
              (1024, 1408, "gelu")])
    # B7 at the fused-producer path's gate/up shapes: routed prefill,
    # decode, training (routed and shared), an all-empty plan and a NaN
    # tail in A
    results["gmm_quant"] = check_gemm_quant(gen, {
        "prefill_gate_up": (1024, 2048, 1408, pre, 128, False),
        "decode_gate_up": (16, 2048, 1408, dec, 16, False),
        "shared_decode_gate_up": (4, 2048, 5632,
                                  torch.tensor([4], dtype=torch.int32), 16,
                                  False),
        "train_gate_up": (16384, 2048, 1408, routed, 128, False),
        "train_shared_gate_up": (4096, 2048, 5632, shared, 128, False),
        "all_empty": (256, 256, 256, torch.zeros(4, dtype=torch.int32), 128,
                      False),
        "nan_tail": (1024, 2048, 1408, pre, 128, True),
        # into a NaN-prefilled payload and scales
        **{name: (m, k, n, sizes, bm, False) for name, (m, k, n, sizes, bm, _)
           in spans_cases((torch.bfloat16,)).items()},
    })
    # B5 at the bf16 path's shapes: forward (bf16 out) and dgrad (f32 out)
    dec_routed = drawn["decode"]
    bf16_cases = {
        "prefill_gate": (1024, 2048, 1408, pre, 128, torch.bfloat16),
        "prefill_down": (1024, 1408, 2048, pre, 128, torch.bfloat16),
        "decode_gate": (16, 2048, 1408, dec_routed, 16, torch.bfloat16),
        "decode_down": (16, 1408, 2048, dec_routed, 16, torch.bfloat16),
        "all_empty": (256, 256, 256, torch.zeros(4, dtype=torch.int32), 128,
                      torch.bfloat16),
        "train_gate_up": (16384, 2048, 1408, routed, 128, torch.bfloat16),
        "train_down": (16384, 1408, 2048, routed, 128, torch.bfloat16),
        "train_dgrad_gate_up_f32": (16384, 1408, 2048, routed, 128,
                                    torch.float32),
        "train_dgrad_down_f32": (16384, 2048, 1408, routed, 128,
                                 torch.float32),
        # "_wT": the dgrads as the training path hands them over, w^T read
        # where it lies, K-contiguous (and decode's tile on that layout)
        "train_dgrad_gate_up_f32_wT": (16384, 1408, 2048, routed, 128,
                                       torch.float32),
        "train_dgrad_down_f32_wT": (16384, 2048, 1408, routed, 128,
                                    torch.float32),
        "decode_gate_wT": (16, 2048, 1408, dec_routed, 16, torch.bfloat16),
    }
    # into a NaN-prefilled out, at both output dtypes
    bf16_cases.update(spans_cases((torch.bfloat16, torch.float32)))
    bf16_rows, bf16_setups = [], {}
    keep = [case for case, _ in BF16_TIMED]
    for name, (m, k, n, sizes, bm, dt) in bf16_cases.items():
        bargs, bkw, bplan = bf16_case(gen, m, k, n, sizes, bm, dt,
                                      k_major=name.endswith("_wT"))
        bf16_rows.append(compare_gemm_bf16(name, bargs, bkw, bplan,
                                           nan_out=name.startswith("spans")))
        if name in keep:
            bf16_setups[name] = (bargs, bkw, bplan)
        del bargs
    bargs, bkw, bplan = bf16_setups["prefill_gate"]
    bf16_rows.append(compare_gemm_bf16("prefill_gate_nan_out", bargs, bkw,
                                       bplan, nan_out=True))
    for bm in (24, 64):
        try:
            gk.gmm_bf16_cuda(*bargs, **{**bkw, "block_m": bm, "plan": None})
            raise AssertionError(f"gmm_bf16 accepted block_m={bm}")
        except ValueError:
            pass
    # deterministic: two launches bitwise equal, in either layout of w
    for name in ("prefill_gate", "train_dgrad_gate_up_f32_wT"):
        rargs, rkw, _ = bf16_setups[name]
        repeat_bitwise("gmm_bf16 " + name, gk.gmm_bf16_cuda, rargs, rkw)
    # a w in any other layout is refused, not copied
    x16, w16, bgs = bargs
    wide = torch.empty((w16.shape[0], w16.shape[1], 2 * w16.shape[2]),
                       dtype=torch.bfloat16, device="cuda")
    try:
        gk.gmm_bf16_cuda(x16, wide[:, :, :w16.shape[2]], bgs, **bkw)
        raise AssertionError("gmm_bf16 accepted a w with a row stride of 2N")
    except ValueError:
        pass
    del wide
    # so is an x whose start is not 16-byte aligned (TMA reads it)
    xbuf = torch.empty(x16.numel() + 1, dtype=torch.bfloat16, device="cuda")
    try:
        gk.gmm_bf16_cuda(xbuf[1:].view(x16.shape), w16, bgs, **bkw)
        raise AssertionError("gmm_bf16 accepted an x not 16-byte aligned")
    except ValueError:
        pass
    del xbuf
    results["gmm_bf16"] = bf16_rows
    results["flash_attention"] = check_flash(gen)
    for name, rows in results.items():
        emit({"phase": "kernel", "kernel": name, "checks": rows})
    library = phase_library(setups["prefill_gate"], wsetups,
                            {key: bf16_setups[case]
                             for case, key in BF16_TIMED})

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
    # B3 in both modes at the routed prefill's g/u [1024, 1408] and the
    # training path's [16384, 1408], inputs rotated through HBM, and at
    # the decode step's routed [16, 1408] and shared [4, 5632] g/u, where
    # most of its launches are; there the inputs cycle through 64 copies,
    # from L2, as the GEMM just wrote them on the path; beside them the
    # launch floor
    floor_ms = launch_floor_ms()
    for suffix, m, k, copies in (("", 1024, 1408, None),
                                 ("_decode", 16, 1408, 64),
                                 ("_decode_shared", 4, 5632, 64),
                                 ("_train", 16384, 1408, None)):
        for mode in ("act_quantize", "act_quantize_fp8"):
            timing[mode + suffix] = dict(
                time_act_quantize(gen, m, k, mode.endswith("fp8"), copies),
                launch_floor_ms=floor_ms, max_abs_err=worst[mode])
    # B2 and B7 where the paths run them, weights rotated through HBM
    for key, row in time_gmm_fp8(gen, drawn).items():
        timing[key] = {**row, "max_abs_err":
                       worst["gmm_quant" if key.startswith("gmm_quant")
                             else "gmm"]}
    del setups
    # B5 at the routed prefill (its visited bf16 weights, 300 MB, overflow
    # the L2 alone), at the training path's 16384 routed rows, at decode
    # (~14 visited experts, ~80 MB) and on the K-contiguous w^T of the
    # training dgrad (f32 out)
    for case, key in BF16_TIMED:
        (x16, w16, bgs), bkw, bplan = bf16_setups.pop(case)
        m, k = x16.shape
        n = w16.shape[2]
        rows = int(bplan.total_rows())
        visited = int((bgs > 0).sum())
        out_f32 = bkw["out_dtype"] == torch.float32
        # decode's visited weights would sit partly in the L2:
        # alternate two copies so each call reads them from HBM
        ws = [w16, w16.clone()] if key == "gmm_bf16_decode" else [w16]
        timing[key] = dict(
            shape=[m, k, n], groups=w16.shape[0], total_rows=rows,
            block_m=bkw["block_m"], w_layout="K-contiguous"
            if gk.weight_layout(w16) else "N-contiguous",
            ms=graph_ms(lambda i: gk.gmm_bf16_cuda(x16, ws[i % len(ws)], bgs,
                                                   **bkw), iters=10),
            eager_ms=cuda_ms(lambda i: gk.gmm_bf16_cuda(
                x16, ws[i % len(ws)], bgs, **bkw), iters=10),
            plain_ms=cuda_ms(lambda i: gk.gmm_bf16_plain(x16, w16, bgs,
                                                         **bkw),
                             iters=3, warmup=1),
            bytes=2 * m * k + 2 * visited * k * n + (4 if out_f32 else 2) * m * n,
            flops=2 * rows * k * n, peak_flop_per_s=BF16_FLOP_PER_S,
            max_abs_err=worst["gmm_bf16"])
        del x16, w16, ws
    # the wgrads at the routed gate/up shape: 16384 rows, 60 groups, K 2048,
    # N 1408; each call writes a 346 MB (bf16) or 692 MB (f32) dw, so
    # inputs and output overflow the L2 on every call.  "wgrad": B4 with
    # dw in bf16, as the training path takes it; "wgrad_f32": B4 with f32
    # dw; "wgrad_fp8" / "wgrad_fp8_f32": B6 alike
    for key, fp8, dt in (("wgrad", False, torch.bfloat16),
                         ("wgrad_f32", False, torch.float32),
                         ("wgrad_fp8", True, torch.bfloat16),
                         ("wgrad_fp8_f32", True, torch.float32)):
        (wargs, wplan) = wsetups["wgrad_fp8" if fp8 else "wgrad"]
        x, dy = wargs[0], wargs[-3 if fp8 else 1]
        total = int(wplan.total_rows())
        g = int(wargs[-1].numel())
        k, n = x.shape[1], dy.shape[1]
        cuda = counters()["wgrad_fp8" if fp8 else "wgrad"][0]
        plain = (wk.gmm_wgrad_fp8_plain if fp8 else wk.gmm_wgrad_plain)
        in_bytes = total * (k + n) * (1 if fp8 else 2) + \
            (4 * total * (k + n) // 128 if fp8 else 0)

        def call(i, cuda=cuda, wargs=wargs, wplan=wplan, dt=dt):
            return cuda(*wargs, plan=wplan, out_dtype=dt)
        timing[key] = dict(
            shape=[x.shape[0], k, n], groups=g, total_rows=total,
            out_dtype=str(dt)[6:],
            ms=graph_ms(call, iters=4, replays=3),
            eager_ms=cuda_ms(call, iters=4),
            plain_ms=cuda_ms(lambda i: plain(*wargs, plan=wplan,
                                             out_dtype=dt),
                             iters=3, warmup=1),
            bytes=in_bytes + dt.itemsize * g * k * n,
            flops=2 * total * k * n,
            peak_flop_per_s=FP8_FLOP_PER_S if fp8 else BF16_FLOP_PER_S,
            max_abs_err=worst["wgrad_fp8" if fp8 else "wgrad"])
        if fp8:
            # the design's own limit: the hi and the lo product, both bf16
            timing[key]["hi_lo_ceiling_ms"] = \
                2 * timing[key]["flops"] / BF16_FLOP_PER_S * 1e3
        del wargs
    wsetups.clear()
    timing["flash_attention"], library["flash_attention"] = time_flash(
        gen, worst["flash_attention"])
    for name, t in timing.items():
        add_bound(t)
        t["library_ms"], t["library_note"] = library.get(
            name, (None, "not timed at this shape"))
        emit({"phase": "kernel_time", "kernel": name, **t})
    return timing


# ---------------------------------------------------------------------------
# phase 4: autotune, the resource model and the plan cache
# ---------------------------------------------------------------------------

# the measured selections: op -> (label, M, K, N, G); the grouped GEMMs at
# the qwen2-moe-a2.7b (60 experts) and deepseek-moe-16b (64) routed
# shapes of a p64 prefill (batch 4) and a decode step, the wgrads at the
# training paths' (batch 8 x seq 512)
AUTOTUNE_SHAPES = {
    "gemm": (("qwen2-moe prefill", 1024, 2048, 1408, 60),
             ("deepseek p64 prefill", 1536, 2048, 1408, 64)),
    "gemm_bf16": (("qwen2-moe prefill", 1024, 2048, 1408, 60),
                  ("deepseek p64 prefill", 1536, 2048, 1408, 64)),
    "gemm_quant": (("qwen2-moe prefill", 1024, 2048, 1408, 60),
                   ("deepseek p64 prefill", 1536, 2048, 1408, 64)),
    "decode": (("qwen2-moe decode", 16, 2048, 1408, 60),
               ("deepseek decode", 24, 2048, 1408, 64)),
    "wgrad": (("qwen2-moe train", 16384, 2048, 1408, 60),
              ("deepseek train", 24576, 2048, 1408, 64)),
    "wgrad_fp8": (("qwen2-moe train", 16384, 2048, 1408, 60),
                  ("deepseek train", 24576, 2048, 1408, 64)),
}
# B2, B5 and B7 at block_m 16 against 128: name -> (M, K, N, G); the
# qwen2-moe routed prefill and decode, minitron-8b's dense (G = 1) gate
# at a batch-4 decode step
ACROSS_BLOCK_M = {"qwen2-moe prefill": (1024, 2048, 1408, 60),
                  "qwen2-moe decode": (16, 2048, 1408, 60),
                  "minitron-8b decode": (4, 4096, 16384, 1)}


def check_resources() -> list:
    """(a) Every built variant's shared memory in the static model equals
    what its launch asks (each library's ``kernel_resources`` query),
    the launch may ask it, the threads agree, and the registers ptxas
    gave fit one SM at the CTAs an SM the kernel is meant to hold."""
    from repro_torch.kernels import build
    from repro_torch.kernels import resources as res
    rows = []
    for v in res.variants():
        q = build.resources(v["library"], *v["args"])
        ctas = v["ctas_per_sm"] or 1
        fit = res.fits_sm(q["registers"], q["threads"], ctas, q["smem"])
        row = {"phase": "autotune_resources", "kernel": v["kernel"],
               "variant": v["variant"], "model_smem": v["smem"],
               "card": q, "model_threads": v["threads"],
               "model_ctas_per_sm": v["ctas_per_sm"], "fit": fit}
        emit(row)
        rows.append(row)
        if (q["smem"] != v["smem"] or q["max_dynamic_smem"] < q["smem"]
                or q["threads"] != v["threads"] or not fit["fits"]
                or q["ctas_per_sm"] < ctas):
            raise AssertionError(f"resources {v['kernel']} {v['variant']}: "
                                 f"model {v} against the card's {q}, {fit}")
    return rows


def check_across_block_m() -> list:
    """(b) B2, B5 and B7 at block_m 16 against 128 on the same operands:
    B2 and B5 within one bf16 step (the B2 gate), B7's dequantized values
    within one e4m3 step and one bf16 step (its gate); prints whether
    they are bitwise equal."""
    import torch
    from repro_torch.kernels import grouped_gemm_kernel as gk
    from repro_torch.kernels import ref
    from repro_torch.kernels.plan import make_tile_plan
    gen = torch.Generator(device="cuda").manual_seed(11)
    cpu_gen = torch.Generator().manual_seed(12)
    rows = []
    for name, (m, k, n, g) in ACROSS_BLOCK_M.items():
        sizes = (torch.tensor([m], dtype=torch.int32) if g == 1
                 else routed_sizes(cpu_gen, m // 4, 4, g)).cuda()
        a = torch.randn((m, k), generator=gen, device="cuda")
        w = torch.randn((g, k, n), generator=gen, device="cuda") * k ** -0.5
        a8, sa = ref.quantize_tilewise_ref(a)
        b8, sb = ref.quantize_blockwise_ref(w)
        xb, wb = a.bfloat16(), w.bfloat16()
        del a, w
        outs = {}
        for bm in (16, 128):
            plan = make_tile_plan(sizes, m, block_m=bm, num_groups=g)
            kw = dict(num_groups=g, block_m=bm, plan=plan)
            outs[bm] = {
                "gmm": gk.gmm_cuda(a8, sa, b8, sb, sizes, **kw).float(),
                "gmm_bf16": gk.gmm_bf16_cuda(xb, wb, sizes, **kw).float(),
                "gmm_quant": gk.gmm_quant_cuda(a8, sa, b8, sb, sizes, **kw)}
        torch.cuda.synchronize()
        for kernel in ("gmm", "gmm_bf16", "gmm_quant"):
            y16, y128 = outs[16][kernel], outs[128][kernel]
            if kernel == "gmm_quant":
                bitwise = bool(torch.equal(y16[0].view(torch.uint8),
                                           y128[0].view(torch.uint8))
                               and torch.equal(y16[1], y128[1]))
                step = torch.maximum(
                    e4m3_step(y16[0]) * torch.repeat_interleave(y16[1], 128, 1),
                    e4m3_step(y128[0])
                    * torch.repeat_interleave(y128[1], 128, 1))
                y16, y128 = dequant(*y16), dequant(*y128)
            else:
                bitwise = bool(torch.equal(y16, y128))
                step = torch.zeros_like(y128)
            scale = float(y128.abs().max())
            err = (y16 - y128).abs()
            tol = step + y128.abs() * 2.0 ** -7 + 1e-4 * scale + 1e-30
            bad = int((err > tol).sum())
            row = {"phase": "autotune_across_block_m", "case": name,
                   "kernel": kernel, "shape": [m, k, n], "groups": g,
                   "bitwise_equal": bitwise, "max_abs_err": float(err.max()),
                   "rel_to_max": float(err.max()) / scale if scale else 0.0,
                   "beyond_tolerance": bad}
            emit(row)
            rows.append(row)
            if bad or not torch.isfinite(y16).all():
                raise AssertionError(f"{kernel} {name}: block_m 16 and 128 "
                                     f"differ beyond tolerance at {bad} "
                                     "elements, or not finite")
        del outs, a8, sa, b8, sb, xb, wb
    return rows


@contextlib.contextmanager
def counting_measurements():
    """Count ``plan._measure_candidate`` calls (the autotuner's timings)."""
    from repro_torch.kernels import plan as plan_mod
    real, calls = plan_mod._measure_candidate, []

    def count(*a, **kw):
        calls.append(kw.get("op"))
        return real(*a, **kw)
    plan_mod._measure_candidate = count
    try:
        yield calls
    finally:
        plan_mod._measure_candidate = real


def check_autotune() -> list:
    """(c) A measured selection under ``build/`` for every op and shape of
    AUTOTUNE_SHAPES, from an empty cache: each candidate's measured ms
    beside the cost model's prediction; a tiled op's winner measured with
    nothing skipped, a tile-free op's (the wgrads) ranked by the cost
    model with nothing measured; then the same call again, a cache hit
    that measures nothing."""
    from repro_torch.kernels import plan as plan_mod
    path = os.path.join(HERE, "build", "chip_smoke_autotune.json")
    if os.path.exists(path):
        os.remove(path)
    plan_mod.clear_cache_memo()
    rows = []
    for op, shapes in AUTOTUNE_SHAPES.items():
        for label, m, k, n, g in shapes:
            with counting_measurements() as calls:
                t0 = time.perf_counter()
                cfg = plan_mod.autotune(m, k, n, g, op=op, cache_path=path,
                                        device="cuda", max_candidates=4)
                tune_s = time.perf_counter() - t0
                rep = plan_mod.last_autotune_report()
                n_first = len(calls)
                again = plan_mod.autotune(m, k, n, g, op=op, cache_path=path,
                                          device="cuda", max_candidates=4)
                hit = plan_mod.last_autotune_report()
            tile_free = op in plan_mod.TILE_FREE_OPS
            row = {"phase": "autotune", "op": op, "shape": label,
                   "mkng": [m, k, n, g], "key": rep["key"],
                   "selected": cfg.to_dict(), "source": rep["source"],
                   "tile_free": tile_free,
                   "candidates": [{"block_m": c["block_m"],
                                   "block_n": c["block_n"],
                                   "predicted_ms": p * 1e3,
                                   "measured_ms": None if s is None
                                   else s * 1e3}
                                  for c, p, s in rep["candidates"]],
                   "pruned": [{"block_m": c["block_m"],
                               "block_n": c["block_n"],
                               "n_span": c["n_span"], "reason": r}
                              for c, r in rep["pruned"]],
                   "skipped": rep["skipped"], "measurements": n_first,
                   "second_call_cache_hit": hit["cache_hit"],
                   "second_call_measurements": len(calls) - n_first,
                   "seconds": tune_s}
            emit(row)
            rows.append(row)
            want = "cost_model" if tile_free else "measured"
            if (rep["skipped"] or rep["source"] != want
                    or (n_first == 0) != tile_free or again != cfg
                    or not hit["cache_hit"] or len(calls) != n_first):
                raise AssertionError(f"autotune {op} {label}: {row}")
    return rows


def check_padded_host_ops() -> dict:
    """(d) Host-side ops of one padded GEMM at deepseek-moe-16b's p64
    routed shape: the aten ops it dispatches (and its eager ms) with the
    plan cache's replay, against the same call building its plan anew
    (``make_tile_plan``); bitwise the same output."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.core import padding_baseline as pb
    from repro_torch.kernels import plan as plan_mod
    from repro_torch.kernels import ref

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops += 1
            return func(*args, **(kwargs or {}))

    sizes, m, k, n, bm = padded_cases()["ds_prefill_p64"]
    g = sizes.numel()
    gen = torch.Generator(device="cuda").manual_seed(13)
    a8, sa = ref.quantize_tilewise_ref(
        torch.randn((m, k), generator=gen, device="cuda"))
    b8, sb = ref.quantize_blockwise_ref(
        torch.randn((g, k, n), generator=gen, device="cuda") * k ** -0.5)
    gs = sizes.cuda()
    cfg = plan_mod.KernelConfig(block_m=bm)

    def call(i=0):
        return pb.grouped_gemm_fp8_padded(a8, sa, b8, sb, gs, config=cfg)
    out, ops, ms = {}, {}, {}
    real = pb.shared_plan
    for way in ("plan_cache", "fresh_plan"):
        if way == "fresh_plan":
            pb.shared_plan = plan_mod.make_tile_plan
        try:
            out[way] = call()
            with Count() as c:
                call()
            ops[way] = c.ops
            ms[way] = cuda_ms(call, iters=20)
        finally:
            pb.shared_plan = real
    torch.cuda.synchronize()
    row = {"phase": "autotune_padded_host_ops", "case": "ds_prefill_p64",
           "shape": [m, k, n], "groups": g, "aten_ops": ops,
           "launches_per_call": 1, "eager_ms": ms,
           "bitwise_equal": bool(torch.equal(out["plan_cache"],
                                             out["fresh_plan"]))}
    emit(row)
    if not row["bitwise_equal"] or ops["plan_cache"] >= ops["fresh_plan"]:
        raise AssertionError(f"padded host ops: {row}")
    return row


def phase_autotune() -> None:
    """The tuning layer on the card: (a) the resource model against each
    kernel's own query, (b) B2, B5 and B7 across block_m, (c) a measured
    autotune and its cache hit, (d) the padded GEMM's host ops with the
    plan cache.  The serve phase checks the rest: the plan builds of the
    padded deepseek serve, and the MoE tokens of the selected decode
    tiles against the fixed 16-row rule's."""
    check_resources()
    free_memory()
    check_across_block_m()
    free_memory()
    check_autotune()
    free_memory()
    check_padded_host_ops()


# ---------------------------------------------------------------------------
# phase 5: the kernel contract checker on the card
# ---------------------------------------------------------------------------

# the kernels the contracts must launch (B1, B2, B3, B4, B6, B7)
ANALYSIS_KERNELS = ("quantize_tilewise", "gmm", "act_quantize", "wgrad",
                    "wgrad_fp8", "gmm_quant")


def phase_analysis(info: dict) -> None:
    """``repro_torch.analysis`` on the card: (a) the command line's every
    layer in process (``--all --json``: the contracts and the prepare-once
    contracts launch the kernels), a line a layer with its findings; then
    each contract alone, a line with its event counts and the kernels it
    launched; (b) each contract again on the CPU (the plain versions),
    whose event counts must be the card's; (c) the coverage check: the
    padded baseline under ``grouped_linear.fp8.fwd`` reports REPRO-C03.
    Any live finding raises.  The serve phase checks the engine contract
    at full width."""
    import io
    from collections import Counter

    import torch
    from repro_torch.analysis import contracts, events
    from repro_torch.analysis.__main__ import main as analysis_main
    from repro_torch.core import grouped_gemm as gg
    from repro_torch.kernels.plan import KernelConfig
    t0 = time.perf_counter()
    out = io.StringIO()
    reset_counts()
    with contextlib.redirect_stdout(out):
        rc = analysis_main(["--all", "--json"])
    torch.cuda.synchronize()
    report = json.loads(out.getvalue())
    for layer, n in report["layers"].items():
        emit({"phase": "analysis", "layer": layer, "findings": n})
    emit({"phase": "analysis", "cli_exit": rc,
          "live_findings": report["findings"],
          "resources_pruned": report["resources_pruned"],
          "launches": {k: v for k, v in read_counts().items() if v}})
    if rc or report["findings"]:
        raise AssertionError(f"analysis: live findings {report['findings']}")
    launched = Counter()
    for name, c in sorted(contracts.load_registered().items()):
        runs = {}
        for dev in ("cuda", "cpu"):
            reset_counts()
            with events.capture() as evs:
                fs = contracts.run_contract(c, dev)
            if dev == "cuda":
                torch.cuda.synchronize()
            runs[dev] = (dict(Counter(e.kind for e in evs)),
                         {k: v for k, v in read_counts().items() if v},
                         [f.format() for f in fs])
        (card, launches, fs), (cpu, cpu_launches, cpu_fs) = \
            runs["cuda"], runs["cpu"]
        launched.update(launches)
        emit({"phase": "analysis_contract", "contract": name,
              "events": card, "launches": launches, "findings": fs,
              "cpu_events": cpu, "cpu_findings": cpu_fs,
              "events_equal": card == cpu})
        if fs or cpu_fs or card != cpu or cpu_launches:
            raise AssertionError(f"analysis {name}: card {card} {fs}, cpu "
                                 f"{cpu} {cpu_fs} {cpu_launches}")
    missing = [k for k in ANALYSIS_KERNELS if not launched[k]]
    if missing:
        raise AssertionError(f"analysis: the contracts never launched "
                             f"{missing}")
    c = contracts.load_registered()["grouped_linear.fp8.fwd"]
    fn, args = gg._build_linear_fwd(torch.device("cuda"),
                                    KernelConfig(backend="padded_baseline"))
    c03 = [f.message for f in contracts.check_contract(fn, c, *args)
           if f.rule_id == "REPRO-C03"]
    emit({"phase": "analysis_coverage", "contract": c.name,
          "backend": "padded_baseline", "c03": c03})
    if not c03:
        raise AssertionError("analysis: the padded baseline did not fire "
                             "REPRO-C03 on the card")
    emit({"phase": "analysis", "seconds": time.perf_counter() - t0,
          "contract_launches": dict(launched),
          "nvidia_smi": info["nvidia_smi"]})


# ---------------------------------------------------------------------------
# phase 3, continued: the padded baseline against the padding-free GEMM
# ---------------------------------------------------------------------------

def paper_sizes(m, g, seed):
    """The paper's group sizes (its appendix C.1, as the JAX package's
    ``benchmarks/common.py`` draws them): ``g`` random sizes summing to
    ``m``."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    v = rng.integers(0, 2 * (m // g) + 1, g).astype(np.float64)
    if v.sum() == 0:
        v[:] = 1.0
    v = np.floor(v * (m / v.sum())).astype(np.int64)
    v[-1] += m - v.sum()
    return torch.from_numpy(v.astype(np.int32))


def padded_cases() -> dict:
    """name -> (group sizes, M, K, N, block_m): deepseek-moe-16b's routed
    gate GEMM (64 experts, top-6, K 2048, N 1408) at batch 4 x prompt 512
    and 64 and at a decode step (16-row tiles, most groups empty), and
    the paper's scale (``benchmarks/bench_grouped_gemm.py``: "M 8k-64k,
    N/K 3-8k") at M 8192 and 32768, K = N = 4096, G 8 and 32."""
    import torch
    cpu_gen = torch.Generator().manual_seed(6)
    cases = {}
    for name, tokens, bm in (("ds_prefill_p512", 2048, 128),
                             ("ds_prefill_p64", 256, 128),
                             ("ds_decode", 4, 16)):
        cases[name] = (routed_sizes(cpu_gen, tokens, 6, 64), 6 * tokens,
                       2048, 1408, bm)
    for m in (8192, 32768):
        for g in (8, 32):
            cases[f"paper_M{m}_G{g}"] = (paper_sizes(m, g, seed=g), m, 4096,
                                         4096, 128)
    return cases


def peak_bytes(fn) -> int:
    """Device memory that one call of ``fn`` allocates at its peak, over
    what was allocated before it."""
    import torch
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return peak


def phase_padded(full: bool) -> None:
    """The paper's baseline (pad -> B2 -> unpad,
    ``core/padding_baseline.py``) against the padding-free B2 at
    :func:`padded_cases`' shapes.  Gate: every owned row bitwise equal
    (the paper's equivalence claim).  With ``full``: CUDA-graph times,
    inputs rotated through HBM as the kernel table's, of the pad pass,
    the padded plan (the plan cache's replay, as the pipeline plans), the
    padded GEMM, the unpad pass, their sum, the
    whole pipeline in one call, the padding-free plan and GEMM, and the
    GEMM over exactly the padded groups' rows (without the static bound's
    zero-filled tail); the peak memory of one call of each pipeline
    beside the padding's own bytes."""
    import torch
    from repro_torch.core import padding_baseline as pb
    from repro_torch.kernels import grouped_gemm_kernel as gk
    from repro_torch.kernels import ref
    from repro_torch.kernels.plan import KernelConfig, make_tile_plan, \
        shared_plan
    gen = torch.Generator(device="cuda").manual_seed(5)
    for name, (sizes, m, k, n, bm) in padded_cases().items():
        g = sizes.numel()
        gs = sizes.cuda()
        cfg = KernelConfig(block_m=bm)
        kw = dict(num_groups=g, block_m=bm)
        a8, sa = ref.quantize_tilewise_ref(
            torch.randn((m, k), generator=gen, device="cuda"))
        b8, sb = ref.quantize_blockwise_ref(
            torch.randn((g, k, n), generator=gen, device="cuda") * k ** -0.5)
        free_plan = make_tile_plan(gs, m, block_m=bm, num_groups=g)
        y_free = gk.gmm_cuda(a8, sa, b8, sb, gs, plan=free_plan, **kw)
        y_pad = pb.grouped_gemm_fp8_padded(a8, sa, b8, sb, gs, config=cfg)
        torch.cuda.synchronize()
        total = int(sizes.sum())
        differ = int((y_free[:total] != y_pad[:total]).any(dim=1).sum())
        finite = bool(torch.isfinite(y_free[:total].float()).all())
        del y_free, y_pad
        psz = (sizes + bm - 1) // bm * bm
        owned = int(psz.sum())
        padded_m = pb.default_padded_m(m, g, bm)
        # tile visits that run a product: padding-free, one for each group
        # owning rows in a tile; padded, one a padded tile (the static
        # bound's tail tiles are only zero-filled)
        ends = torch.cumsum(sizes.long(), 0)
        spans = (ends + bm - 1) // bm - (ends - sizes) // bm
        row = {"phase": "padded", "case": name, "shape": [m, k, n],
               "groups": g, "empty_groups": int((sizes == 0).sum()),
               "block_m": bm, "rows": total, "padded_m": padded_m,
               "padded_group_rows": owned, "rows_differing": differ,
               "product_visits": {
                   "padding_free": int(spans[sizes > 0].sum()),
                   "padded": owned // bm,
                   "padded_tail_tiles": (padded_m - owned) // bm},
               "overhead": pb.padding_overhead_bytes(sizes, k, k // 128,
                                                     block_m=bm),
               "c_pad_bytes": (owned - total) * n * 2}
        if full:
            row["peak_bytes"] = {
                "padded": peak_bytes(lambda: pb.grouped_gemm_fp8_padded(
                    a8, sa, b8, sb, gs, config=cfg)),
                "padding_free": peak_bytes(lambda: gk.gmm_cuda(
                    a8, sa, b8, sb, gs, **kw))}
            nbytes = m * k + 4 * m * (k // 128) + \
                g * (k * n + 4 * (k // 128) * (n // 128))
            cps = rotation(lambda: (a8.clone(), sa.clone(), b8.clone(),
                                    sb.clone()), nbytes)
            nc = len(cps)
            iters = nc * -(-10 // nc)
            pads = [pb.pad_groups(c[0], c[1], gs, block_m=bm) for c in cps]
            p_sz = pads[0][2]
            pplan = make_tile_plan(p_sz, padded_m, block_m=bm, num_groups=g)
            exact = make_tile_plan(p_sz, owned, block_m=bm, num_groups=g)
            outs = [gk.gmm_cuda(p[0], p[1], c[2], c[3], p_sz, plan=pplan,
                                **kw) for p, c in zip(pads, cps)]
            ms = {
                "pad": graph_ms(lambda i: pb.pad_groups(
                    cps[i % nc][0], cps[i % nc][1], gs, block_m=bm),
                    iters=iters),
                "padded_plan": graph_ms(lambda i: shared_plan(
                    p_sz, padded_m, block_m=bm, num_groups=g), iters=iters),
                "gemm_padded": graph_ms(lambda i: gk.gmm_cuda(
                    pads[i % nc][0], pads[i % nc][1], cps[i % nc][2],
                    cps[i % nc][3], p_sz, plan=pplan, **kw), iters=iters),
                "unpad": graph_ms(lambda i: pb.unpad_groups(
                    outs[i % nc], pads[i % nc][3]), iters=iters),
                "pipeline": graph_ms(lambda i: pb.grouped_gemm_fp8_padded(
                    *cps[i % nc], gs, config=cfg), iters=iters),
                "padding_free_plan": graph_ms(lambda i: make_tile_plan(
                    gs, m, block_m=bm, num_groups=g), iters=iters),
                "gemm_padding_free": graph_ms(lambda i: gk.gmm_cuda(
                    *cps[i % nc], gs, plan=free_plan, **kw), iters=iters),
                "gemm_padded_group_rows": graph_ms(lambda i: gk.gmm_cuda(
                    pads[i % nc][0][:owned], pads[i % nc][1][:owned],
                    cps[i % nc][2], cps[i % nc][3], p_sz, plan=exact, **kw),
                    iters=iters)}
            ms["pad_plan_gemm_unpad_sum"] = (ms["pad"] + ms["padded_plan"]
                                             + ms["gemm_padded"] + ms["unpad"])
            row.update(input_copies=nc, ms=ms)
            del cps, pads, outs
        emit(row)
        del a8, sa, b8, sb
        if differ or not finite:
            raise AssertionError(f"padded {name}: {differ} owned rows differ "
                                 "from the padding-free GEMM's, or the "
                                 "output is not finite")
        free_memory()


# ---------------------------------------------------------------------------
# phases 6 and 7: the model
# ---------------------------------------------------------------------------

def phase_forward(variant: str):
    """Full widths, 2 layers: prefill logits through the kernels against
    the same forward through the plain versions, on the card.  Prompt 64,
    or 128 for the flash configurations (flash needs S % 128 == 0); these
    also hold layer 0's attention output (whose input no kernel has
    touched yet) through B8 against its plain version.  The weights and
    tokens come from fixed seeds, so configurations of one model share
    them.  Returns the logits through the kernels."""
    import torch
    from repro_torch.models.model_zoo import make_model, synthetic_batch
    cfg = variant_config(variant, num_layers=2)
    flash = cfg.attn_backend == "flash"
    prompt = 128 if flash else 64
    model = make_model(cfg, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    params = model.init_params(gen)
    batch = synthetic_batch(gen, cfg, prompt, 4)
    def kernels_vs_plain(m):
        """Prefill logits of ``m`` through the kernels and through the
        plain versions, and the kernels' launch counts."""
        with torch.inference_mode():
            reset_counts()
            lk, _ = m.prefill(params, batch, cache_capacity=prompt + 16)
            torch.cuda.synchronize()
            counts = read_counts()
            with plain_kernels():
                lp, _ = m.prefill(params, batch, cache_capacity=prompt + 16)
            torch.cuda.synchronize()
        if read_counts() != counts:
            raise AssertionError("the plain forward launched a kernel")
        return lk.float(), lp.float(), counts

    with flash_outputs() as attn_out:
        lk, lp, counts = kernels_vs_plain(model)
    chunked_rel = None
    if flash and cfg.precision == "fp8":
        # the same model and tokens with chunked attention: how far the
        # fp8 recipe alone moves the logits at this prompt
        lck, lcp, _ = kernels_vs_plain(make_model(dataclasses.replace(
            cfg, attn_backend="chunked"), "cuda"))
        chunked_rel = float((lck - lcp).abs().max() / lcp.abs().max())
    expect = serve_expected(variant, kernel_layers(cfg), prompt, 1)
    if not torch.isfinite(lk).all():
        raise AssertionError("non-finite logits through the kernels")
    rel = float((lk - lp).abs().max() / lp.abs().max())
    # the quantizers and B7 are bitwise, act_quant within one e4m3 step and
    # the GEMMs and flash attention within one bf16 step; through 2 layers
    # and the bf16 residual stream that stays a few bf16 steps of the
    # largest logit at prompt 64.  At prompt 128 the fp8 recipe turns
    # those bf16 ulps into whole e4m3 steps on more rows, and its logits
    # move further whatever the attention (its GEMM kernels alone, with
    # chunked attention, sit 1.4-3.7% of the largest logit from the plain
    # versions at two seeds on the H100): the fp8 flash configuration is
    # held at 10%, as the CPU tests hold the fp8 whole model, and B8 at
    # one bf16 step in layer 0 below
    bound = 0.1 if flash and cfg.precision == "fp8" else 2e-2
    rec = {"phase": "forward", "config": variant, "arch": cfg.name,
           "layers": 2, "batch": 4, "prompt": prompt,
           "logits_shape": list(lk.shape), "rel_to_max_err": rel,
           "bound": bound, "launches": counts, "expected_launches": expect}
    if flash:
        # layer 0's attention: the same inputs in both runs
        a_k, a_p = attn_out[0], attn_out[cfg.num_layers]
        err = (a_k - a_p).abs()
        rec.update(layer0_attention_max_abs_err=float(err.max()),
                   layer0_attention_rel_to_max=float(err.max()
                                                     / a_p.abs().max()),
                   layer0_attention_beyond_bf16_step=int(
                       (err > flash_tol(a_p)).sum()),
                   chunked_rel_to_max_err=chunked_rel)
    emit(rec)
    if counts != expect:
        raise AssertionError(f"forward {variant}: launch counts {counts} != "
                             f"expected {expect}")
    if rel > bound:
        raise AssertionError(f"{variant}: kernel vs plain logits rel-to-max "
                             f"{rel} > {bound}")
    if flash and rec["layer0_attention_beyond_bf16_step"]:
        raise AssertionError(f"{variant}: layer 0's flash attention is "
                             "beyond one bf16 step of its plain version")
    del params, model
    return lk


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
    by_category = {}
    for ms, _, key in rows:
        cat = next((c for c, marks in KERNEL_CATEGORIES
                    if any(m in key for m in marks)), "other PyTorch kernels")
        by_category[cat] = by_category.get(cat, 0.0) + ms
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "busy_share": device_ms / wall_ms if wall_ms else None,
            "by_category": by_category,
            "top": [{"name": k[:80], "ms": ms, "calls": c}
                    for ms, c, k in rows[:top]]}


def path_name(base: str, variant: str) -> str:
    return base if variant == "fp8" else f"{base}_{variant}"


def selecting_engine(model, params, batch, new: int):
    """An Engine with no tile configs (the decode selection, checked:
    exactly one ``decode_select`` for an MoE model, none for a dense one)
    and an Engine pinned to the fixed rule decode ran before it (the
    model's config with 16-row tiles).  One generate of the pinned one
    is the warm-up; returns ``(engine, pinned, its tokens)``."""
    import torch
    from repro_torch.analysis import events
    from repro_torch.kernels.plan import KernelConfig
    from repro_torch.serve.engine import Engine
    cfg = model.cfg
    fixed_cfg = (cfg.resolved_kernel_config or KernelConfig()).with_(
        block_m=16)
    with events.capture() as evs:
        engine = Engine(model, params, max_new_tokens=new)
    selects = events.count(evs, "decode_select")
    if cfg.moe is not None and (selects != 1
                                or engine.decode_config != fixed_cfg):
        raise AssertionError(f"{cfg.name}: {selects} decode selections, "
                             f"decode config {engine.decode_config}")
    if cfg.moe is None and (selects or engine.decode_config is not None):
        raise AssertionError(f"{cfg.name}: a dense model selected decode "
                             f"tiles {engine.decode_config}")
    fixed = Engine(model, params, max_new_tokens=new,
                   decode_kernel_config=fixed_cfg)
    tokens = fixed.generate(batch).tokens                  # warm-up
    torch.cuda.synchronize()
    return engine, fixed, tokens


def decode_block_m(engine) -> int:
    """The M tile an engine's decode steps run."""
    from repro_torch.kernels.plan import get_default_config
    cfg = (engine.decode_config or engine.model.cfg.resolved_kernel_config
           or get_default_config())
    return cfg.block_m


@contextlib.contextmanager
def counting_padded_gemms():
    """Collect one entry per padded GEMM call."""
    from repro_torch.core import padding_baseline as pb
    real, calls = pb.grouped_gemm_fp8_padded, []

    def count(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    pb.grouped_gemm_fp8_padded = count
    try:
        yield calls
    finally:
        pb.grouped_gemm_fp8_padded = real


def serve_run(variant: str, params, batch, new: int, path: str, *,
              sync_check: bool = False, contract=None):
    """One configuration serving ``batch`` on ``params``: a warm-up
    generate (through an engine pinned to the fixed 16-row decode rule,
    :func:`selecting_engine`), a timed one through the engine's own
    decode selection with its launch counts asserted (an MoE model's
    tokens bitwise the fixed rule's; under the padded baseline no plan
    built after the warm-up, :data:`PLAN_CACHE` having built each static
    padded shape once), a timed prefill, a profile of a prefill and of a
    decode step (a dense model's also on the fixed rule's tiles); with
    ``sync_check`` one more generate under
    ``torch.cuda.set_sync_debug_mode("error")``, which raises at any call
    that waits for the device.  With ``contract`` (the engine contract
    scaled to the model), the timed generate and the construction of its
    engine run inside ``check_contract``, whose findings raise.  Returns
    the launch counts and the generated tokens."""
    import torch
    from repro_torch.analysis import events
    from repro_torch.analysis.contracts import check_contract
    from repro_torch.serve.engine import Engine
    from repro_torch.core import quantization as q
    from repro_torch.kernels.plan import PADDED_BASELINE, PLAN_CACHE
    from repro_torch.models.model_zoo import make_model
    t_variant = time.perf_counter()
    batch_size, prompt = batch["tokens"].shape
    cfg = variant_config(variant)
    model = make_model(cfg, "cuda")
    padded = cfg.gemm_backend == PADDED_BASELINE
    if padded:
        # the padded GEMMs plan through the plan cache: from empty, each
        # static padded shape builds once, in the warm-up
        PLAN_CACHE.clear()
    # no tile configs given: prefill runs the model's config; an MoE
    # model's decode the decode pool's selection (16-row tiles, the
    # model's fuse_producer and backend), a dense model's the model's;
    # the warm-up runs the fixed 16-row rule's engine, whose tokens the
    # selection must give bit for bit on an MoE model
    engine, fixed, fixed_tokens = selecting_engine(model, params, batch, new)
    builds = PLAN_CACHE.builds
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()

    timed = {}

    def timed_generate():
        nonlocal engine
        if contract is not None:
            # the contract counts this engine's decode selection too
            engine = Engine(model, params, max_new_tokens=new)
        t0 = time.perf_counter()
        timed["res"] = engine.generate(batch)
        torch.cuda.synchronize()
        timed["gen_s"] = time.perf_counter() - t0
        return engine, timed["res"]

    findings = None
    with events.capture() as evs, counting_padded_gemms() as padded_calls:
        if contract is None:
            timed_generate()
        else:
            findings = [f.format() for f in
                        check_contract(timed_generate, contract)]
    res, gen_s = timed["res"], timed["gen_s"]
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    plan_builds = {"warm_up": builds,
                   "timed_generate": PLAN_CACHE.builds - builds,
                   "timed_generate_events": events.count(evs, "plan_build"),
                   "timed_padded_gemms": len(padded_calls)} \
        if padded else None
    if sync_check:
        torch.cuda.set_sync_debug_mode("error")
        try:
            engine.generate(batch)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    wq_layer_ms = None
    with torch.inference_mode():
        t0 = time.perf_counter()
        last, _ = engine.prefill(batch, prompt + new)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        if cfg.precision == "fp8":
            # the per-call blockwise weight quantization of one forward
            lp = next(lay["moe"] for lay in params["layers"] if "moe" in lay)

            def quant_weights():
                for key in ("w_gate", "w_up", "w_down", "shared_gate",
                            "shared_up", "shared_down"):
                    w = lp[key]
                    q.quantize_blockwise_batched(w if w.dim() == 3
                                                 else w[None])
            wq_layer_ms = cuda_ms(lambda i: quant_weights(), iters=5,
                                  warmup=1)
        _, cache = engine.prefill(batch, prompt + new)
        tok = res.tokens[:, 0]
        prof = {"prefill": profile_breakdown(
                    lambda: engine.prefill(batch, prompt + new)),
                "decode_step": profile_breakdown(
                    lambda: engine.decode_step(tok, cache))}
        if cfg.moe is None:
            # the same step on the fixed rule's 16-row tiles
            prof["decode_step_block_m16"] = profile_breakdown(
                lambda: fixed.decode_step(tok, cache))
    expect = serve_expected(variant, kernel_layers(cfg), prompt, new)
    toks = res.tokens
    ok_tokens = (tuple(toks.shape) == (batch_size, new)
                 and int(toks.min()) >= 0
                 and int(toks.max()) < cfg.vocab_size)
    emit({"phase": "serve", "config": variant, "path": path,
          "arch": cfg.name, "layers": cfg.num_layers,
          "params": cfg.param_count(), "precision": cfg.precision,
          "fuse_producer": variant == "fp8_fused",
          "attn_backend": cfg.attn_backend,
          "batch": batch_size, "prompt": prompt, "max_new_tokens": new,
          "generate_ms": gen_s * 1e3,
          "prefill_ms": prefill_s * 1e3,
          "decode_ms_per_step": (gen_s - prefill_s) * 1e3 / (new - 1),
          "tok_per_s": batch_size * new / gen_s,
          "gemm_backend": cfg.gemm_backend,
          "decode_block_m": decode_block_m(engine),
          "decode_selected": engine.decode_config is not None,
          "tokens_equal_fixed_block_m16": torch.equal(res.tokens,
                                                      fixed_tokens),
          "plan_builds": plan_builds,
          "plan_build_events": events.count(evs, "plan_build"),
          "contract": None if contract is None else contract.name,
          "contract_findings": findings,
          "weight_quant_ms_per_forward": None if wq_layer_ms is None
          else wq_layer_ms * kernel_layers(cfg),
          "max_memory_allocated_gb": peak / 1e9,
          "launches": counts, "expected_launches": expect,
          "tokens_ok": ok_tokens, "sample": toks[0].tolist(),
          "sync_debug_generate_ok": True if sync_check else None,
          "seconds": time.perf_counter() - t_variant})
    for name, br in prof.items():
        emit({"phase": "profile", "config": variant, "path": path,
              "of": name, **br})
    if counts != expect:
        raise AssertionError(f"serve {path}: launch counts {counts} "
                             f"!= expected {expect}")
    if findings:
        raise AssertionError(f"serve {path}: {contract.name}: {findings}")
    if not ok_tokens or not torch.isfinite(last.float()).all():
        raise AssertionError(f"serve {path} produced malformed tokens "
                             "or logits")
    if cfg.moe is not None and not torch.equal(res.tokens, fixed_tokens):
        raise AssertionError(f"serve {path}: the selected decode tiles' "
                             "tokens differ from the fixed rule's")
    if padded and (plan_builds["timed_generate"]
                   or plan_builds["timed_generate_events"]
                   or not 0 < builds <= plan_builds["timed_padded_gemms"]):
        raise AssertionError(f"serve {path}: plan builds {plan_builds}")
    del engine, fixed, model, cache
    return counts, toks


def phase_serve():
    """Batch 4, 16 new tokens, greedy.  The full 24-layer qwen2-moe-a2.7b,
    one param tree: each MoE configuration at prompt 64, then ``fp8`` and
    ``fp8_flash`` at prompt 512 (attention the only difference); then the
    full 28-layer qwen3-1.7b in ``qwen3_flash`` at prompt 512; then the
    full 28-layer deepseek-moe-16b, one param tree, at prompt 64 and 512
    in ``ds_fp8`` and ``ds_fp8_padded``, whose tokens must be equal (the
    baseline is bitwise the padding-free GEMM).  Returns each run's launch
    counts by path name."""
    import torch
    from repro_torch.models.model_zoo import make_model, synthetic_batch
    from repro_torch.serve.engine import decode_plan_contract
    batch_size, new = 4, 16
    paths = {}
    for arch_variant, runs in (
            ("fp8", ((64, ("fp8", "fp8_fused", "bf16")),
                     (512, ("fp8", "fp8_flash")))),
            ("qwen3_flash", ((512, ("qwen3_flash",)),)),
            ("ds_fp8", ((64, DS_VARIANTS), (512, DS_VARIANTS)))):
        free_memory()
        cfg = variant_config(arch_variant)
        gen = torch.Generator(device="cuda").manual_seed(0)
        t0 = time.perf_counter()
        params = make_model(cfg, "cuda").init_params(gen)
        torch.cuda.synchronize()
        emit({"phase": "serve_init", "arch": cfg.name,
              "layers": cfg.num_layers, "params": cfg.param_count(),
              "init_s": time.perf_counter() - t0})
        for prompt, variants in runs:
            batch = synthetic_batch(gen, cfg, prompt, batch_size)
            tokens = {}
            for variant in variants:
                path = path_name("serve", variant)
                if prompt != 64 and variant in ("fp8", *DS_VARIANTS):
                    path = path_name(f"serve_p{prompt}", variant)
                paths[path], tokens[variant] = serve_run(
                    variant, params, batch, new, path,
                    sync_check=variant == "ds_fp8_padded" and prompt == 64,
                    contract=decode_plan_contract(
                        moe_layers=kernel_layers(cfg), batch=batch_size,
                        new=new) if path == "serve" else None)
            if set(DS_VARIANTS) <= set(tokens):
                same = torch.equal(*(tokens[v] for v in DS_VARIANTS))
                emit({"phase": "serve_padded_vs_padding_free",
                      "prompt": prompt, "tokens_equal": same})
                if not same:
                    raise AssertionError(f"serve p{prompt}: the padded "
                                         "baseline's tokens differ")
        del params
    return paths


# ---------------------------------------------------------------------------
# the zoo: every other architecture of the JAX package at full width
# ---------------------------------------------------------------------------

# recipe -> (arch, ModelConfig fields replaced); fp8 wherever the model has
# an MLP, flash where the model's prefill reaches it (no window, S % 128
# == 0); xlstm-350m has no MLP, so it runs bf16 and launches no kernel
ZOO = {
    "rg_fp8": ("recurrentgemma-2b", {"precision": "fp8"}),
    "xlstm_bf16": ("xlstm-350m", {}),
    "whisper_fp8_flash": ("whisper-tiny", {"precision": "fp8", **FLASH}),
    "pixtral_fp8_flash": ("pixtral-12b", {"precision": "fp8", **FLASH}),
    "yi_fp8_flash": ("yi-9b", {"precision": "fp8", **FLASH}),
    "minitron_fp8": ("minitron-8b", {"precision": "fp8"}),
    "qwen110_fp8": ("qwen1.5-110b", {"precision": "fp8"}),
}
# forward phase: depth (one cycle of the hybrid and ssm patterns; whisper
# whole) and prompt; > 2048 (the window) for recurrentgemma-2b, 128 for
# the flash recipes (pixtral's 128 tokens follow its 256 patches: 384
# positions), a multiple of 256 for xlstm (its mLSTM chunks)
ZOO_FORWARD = {"rg_fp8": (3, 2304), "xlstm_bf16": (6, 512),
               "whisper_fp8_flash": (None, 128),
               "pixtral_fp8_flash": (2, 128), "yi_fp8_flash": (2, 128),
               "minitron_fp8": (2, 64), "qwen110_fp8": (2, 64)}
# serve phase: batch, prompt (tokens; pixtral adds 256 patches), depth
# (None: every layer; qwen1.5-110b's 80 layers are ~222 GB in bf16, cut
# to 4)
ZOO_SERVE = {"yi_fp8_flash": (4, 512, None), "minitron_fp8": (4, 64, None),
             "qwen110_fp8": (4, 64, 4), "pixtral_fp8_flash": (4, 128, None),
             "rg_fp8": (2, 2304, None), "xlstm_bf16": (4, 512, None),
             "whisper_fp8_flash": (4, 128, None)}
# launches of one fp8 MLP per forward: SwiGLU quantizes x for the gate and
# the up GEMM, then the fused activation quantizer feeds the down GEMM;
# GELU (whisper) has no gate
MLP_LAUNCHES = {"swiglu": {"quantize_tilewise": 2, "act_quantize": 1,
                           "gmm": 3},
                "gelu": {"quantize_tilewise": 1, "act_quantize": 1,
                         "gmm": 2}}


def zoo_config(variant: str, **kw):
    from repro_torch.configs import get_config
    arch, repl = ZOO[variant]
    return dataclasses.replace(get_config(arch), **repl, **kw)


def zoo_expected(cfg, prompt: int, new: int) -> dict:
    """Launch counts of a prefill of ``prompt`` tokens and ``new - 1``
    decode steps: one fp8 MLP per layer per forward (whisper: its encoder
    layers in the prefill alone, its decoder layers in every forward),
    flash attention once per non-windowed attention layer of the prefill
    where the positions (a VLM's patches included) are a multiple of
    128."""
    from repro_torch.models.transformer import layer_kinds
    out = dict.fromkeys(SOURCES, 0)
    audio = cfg.family == "audio"
    if cfg.precision == "fp8" and (cfg.d_ff or audio):
        mlps = (cfg.encoder_layers + cfg.num_layers * new if audio
                else cfg.num_layers * new)
        for name, n in MLP_LAUNCHES["gelu" if audio else "swiglu"].items():
            out[name] = n * mlps
    positions = prompt + (cfg.num_patches if cfg.family == "vlm" else 0)
    if cfg.attn_backend == "flash" and positions % 128 == 0 \
            and cfg.window is None:
        out["flash_attention"] = cfg.num_layers if audio else sum(
            k == "attn" for k in layer_kinds(cfg))
    return out


@contextlib.contextmanager
def act_modes():
    """Collect the activation of every fused activation-quantizer call."""
    from repro_torch.kernels import epilogue_kernel as ek
    real, seen = ek.act_quantize, []

    def keep(g, u=None, **kw):
        seen.append(kw.get("act", "silu_mul"))
        return real(g, u, **kw)
    ek.act_quantize = keep
    try:
        yield seen
    finally:
        ek.act_quantize = real


def phase_zoo_forward(variant: str):
    """Full width, cut as ``ZOO_FORWARD`` says, batch 4: prefill logits
    through the kernels against the plain versions on the card, at the
    bounds of the forward phase (2e-2 of the largest logit; 10% for an
    fp8 recipe with flash attention, with flash attention's layer-0
    output within one bf16 step of its plain version), launch counts
    exact, and which activations the fused quantizer ran."""
    import torch
    from repro_torch.models.model_zoo import make_model, synthetic_batch
    layers, prompt = ZOO_FORWARD[variant]
    cfg = zoo_config(variant, **({} if layers is None
                                 else {"num_layers": layers}))
    flash = cfg.attn_backend == "flash"
    model = make_model(cfg, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    params = model.init_params(gen)
    batch = synthetic_batch(gen, cfg, prompt, 4)
    cap = prompt + 16 + (cfg.num_patches if cfg.family == "vlm" else 0)
    with torch.inference_mode(), flash_outputs() as attn_out, \
            act_modes() as acts:
        reset_counts()
        lk, _ = model.prefill(params, batch, cache_capacity=cap)
        torch.cuda.synchronize()
        counts = read_counts()
        with plain_kernels():
            lp, _ = model.prefill(params, batch, cache_capacity=cap)
        torch.cuda.synchronize()
    if read_counts() != counts:
        raise AssertionError("the plain forward launched a kernel")
    lk, lp = lk.float(), lp.float()
    expect = zoo_expected(cfg, prompt, 1)
    rel = float((lk - lp).abs().max() / lp.abs().max())
    bound = 0.1 if flash and cfg.precision == "fp8" else 2e-2
    rec = {"phase": "forward", "config": variant, "arch": cfg.name,
           "layers": cfg.num_layers, "batch": 4, "prompt": prompt,
           "logits_shape": list(lk.shape), "rel_to_max_err": rel,
           "bound": bound, "launches": counts, "expected_launches": expect,
           "act_modes": sorted(set(acts))}
    n_flash = expect["flash_attention"]
    if n_flash:
        a_k, a_p = attn_out[0], attn_out[n_flash]
        err = (a_k - a_p).abs()
        rec.update(layer0_attention_rel_to_max=float(err.max()
                                                     / a_p.abs().max()),
                   layer0_attention_beyond_bf16_step=int(
                       (err > flash_tol(a_p)).sum()))
    emit(rec)
    if counts != expect:
        raise AssertionError(f"forward {variant}: launch counts {counts} != "
                             f"expected {expect}")
    if not torch.isfinite(lk).all() or rel > bound:
        raise AssertionError(f"{variant}: kernel vs plain logits rel-to-max "
                             f"{rel} > {bound}, or not finite")
    if n_flash and rec["layer0_attention_beyond_bf16_step"]:
        raise AssertionError(f"{variant}: layer 0's flash attention is "
                             "beyond one bf16 step of its plain version")
    if cfg.family == "audio" and rec["act_modes"] != ["gelu"]:
        raise AssertionError(f"{variant}: the MLPs ran {rec['act_modes']}")


def phase_zoo_serve(variant: str) -> dict:
    """Batch, prompt and depth as ``ZOO_SERVE`` says, 16 new tokens,
    greedy, seeded weights: a warm-up generate through an engine pinned
    to the fixed 16-row decode rule, a timed one through the engine's own
    config (a dense model decodes on the model's 128-row tiles; launch
    counts asserted, peak memory, whether the tokens equal the fixed
    rule's), a timed prefill, a profile of a prefill and of a decode step
    on each engine's tiles.  Returns the launch counts."""
    import torch
    from repro_torch.models.model_zoo import make_model, synthetic_batch
    batch_size, prompt, layers = ZOO_SERVE[variant]
    new = 16
    cfg = zoo_config(variant, **({} if layers is None
                                 else {"num_layers": layers}))
    free_memory()
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    model = make_model(cfg, "cuda")
    params = model.init_params(gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = synthetic_batch(gen, cfg, prompt, batch_size)
    engine, fixed, fixed_tokens = selecting_engine(model, params, batch, new)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res = engine.generate(batch)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    extra = cfg.num_patches if cfg.family == "vlm" else 0
    with torch.inference_mode():
        t0 = time.perf_counter()
        last, cache = engine.prefill(batch, prompt + extra + new)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        tok = res.tokens[:, 0]
        prof = {"prefill": profile_breakdown(
                    lambda: engine.prefill(batch, prompt + extra + new)),
                "decode_step": profile_breakdown(
                    lambda: engine.decode_step(tok, cache)),
                # the same step on the fixed rule's 16-row tiles
                "decode_step_block_m16": profile_breakdown(
                    lambda: fixed.decode_step(tok, cache))}
    expect = zoo_expected(cfg, prompt, new)
    toks = res.tokens
    ok_tokens = (tuple(toks.shape) == (batch_size, new)
                 and int(toks.min()) >= 0
                 and int(toks.max()) < cfg.vocab_size)
    emit({"phase": "serve", "config": variant, "path": f"serve_{variant}",
          "arch": cfg.name, "layers": cfg.num_layers,
          "params": cfg.param_count(), "precision": cfg.precision,
          "attn_backend": cfg.attn_backend, "batch": batch_size,
          "prompt": prompt, "patches": extra, "max_new_tokens": new,
          "init_s": init_s, "generate_ms": gen_s * 1e3,
          "prefill_ms": prefill_s * 1e3,
          "decode_ms_per_step": (gen_s - prefill_s) * 1e3 / (new - 1),
          "tok_per_s": batch_size * new / gen_s,
          "max_memory_allocated_gb": peak / 1e9,
          "decode_block_m": decode_block_m(engine),
          "tokens_equal_fixed_block_m16": torch.equal(toks, fixed_tokens),
          "launches": counts, "expected_launches": expect,
          "tokens_ok": ok_tokens, "sample": toks[0].tolist()})
    for name, br in prof.items():
        emit({"phase": "profile", "config": variant,
              "path": f"serve_{variant}", "of": name, **br})
    if counts != expect:
        raise AssertionError(f"serve {variant}: launch counts {counts} "
                             f"!= expected {expect}")
    if not ok_tokens or not torch.isfinite(last.float()).all():
        raise AssertionError(f"serve {variant} produced malformed tokens "
                             "or logits")
    del engine, fixed, model, params, cache
    return counts


def phase_window_gate() -> None:
    """recurrentgemma-2b at full width, one cycle, bf16 (no kernel), batch
    2: decoding position t + 1 after a prefill of t = 2304 > 2048 (the
    window; the attention layer's cache is the ring) gives the logits of
    a prefill of t + 1, within 2e-2 of the largest logit (the reference's
    own consistency test allows 0.15 absolute), every row's argmax
    equal."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import make_model, synthetic_batch
    cfg = dataclasses.replace(get_config("recurrentgemma-2b"), num_layers=3)
    model = make_model(cfg, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    params = model.init_params(gen)
    t = 2304
    toks = synthetic_batch(gen, cfg, t + 1, 2)["tokens"]
    with torch.inference_mode():
        full, _ = model.prefill(params, {"tokens": toks}, cache_capacity=t + 1)
        _, cache = model.prefill(params, {"tokens": toks[:, :t]},
                                 cache_capacity=t + 1)
        ring = [c["k"].shape[1] for c in cache["layers"] if "k" in c]
        step, _ = model.decode_step(params, toks[:, t:], cache)
    a, b = full[:, -1].float(), step[:, 0].float()
    rel = float((a - b).abs().max() / a.abs().max())
    same = bool(torch.equal(a.argmax(-1), b.argmax(-1)))
    emit({"phase": "window_gate", "arch": cfg.name, "layers": 3,
          "prefill": t, "window": cfg.window, "cache_slots": ring,
          "rel_to_max_err": rel, "bound": 2e-2, "argmax_equal": same})
    if ring != [cfg.window] or rel > 2e-2 or not same:
        raise AssertionError(f"window gate: slots {ring}, rel {rel}, argmax "
                             f"equal {same}")


def free_memory() -> None:
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def phase_train_parity(variant: str):
    """Full widths, 2 layers, batch 2, seq 256: the loss and gradients of
    one train step (what the optimizer would take, with the global norm it
    would clip by) through the kernels against the plain versions, on one
    set of weights, on the card.  Returns the loss and gradients through
    the kernels."""
    import torch
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.model_zoo import make_model
    from repro_torch.optim.adamw import global_norm
    from repro_torch.train.trainer import value_and_grad
    cfg = variant_config(variant, num_layers=2)
    model = make_model(cfg, "cuda")
    params = model.init_params(torch.Generator(device="cuda").manual_seed(4))
    batch = SyntheticLM(DataConfig(seed=1, batch_size=2, seq_len=256), cfg,
                        device="cuda").batch_at(0)
    reset_counts()
    (loss_k, _), grads_k = value_and_grad(model.loss, params, batch)
    torch.cuda.synchronize()
    counts = read_counts()
    with plain_kernels():
        (loss_p, _), grads_p = value_and_grad(model.loss, params, batch)
    torch.cuda.synchronize()
    if read_counts() != counts:
        raise AssertionError("the plain train step launched a kernel")
    expect = expected(TRAIN_PER_LAYER[variant], kernel_layers(cfg))
    norm_k, norm_p = float(global_norm(grads_k)), float(global_norm(grads_p))
    loss_err = abs(float(loss_k) - float(loss_p))
    norm_rel = abs(norm_k - norm_p) / norm_p
    weights = {}
    for li, (gk, gp) in enumerate(zip(grads_k["layers"], grads_p["layers"])):
        # each layer's FFN weights (experts or dense MLP), and with flash
        # attention its attention projections too
        checked = [("moe", k) for k in ("w_gate", "w_up", "w_down",
                                        "shared_gate", "shared_up",
                                        "shared_down")] if "moe" in gk else \
            [("mlp", k) for k in ("w_gate", "w_up", "w_down")]
        if cfg.attn_backend == "flash":
            checked += [("attn", k) for k in ("wq", "wk", "wv", "wo")]
        for mod, key in checked:
            a, b = gk[mod][key].float(), gp[mod][key].float()
            weights[f"layers.{li}.{mod}.{key}"] = float((a - b).abs().max()
                                                        / b.abs().max())
    worst = max(weights.values())
    emit({"phase": "train_parity", "config": variant, "arch": cfg.name,
          "layers": cfg.num_layers, "batch": 2,
          "seq": 256, "loss_kernels": float(loss_k), "loss_plain":
          float(loss_p), "loss_abs_err": loss_err, "loss_bound": 1e-2,
          "grad_norm_kernels": norm_k, "grad_norm_plain": norm_p,
          "grad_norm_rel_err": norm_rel, "grad_norm_bound": 2e-2,
          "weight_grad_rel_to_max": weights, "weight_grad_bound": 5e-2,
          "launches": counts, "expected_launches": expect})
    if counts != expect:
        raise AssertionError(f"train parity {variant}: launch counts "
                             f"{counts} != expected {expect}")
    if not (loss_err <= 1e-2 and norm_rel <= 2e-2 and worst <= 5e-2):
        raise AssertionError(f"{variant} train step kernels vs plain: loss err "
                             f"{loss_err}, grad norm rel {norm_rel}, worst "
                             f"weight grad {worst}")
    del grads_p
    return loss_k, grads_k


def compare_padded_parity(free, padded) -> None:
    """``ds_fp8_padded``'s train-parity step against ``ds_fp8``'s on the
    same weights and batch: the loss (the forward) must be bitwise; which
    gradients are bitwise is recorded.  An expert weight's gradient comes
    from the wgrad alone; the gradients of everything upstream of an MoE
    layer also pass through its dgrad, so the first of forward, dgrad and
    wgrad that differs shows here."""
    import torch
    from repro_torch.tree import tree_leaves
    (loss_f, grads_f), (loss_p, grads_p) = free, padded
    differ = [path for path, a, b in zip(leaf_paths(grads_f),
                                         tree_leaves(grads_f),
                                         tree_leaves(grads_p))
              if not torch.equal(a, b)]
    same = torch.equal(loss_f, loss_p)
    emit({"phase": "train_parity_padded_vs_padding_free",
          "configs": list(DS_VARIANTS), "loss_bitwise_equal": same,
          "loss": float(loss_f), "loss_padded": float(loss_p),
          "grad_leaves": len(tree_leaves(grads_f)),
          "grad_leaves_not_bitwise": differ})
    if not same:
        raise AssertionError("ds_fp8_padded's train-step loss is not bitwise "
                             "ds_fp8's")


def leaf_paths(tree, prefix="") -> list:
    """Dotted names of ``tree``'s leaves, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in leaf_paths(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in leaf_paths(v, f"{prefix}{i}.")]
    return [prefix[:-1]]


def phase_train(variant: str):
    """The configuration at full width, the MoE models cut to 4 layers,
    qwen3-1.7b whole: 8 steps of ``launch/train.py``'s ``train`` (bf16
    wgrad), and for ``fp8`` and ``ds_fp8`` then the same 8 with the fp8
    wgrad; launch counts exact, losses finite, and with the bf16 wgrad the
    loss falls; a profile of one step of each run; the same 8 bf16-wgrad
    steps through the plain versions (but for ``ds_fp8_padded``, which
    ``compare_padded_training`` holds against ``ds_fp8``).  Returns each
    run's launch counts by path name, and the bf16-wgrad run's history."""
    import torch
    from repro_torch.launch.train import train
    cfg = variant_config(variant, num_layers=TRAIN_LAYERS.get(variant, 4))
    batch, seq, steps = 8, 512, 8
    per_step = TRAIN_PER_LAYER[variant]
    runs = (("bf16", steps), ("fp8", steps)) \
        if variant in ("fp8", "ds_fp8") else (("bf16", steps),)
    out, history = {}, None
    for wgrad, n in runs:
        free_memory()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        run = train(cfg, steps=n, batch=batch, seq=seq, lr=1e-3,
                    warmup_steps=3, seed=0, log_every=1, device="cuda",
                    wgrad_precision=wgrad,
                    log=lambda line: print("train", line, flush=True))
        torch.cuda.synchronize()
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        expect = expected(per_step, kernel_layers(cfg) * n)
        if wgrad == "fp8":
            expect["wgrad_fp8"], expect["wgrad"] = expect["wgrad"], 0
        hist = run.history
        step_ms = statistics.median(h["step_ms"] for h in hist[-5:])
        rec = {"phase": "train", "config": variant, "arch": cfg.name,
               "attn_backend": cfg.attn_backend, "wgrad_precision": wgrad,
               "layers": cfg.num_layers, "params": cfg.param_count(),
               "batch": batch, "seq": seq, "steps": n,
               "losses": [h["loss"] for h in hist],
               "grad_norms": [h["grad_norm"] for h in hist],
               "lrs": [h["lr"] for h in hist],
               "step_ms": [h["step_ms"] for h in hist],
               "step_ms_median_last5": step_ms,
               "tok_per_s": batch * seq / step_ms * 1e3,
               "max_memory_allocated_gb": peak / 1e9,
               "launches": counts, "expected_launches": expect}
        emit(rec)
        if counts != expect:
            raise AssertionError(f"train {variant} ({wgrad} wgrad) launch "
                                 f"counts {counts} != expected {expect}")
        finite = all(torch.isfinite(torch.tensor([h["loss"], h["grad_norm"]]))
                     .all() for h in hist)
        if not finite:
            raise AssertionError(f"train {variant} ({wgrad} wgrad): "
                                 "non-finite loss or grad norm")
        if wgrad == "bf16" and not hist[-1]["loss"] < hist[0]["loss"]:
            raise AssertionError(f"train {variant}: loss did not fall "
                                 f"({hist[0]['loss']} -> {hist[-1]['loss']})")
        nxt = run.data.batch_at(n)
        br = profile_breakdown(lambda: run.step_fn(run.params,
                                                   run.opt_state, nxt),
                               top=14)
        emit({"phase": "profile", "config": variant, "of": "train_step",
              "wgrad_precision": wgrad, **br})
        if wgrad == "bf16":
            emit({"phase": "train_split", "config": variant,
                  **split_step(cfg, run, nxt)})
        out[path_name("train_fp8_wgrad" if wgrad == "fp8" else "train",
                      variant)] = counts
        del run
        if wgrad == "bf16":
            history = hist
        if wgrad == "bf16" and variant != "ds_fp8_padded":
            # the same 8 steps through the plain versions: does the
            # trajectory (its spikes included) belong to the kernels?
            free_memory()
            with plain_kernels():
                plain = train(cfg, steps=n, batch=batch, seq=seq, lr=1e-3,
                              warmup_steps=3, seed=0, log_every=n,
                              device="cuda", log=lambda line: None)
            # one step agrees to ~1e-4 (train-parity phase); 8 Adam steps
            # through an lr of 1e-3 amplify that, so the trajectories are
            # held at 5e-2 of the plain loss, step by step
            rel = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                      for a, b in zip(hist, plain.history))
            emit({"phase": "train_plain", "config": variant, "losses":
                  [h["loss"] for h in plain.history], "grad_norms":
                  [h["grad_norm"] for h in plain.history],
                  "max_abs_loss_diff_vs_kernels": max(
                      abs(a["loss"] - b["loss"])
                      for a, b in zip(hist, plain.history)),
                  "max_rel_loss_diff_vs_kernels": rel, "bound": 5e-2})
            del plain
            if not rel <= 5e-2:
                raise AssertionError(f"train {variant}: kernel and plain loss "
                                     f"trajectories differ by {rel} > 5e-2")
    free_memory()
    return out, history


def compare_padded_training(free: list, padded: list) -> None:
    """The 8 bf16-wgrad steps of ``ds_fp8_padded`` beside ``ds_fp8``'s,
    from the same weights and batches: step 0's loss bitwise (the forward
    is), every loss and grad norm within 1e-3 of the padding-free one."""
    steps = [{"step": a["step"], "loss": a["loss"], "loss_padded": b["loss"],
              "loss_bitwise": a["loss"] == b["loss"],
              "grad_norm": a["grad_norm"], "grad_norm_padded": b["grad_norm"],
              "grad_norm_bitwise": a["grad_norm"] == b["grad_norm"],
              "rel_diff": max(abs(a[k] - b[k]) / abs(a[k])
                              for k in ("loss", "grad_norm"))}
             for a, b in zip(free, padded, strict=True)]
    worst = max(s["rel_diff"] for s in steps)
    emit({"phase": "train_padded_vs_padding_free",
          "configs": list(DS_VARIANTS), "steps": steps,
          "max_rel_diff": worst, "bound": 1e-3})
    if not steps[0]["loss_bitwise"]:
        raise AssertionError("ds_fp8_padded's step-0 loss is not bitwise "
                             "ds_fp8's")
    if not worst <= 1e-3:
        raise AssertionError(f"ds_fp8_padded's training differs from "
                             f"ds_fp8's by {worst} > 1e-3")


def split_step(cfg, run, batch):
    """One more step of ``run`` cut into forward, backward and AdamW,
    each timed by CUDA events; and the plain blockwise weight quantization
    such a step does (forward: w, backward: w^T, every expert weight)."""
    import torch
    from repro_torch.core import quantization as q
    from repro_torch.models.model_zoo import make_model
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_leaves, tree_unflatten
    model = make_model(cfg, "cuda")
    opt_cfg = adamw.OptConfig(lr=1e-3, total_steps=8, warmup_steps=3)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    leaves = tree_leaves(run.params)
    for p in leaves:
        p.requires_grad_(True)
    ev[0].record()
    loss, _ = model.loss(run.params, batch)
    ev[1].record()
    grads = torch.autograd.grad(loss, leaves)
    ev[2].record()
    for p in leaves:
        p.requires_grad_(False)
    adamw.apply_updates(run.params, tree_unflatten(run.params, grads),
                        run.opt_state, opt_cfg)
    ev[3].record()
    torch.cuda.synchronize()
    split = {"forward_ms": ev[0].elapsed_time(ev[1]),
             "backward_ms": ev[1].elapsed_time(ev[2]),
             "adamw_ms": ev[2].elapsed_time(ev[3]),
             "weight_quant_ms_per_step": None}
    if cfg.precision != "fp8":
        return split
    moe = next(lay["moe"] for lay in run.params["layers"] if "moe" in lay)

    def quant_weights():
        for key in ("w_gate", "w_up", "w_down", "shared_gate", "shared_up",
                    "shared_down"):
            w = moe[key] if moe[key].dim() == 3 else moe[key][None]
            q.quantize_blockwise_batched(w)
            q.quantize_blockwise_batched(w.transpose(1, 2).contiguous())
    wq_ms = cuda_ms(lambda i: quant_weights(), iters=3, warmup=1)
    split["weight_quant_ms_per_step"] = wq_ms * kernel_layers(cfg)
    return split


def phase_checkpoint() -> None:
    """``ds_fp8`` cut to 2 layers (its dense layer and one MoE layer):
    4 steps of ``train`` saving a checkpoint after step 3 into ``build/``;
    the whole state (params, AdamW's m, v and f32 masters, the step)
    restored into a fresh tree on the card must equal the live state leaf
    by leaf, and the loss of the next batch (forward only) from the
    restored params must be bitwise the live params'.  Then ``train``
    resumes from the directory and runs step 4.  The directory is deleted
    at the end."""
    import shutil
    import torch
    from repro_torch.checkpoint import checkpointer as ckpt
    from repro_torch.launch.train import train
    from repro_torch.models.model_zoo import make_model
    from repro_torch.tree import tree_leaves, tree_map
    cfg = variant_config("ds_fp8", num_layers=2)
    d = os.path.join(HERE, "build", "chip_smoke_ckpt")
    shutil.rmtree(d, ignore_errors=True)
    kw = dict(batch=8, seq=512, lr=1e-3, warmup_steps=3, seed=0,
              log_every=1, device="cuda", ckpt_dir=d, save_every=4)
    stamps = []

    def log(line):
        stamps.append((time.perf_counter(), line))
        print("checkpoint", line, flush=True)
    try:
        run = train(cfg, steps=4, log=log, **kw)
        # the save runs between step 3's line (the step timer has waited
        # for the step) and the [ckpt] line
        t_step = next(t for t, line in stamps if line.startswith("step     3"))
        t_saved = next(t for t, line in stamps if line.startswith("[ckpt]"))
        step_dir = os.path.join(d, "step_3")
        nbytes = {f: os.path.getsize(os.path.join(step_dir, f))
                  for f in os.listdir(step_dir)}
        free_bytes = shutil.disk_usage(d).free
        live = {"params": run.params, "opt": run.opt_state}
        like = tree_map(torch.empty_like, live)
        t0 = time.perf_counter()
        restored, meta, s = ckpt.restore_latest(d, like)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        leaves = list(zip(tree_leaves(restored), tree_leaves(live)))
        unequal = sum(not torch.equal(a, b) for a, b in leaves)
        model = make_model(cfg, "cuda")
        nxt = run.data.batch_at(4)
        with torch.no_grad():
            loss_live = model.loss(run.params, nxt)[0]
            loss_restored = model.loss(restored["params"], nxt)[0]
        same = torch.equal(loss_live, loss_restored)
        del like, restored, leaves, run, live
        free_memory()
        stamps.clear()
        resumed = train(cfg, steps=5, log=log, **kw)
        resumed_log = [line for _, line in stamps if "[resume]" in line]
        resumed_steps = [h["step"] for h in resumed.history]
        resumed_loss = resumed.history[-1]["loss"]
        del resumed
    finally:
        shutil.rmtree(d, ignore_errors=True)
    free_memory()
    rec = {"phase": "checkpoint", "config": "ds_fp8", "layers": 2,
           "params": cfg.param_count(), "saved_step": s, "meta_step":
           meta["step"], "leaves": meta["num_leaves"],
           "leaves_not_equal": unequal, "bytes_written": sum(nbytes.values()),
           "files": nbytes, "disk_free_bytes_after_save": free_bytes,
           "save_s": t_saved - t_step, "restore_s": restore_s,
           "next_loss_live": float(loss_live),
           "next_loss_restored": float(loss_restored),
           "next_loss_bitwise_equal": same, "resume_log": resumed_log,
           "resumed_steps": resumed_steps,
           "resumed_step_loss": resumed_loss,
           "resumed_step_loss_bitwise_forward_only": resumed_loss
           == float(loss_live)}
    emit(rec)
    if s != 3 or unequal or not same:
        raise AssertionError(f"checkpoint: restored step {s}, {unequal} "
                             f"leaves differ, next loss bitwise {same}")
    if resumed_steps != [4] or not resumed_log \
            or not math.isfinite(resumed_loss):
        raise AssertionError(f"checkpoint: the resumed run logged "
                             f"{resumed_log}, ran {resumed_steps}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="probe, build, kernel, autotune and analysis "
                         "checks only")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import device
    from repro_torch.kernels import build
    from repro_torch.kernels import plan as plan_mod

    # every selection of this run (the engines' decode tiles included)
    # goes to a cache file in the checkout's build/
    os.environ.setdefault(plan_mod.CACHE_ENV, os.path.join(
        HERE, "build", "tileplan_cache.json"))
    info = device.probe()
    emit({"phase": "probe", **info})
    t0 = time.perf_counter()
    build.build_all()
    notes = build.LAST_BUILD.get("ptxas", {})
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "dir": os.path.relpath(str(build.build_all()), HERE),
          "ptxas": {src: [ln.strip() for ln in out.splitlines()
                          if "registers" in ln or "spill" in ln
                          or "entry function" in ln]
                    for src, out in notes.items()}})
    with timed("kernel"):
        timing = phase_kernels(full=not args.quick)
    free_memory()
    with timed("padded"):
        phase_padded(full=not args.quick)
    free_memory()
    with timed("autotune"):
        phase_autotune()
    free_memory()
    with timed("analysis"):
        phase_analysis(info)
    if not args.quick:
        paths = {}
        for variant in (*VARIANTS, DENSE_VARIANT):
            free_memory()
            with timed(f"forward {variant}"):
                phase_forward(variant)
        logits = {}
        for variant in DS_VARIANTS:
            free_memory()
            with timed(f"forward {variant}"):
                logits[variant] = phase_forward(variant)
        # the baseline pads each group and runs the same GEMM: the same
        # logits bit for bit
        same = torch.equal(*(logits[v] for v in DS_VARIANTS))
        emit({"phase": "forward_padded_vs_padding_free",
              "configs": list(DS_VARIANTS), "logits_bitwise_equal": same})
        if not same:
            raise AssertionError("ds_fp8_padded's logits are not bitwise "
                                 "ds_fp8's")
        del logits
        for variant in ZOO:
            free_memory()
            with timed(f"forward {variant}"):
                phase_zoo_forward(variant)
        free_memory()
        with timed("serve"):
            paths.update(phase_serve())
        for variant in ZOO_SERVE:
            with timed(f"serve {variant}"):
                paths[f"serve_{variant}"] = phase_zoo_serve(variant)
        free_memory()
        with timed("window_gate"):
            phase_window_gate()
        parity = {}
        for variant in (*VARIANTS, *DS_VARIANTS):
            free_memory()
            with timed(f"train_parity {variant}"):
                out = phase_train_parity(variant)
            if variant in DS_VARIANTS:
                parity[variant] = out
            del out
        compare_padded_parity(*(parity[v] for v in DS_VARIANTS))
        del parity
        histories = {}
        for variant in (*VARIANTS, *DS_VARIANTS):
            free_memory()
            with timed(f"train {variant}"):
                counts, histories[variant] = phase_train(variant)
            paths.update(counts)
        compare_padded_training(*(histories[v] for v in DS_VARIANTS))
        free_memory()
        with timed("checkpoint"):
            phase_checkpoint()
        # launches: the sum over the main paths driven (serving and
        # training in each configuration, training with the fp8 wgrad),
        # each counted from 0
        rows = []
        for name in SOURCES:
            t = timing[name]
            row = {"name": name, "route": "cuda", "source": SOURCES[name],
                   "replaces": REPLACES[name],
                   "launches": sum(c.get(name, 0) for c in paths.values()),
                   "launches_by_path": {p: c.get(name, 0)
                                        for p, c in paths.items()},
                   "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                   "eager_ms": t["eager_ms"],
                   "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                   "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                   "library_note": t["library_note"]}
            # the grouped GEMMs' and B3's other timed shapes
            for extra in ("decode", "decode_shared", "train", "dgrad"):
                te = timing.get(f"{name}_{extra}")
                if te is not None:
                    row.update({f"{extra}_{k}": te[k] for k in (
                        "shape", "ms", "eager_ms", "plain_ms", "bound_ms",
                        "bound_by", "library_ms")})
            if name.startswith("act_quantize"):
                row["launch_floor_ms"] = t["launch_floor_ms"]
            if name.startswith("wgrad"):
                # B4 / B6 with dw in f32, beside the bf16 dw the path takes
                tf = timing[f"{name}_f32"]
                row.update(out_dtype=t["out_dtype"],
                           **{f"f32_out_{k}": tf[k] for k in (
                               "ms", "eager_ms", "plain_ms", "bound_ms",
                               "bound_by", "library_ms", "library_note")})
            if name == "flash_attention":
                row["shapes"] = t["shapes"]
            rows.append(row)
        # flash attention ran on the serve and train paths of both models,
        # and on the zoo's serve paths that reach it
        for p in ("serve_fp8_flash", "serve_qwen3_flash", "train_fp8_flash",
                  "train_qwen3_flash", "serve_yi_fp8_flash",
                  "serve_pixtral_fp8_flash", "serve_whisper_fp8_flash"):
            if not paths[p].get("flash_attention"):
                raise AssertionError(f"{p}: flash attention never launched")
        emit({"kernels": rows})
    print(info["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
