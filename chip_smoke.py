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
             for timing only; B2, B7 and B5 (both weight layouts) at every
             grouped-GEMM geometry of the tuning pool (block_m 8 to 512,
             block_n 128 and 256) on the residue case (a group of each
             residue 1, 2, 3, 2^i - 1, 2^i, 2^i + 1 rows up to 511, an
             empty group, NaN tail rows, K = N = 256) into NaN-prefilled
             outputs, and B2, B7 and B5 timed at every block_m at the
             prefill, decode and 16384-row shapes (B2 also at the f32
             dgrad, block_n 128 and 256); tiles outside the pool raise;
             B4 and B6 at every wgrad geometry of the pool (block_n 256,
             span 2, span 4: thread-block clusters) at both dw dtypes on
             qwen2-moe's shared gate/up, a ragged routed shape (N 1536)
             and its down, recurrentgemma-2b's MLP, a NaN tail, a
             mid-chunk group and no rows, each bitwise its span-1 launch
             and within the wgrad gates of the plain version, and timed
             at the shared gate/up and the routed shape beside span 1
             and, for B4, ``F.grouped_mm``;
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
             fitting one SM at its CTAs an SM; B2, B5 (both weight
             layouts) and B7 at every pool geometry against block_m 128
             (the qwen2-moe routed prefill's gate and down and its
             decode, minitron-8b's dense decode) within their gates, and
             whether bitwise equal; a measured autotune under ``build/``
             of the grouped GEMMs at the qwen2-moe and deepseek-moe-16b
             routed prefill and decode shapes and qwen2-moe's 16384
             training rows, and of the wgrads at the training shapes
             (the routed gate/up, the shared experts' and
             recurrentgemma-2b's gate/up), every candidate the pool keeps
             measured beside the cost model's (a wgrad's once a distinct
             geometry, its other block_m sharing the kernel), nothing
             skipped, then a cache hit that measures nothing; the served MoE engines' decode tiles (block_m 8 or
             16) measured at their decode shapes into the run's cache;
             the aten ops and eager ms of one padded GEMM with the plan
             cache against a fresh plan;
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
  7. serve   batch 4, 16 new tokens, greedy, random weights: qwen2-moe-a2.7b
             cut to 8 layers on one param tree, at prompt 64 in ``fp8``,
             ``fp8_fused`` and ``bf16``, at prompt 512 in ``fp8`` and
             ``fp8_flash`` (attention the only difference); then the
             28-layer qwen3-1.7b at prompt 512 in ``qwen3_flash``; then
             deepseek-moe-16b cut to 8 layers (its dense layer and 7 MoE
             layers) on one param tree at prompt 64
             and 512, each in ``ds_fp8`` and ``ds_fp8_padded`` (tokens
             equal between the two; one padded generate under
             ``torch.cuda.set_sync_debug_mode("error")``); then each zoo
             recipe as ``ZOO_SERVE`` says (yi-9b p512 cut to 8 layers,
             minitron-8b p64,
             qwen1.5-110b p64 cut to 4 layers, pixtral-12b 256 patches +
             p128, recurrentgemma-2b batch 2 p2304 cut to 6 layers (2
             cycles), xlstm-350m p512 cut to 6 (one cycle), whisper-tiny
             1500 frames + p128; every other one whole),
             each on a tree of its own, with a profile of a prefill and
             of a decode step; the qwen2-moe fp8 p64 generate (and its
             engine's construction) under the engine contract scaled to
             8 layers (one decode selection, 2 x 8 x 16 plan builds,
             the decode ones on the selected tile); the launch counts of
             each run are asserted; every engine selects its decode tiles
             (an MoE model once, 8 or 16 rows as the autotune phase
             measured, its tokens bitwise those of an engine pinned to
             the fixed 16-row rule; a dense model none, on the
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
             backward / AdamW split), the first 2 of them through the
             plain versions for comparison (not for ``ds_fp8_padded``,
             which is
             held against ``ds_fp8``: step 0's loss bitwise, every loss
             and grad norm within 1e-3); for ``fp8`` and ``ds_fp8`` then
             the same 8 steps with the fp8 wgrad (launch counts asserted,
             a profile of one step); every train step runs with
             ``remat`` (the default: each layer's forward again in the
             backward, launches included);
  9a. train_rg_geometries  recurrentgemma-2b, one block_pattern cycle
             at full width, fp8, remat, 2 steps of batch 8 x seq 512
             through ``train`` under each wgrad geometry (span 1, the
             witness; block_n 256; span 2 at block_m 256; span 4) at the
             bf16 and the fp8 wgrad: every step's gradients and params
             bitwise the witness's, the witness's first step against the
             plain versions, launch counts exact; then one more step,
             unrecorded: its ms, the wgrad share and the peak memory;
  9b. remat  ``fp8`` and ``ds_fp8`` cut to 4 layers, batch 8, seq 512:
             one step's forward and backward with remat on and off,
             CUDA-event ms and peak memory each way, gradients bitwise,
             the peak with remat below the one without;
  10. checkpoint  ``ds_fp8`` cut to 2 layers trained 4 steps through
             ``train`` with a checkpoint after the last, under ``build/``;
             then ``train`` resumes from it and runs one more step: the
             state its restore fills (NaN first) every leaf equal to the
             live state and the next batch's loss bitwise the live
             params'; the bytes written and the save and restore seconds;
  11. distributed  expert and data parallelism on 4 ranks that share the
             card over gloo (NCCL takes one rank a device): B2 at the EP 4
             shapes beside the whole layer's (one process);
             deepseek-moe-16b cut to 8 layers (its dense layer and 7 MoE
             layers) served under EP 4 on a (1, 4)
             mesh, batch 4, prompt 64, 4 tokens, its prefill logits and
             each token (teacher-forced) held against one process's at
             15% of the largest logit, tokens equal on every rank, the
             packed rows past sum(group_sizes) zero; its 2-layer cut
             trained 2 steps under EP 2 x DP 2 on (2, 2) through
             ``train`` (step 0's loss and grad norm within 1e-3 of one
             process's, the later grad norms within 1e-2, loss falling),
             its params saved as full arrays, the next batch's loss from
             them within 1e-3 of one process's and of 2 ranks' that
             restore them on (1, 2) (every leaf bitwise the file); then
             one rank
             under NCCL (world size 1) trains a step, its loss bitwise
             one process's; each rank's launch counts exact, peak memory,
             CUDA-event ms and collective calls and bytes; attention,
             the embedding and the head are tensor-parallel there too;
  12. tensor_parallel  dense tensor parallelism on 4 ranks sharing the
             card over gloo, mesh (1, 4): yi-9b whole (48 layers, bf16,
             flash) served at batch 4, prompt 128, 4 tokens: the logits
             of each of its steps (the generate's own, teacher-forced on
             its tokens) held against one process's at 4e-2 of the
             largest logit and against one process's in f32 within 1.5x
             one process's own bf16 error, tokens equal on
             every rank, weight bytes a rank within 2% of the whole
             leaves plus a quarter of the rest, 8 q heads and 1 kv head
             a rank, the cache's 132 slots split 33 a rank; qwen3-1.7b
             whole (28 layers, flash, remat) trained 2 steps of batch 4 x
             seq 256 through ``train``, every step's loss and grad norm
             within 1e-3 of one process's at the params it started
             from; launch counts exact (B8 alone), peak memory, CUDA-
             event ms (of ranks sharing one card), collectives, and one
             more step split into forward, backward and AdamW.
  13. dryrun  in a process of its own, off the card (host time only),
             started before phase 10: it traces while the phases from
             10 on run, then waits for the remat and fsdp_seq_parallel
             runs' measurements;
             ``launch/dryrun.py``'s ``lower_cell`` on fake tensors and a
             fake process group predicts (a) the ``remat`` phase's fp8
             run on a 1 x 1 mesh, remat on and off: its param and
             gradient bytes exactly, and its peak printed beside
             ``max_memory_allocated`` with the gap; (b) each rank of the
             ``fsdp_seq_parallel`` run: its param and AdamW bytes and its
             collectives' calls and bytes by type (a step's, times the
             steps) exactly; (c) one production cell a family (16 x 16,
             one cycle, ``decode_32k``); the dry run's card memory figure
             equals the card's ``total_memory``;
  14. examples  ``examples/quickstart_torch.py`` (loss falls) and
             ``examples/serve_decode_torch.py`` (batch x max-new tokens)
             at smoke size on the card, while the dry run compares; no
             phase of the card's process took a shape-only kernel.
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
# runs once a layer in a forward at S % 128 == 0 (never in decode).  A
# train step runs each layer's forward twice (``remat``, the reference's
# default: the backward recomputes each cycle of the layers, here every
# layer, deepseek's dense first layer excepted), then its backward: a
# serving forward's launches on top of the backward's, and flash
# attention twice (the backward recomputes the plain oracle, as the
# reference does).  The padded baseline
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
    "fp8": {"quantize_tilewise": 10, "act_quantize": 4, "gmm": 18,
            "wgrad": 6},
    "fp8_fused": {"quantize_tilewise": 10, "gmm_quant": 8,
                  "act_quantize_fp8": 4, "gmm": 10, "wgrad": 6},
    "bf16": {"gmm_bf16": 9, "wgrad": 3},
    "fp8_flash": {"quantize_tilewise": 10, "act_quantize": 4, "gmm": 18,
                  "wgrad": 6, "flash_attention": 2},
    "qwen3_flash": {"flash_attention": 2},
    "ds_fp8": {"quantize_tilewise": 10, "act_quantize": 4, "gmm": 18,
               "wgrad": 6},
    "ds_fp8_padded": {"quantize_tilewise": 10, "act_quantize": 4, "gmm": 18,
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
    from repro_torch.kernels import wgrad_kernel
    for fn, attr in counters().values():
        setattr(fn, attr, 0)
    for fn in (wgrad_kernel.gmm_wgrad_cuda, wgrad_kernel.gmm_wgrad_fp8_cuda):
        fn.launches_by_geometry.clear()


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


def gemm_case(gen, m, k, n, sizes, block_m, out_dtype, block_n=128):
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
    kw = dict(num_groups=g, block_m=block_m, block_n=block_n,
              out_dtype=out_dtype, plan=plan)
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
            "block_m": kw["block_m"], "block_n": kw.get("block_n", 128),
            "max_abs_err": float(err.max()) if
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


def wgrad_geometries() -> dict:
    """The wgrads' geometries of the tuning pool
    (``resources.WGRAD_GEOMETRIES``): name -> (block_n, n_span, k_span);
    "span1" is the single-tile kernel every other one must equal bit for
    bit, "bn256" span 1 at block_n 256, "span2" and "span4" the spans."""
    from repro_torch.kernels.resources import WGRAD_GEOMETRIES
    return {("span1" if g == (128, 1, 1) else f"bn{g[0]}" if g[1] == 1
             else f"span{g[1]}"): g for g in WGRAD_GEOMETRIES}


def compare_wgrad(name, fp8, args, plan, out_dtype=None, geometry="span1",
                  want=None, span1=None):
    """Kernel against plain version: within 1e-4 of the largest |dw| plus
    1e-6 (both sum exact products in f32, in another order; the fp8
    kernel's scaled dy enters as a bf16 hi + lo pair, ~2^-16 relative);
    a bf16 dw (the kernel's f32 sum rounded once) against the plain f32 dw
    within that plus half a bf16 step (2^-8 of the value); two launches
    bitwise equal; empty groups exactly zero; no NaN.  At a ``geometry``
    of wgrad_geometries(); ``want``: the plain dw, computed here when
    absent; ``span1``: the span-1 launch's dw on the same operands, which
    this one must equal bit for bit.  Returns the row and the dw."""
    import torch
    from repro_torch.kernels import wgrad_kernel as wk
    cuda = wk.gmm_wgrad_fp8_cuda if fp8 else wk.gmm_wgrad_cuda
    plain = wk.gmm_wgrad_fp8_plain if fp8 else wk.gmm_wgrad_plain
    out_dtype = out_dtype or torch.float32
    bn, ns, ks = wgrad_geometries()[geometry]
    geo = dict(block_n=bn, n_span=ns, k_span=ks)
    dw = cuda(*args, plan=plan, out_dtype=out_dtype, **geo)
    dw2 = cuda(*args, plan=plan, out_dtype=out_dtype, **geo)
    if want is None:
        want = plain(*args, plan=plan)
    torch.cuda.synchronize()
    label = (f"{'wgrad_fp8' if fp8 else 'wgrad'} {name} {geometry} "
             f"{str(out_dtype)[6:]}")
    if dw.dtype != out_dtype:
        raise AssertionError(f"{label}: dw is {dw.dtype}")
    if not torch.equal(dw, dw2):
        raise AssertionError(f"{label}: two launches differ")
    if span1 is not None and not torch.equal(dw, span1):
        raise AssertionError(f"{label}: not bitwise the span-1 launch "
                             f"({int((dw != span1).sum())} elements differ)")
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
    return {"case": name, "geometry": geometry,
            "out_dtype": str(out_dtype)[6:],
            "shape": [x.shape[0], x.shape[1], dy.shape[1]],
            "groups": int(args[-1].numel()), "empty_groups": int(empty.numel()),
            "total_rows": int(args[-1].sum()),
            "max_abs_err": float(err.max()), "rel_to_max":
            float(err.max()) / scale if scale else 0.0, "bitwise_repeat": True,
            "bitwise_vs_span1": span1 is not None or geometry == "span1"}, dw


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
                rows[key].append(compare_wgrad(name, fp8, args, plan,
                                               dt)[0])
            if name == "routed_gate_up":
                keep[key] = (args, plan)
            del args
        rows[key].append(check_wgrad_nan_owned(gen, fp8))
    return rows, keep


def check_wgrad_nan_owned(gen, fp8, geometry="span1"):
    """A NaN in an owned row of x reaches dw where the plain version puts
    it (x[m, k] times every dy[m, n]: the whole row k of the group's dw),
    at both output dtypes; the rest within compare_wgrad's tolerance.  At
    a ``geometry`` of wgrad_geometries() (K = N = 512 but at span 1)."""
    import torch
    from repro_torch.kernels import wgrad_kernel as wk
    sizes = torch.tensor([1, 37, 0, 200, 5, 57], dtype=torch.int32)
    kn = (256, 384) if geometry == "span1" else (512, 512)
    bn, ns, ks = wgrad_geometries()[geometry]
    geo = dict(block_n=bn, n_span=ns, k_span=ks)
    args, plan = wgrad_case(gen, 300, *kn, sizes, fp8)
    x = args[0]
    if fp8:
        x.view(torch.uint8)[50, 130] = 0x7F            # e4m3 NaN, group 3
    else:
        x[50, 130] = float("nan")
    cuda = wk.gmm_wgrad_fp8_cuda if fp8 else wk.gmm_wgrad_cuda
    plain = wk.gmm_wgrad_fp8_plain if fp8 else wk.gmm_wgrad_plain
    want = plain(*args, plan=plan)
    label = f"{'wgrad_fp8' if fp8 else 'wgrad'} nan_owned {geometry}"
    worst = 0.0
    for dt in (torch.bfloat16, torch.float32):
        dw = cuda(*args, plan=plan, out_dtype=dt, **geo).float()
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
    return {"case": "nan_owned", "geometry": geometry,
            "shape": [300, *kn], "groups": int(sizes.numel()),
            "nan_elements": int(torch.isnan(want).sum()),
            "max_abs_err": worst}


def wgrad_span_cases(cpu_gen) -> dict:
    """The cases every wgrad geometry is held to: name -> (M, K, N, group
    sizes, wgrad_case kwargs).  qwen2-moe's shared experts' gate/up (G =
    1); a ragged routed shape whose N, 1536, every geometry divides
    (16384 rows over 60 groups, 8 of them empty) and its down;
    recurrentgemma-2b's MLP at 4096 tokens; a NaN tail; a group starting
    mid-chunk; no rows at all."""
    import torch
    one = torch.tensor([4096], dtype=torch.int32)
    routed = ragged_sizes(cpu_gen, 16384, 60, 16384, empty=8)
    return {
        "shared_gate_up": (4096, 2048, 5632, one, {}),
        "routed_1536": (16384, 2048, 1536, routed, {}),
        "routed_1536_down": (16384, 1536, 2048, routed, {}),
        "rg_gate_up": (4096, 2560, 7680, one, {}),
        "rg_down": (4096, 7680, 2560, one, {}),
        "nan_tail": (4096, 2048, 1536,
                     ragged_sizes(cpu_gen, 4096, 60, 3900, empty=8),
                     {"nan_tail": True}),
        "mid_chunk": (300, 512, 512,
                      torch.tensor([1, 37, 0, 200, 5, 57], dtype=torch.int32),
                      {}),
        "all_empty": (1024, 512, 512, torch.zeros(8, dtype=torch.int32), {}),
    }


def check_wgrad_spans(gen, cpu_gen) -> dict:
    """B4 and B6 at every wgrad geometry of the pool (block_n 256, span 2,
    span 4), each output dtype, on wgrad_span_cases: each launch bitwise
    the span-1 launch on the same operands and within compare_wgrad's
    gates of the plain version (two launches bitwise, empty groups zero,
    no NaN), and the NaN of an owned row where the plain version puts it.
    Returns the rows by kernel."""
    import torch
    from repro_torch.kernels import wgrad_kernel as wk
    rows = {"wgrad": [], "wgrad_fp8": []}
    for fp8, key in ((False, "wgrad"), (True, "wgrad_fp8")):
        plain = wk.gmm_wgrad_fp8_plain if fp8 else wk.gmm_wgrad_plain
        for name, (m, k, n, sizes, kw) in wgrad_span_cases(cpu_gen).items():
            args, plan = wgrad_case(gen, m, k, n, sizes, fp8, **kw)
            want = plain(*args, plan=plan)
            for dt in (torch.bfloat16, torch.float32):
                row, span1 = compare_wgrad(name, fp8, args, plan, dt,
                                           want=want)
                rows[key].append(row)
                for geometry in wgrad_geometries():
                    if geometry != "span1":
                        rows[key].append(compare_wgrad(
                            name, fp8, args, plan, dt, geometry, want,
                            span1)[0])
                del span1
            del args, want
        for geometry in wgrad_geometries():
            if geometry != "span1":
                rows[key].append(check_wgrad_nan_owned(gen, fp8, geometry))
    emit({"phase": "kernel_wgrad_geometries",
          "geometries": wgrad_geometries(),
          "checked": {k: len(v) for k, v in rows.items()},
          "bitwise_vs_span1": sum(r.get("bitwise_vs_span1", False)
                                  and r["geometry"] != "span1"
                                  for v in rows.values() for r in v)})
    return rows


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
            "block_m": kw["block_m"], "block_n": kw.get("block_n", 128),
            "bitwise_vs_quantize_of_gmm": True,
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


def bf16_case(gen, m, k, n, sizes, block_m, out_dtype, k_major=False,
              block_n=128):
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
    kw = dict(num_groups=g, block_m=block_m, block_n=block_n,
              out_dtype=out_dtype, plan=plan)
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
            "block_n": kw.get("block_n", 128),
            "out_dtype": str(kw["out_dtype"]),
            "w_layout": "K-contiguous" if gk.weight_layout(w) else
            "N-contiguous",
            "max_abs_err": float(err.max()) if err.numel() else 0.0,
            "rel_to_max": float(err.max()) / scale if scale else 0.0,
            "mismatches": int((err > 0).sum())}


def pool_geometries() -> list:
    """``(block_m, block_n)`` of every grouped-GEMM entry of the tuning
    pool (the JAX package's ``CONFIG_POOL`` without its wgrad spans), in
    pool order: the decode entries, then each block_m 64 to 512 at
    block_n 128 and 256."""
    from repro_torch.kernels.plan import CONFIG_POOL
    out = []
    for c in CONFIG_POOL:
        geometry = (c.block_m, c.block_n)
        if (c.n_span, c.k_span) == (1, 1) and geometry not in out:
            out.append(geometry)
    return out


# the residue case: K = N = 256, M past sum(sizes) by RESIDUE_TAIL rows
# that hold NaN in the operands
RESIDUE_KN = 256
RESIDUE_TAIL = 37


def residue_sizes():
    """One group of each residue 1, 2, 3 and 2^i - 1, 2^i, 2^i + 1 up to
    511 rows, and an empty group among them: each row count a store pool
    has to cover, at every offset the groups before it leave."""
    import torch
    rs = sorted({1, 2, 3} | {r for i in range(2, 10)
                             for r in (2 ** i - 1, 2 ** i, 2 ** i + 1)
                             if r <= 511})
    rs.insert(len(rs) // 2, 0)
    return torch.tensor(rs, dtype=torch.int32)


def check_residues(gen) -> dict:
    """B2 (bf16 and f32 out), B7 and B5 (w N- and K-contiguous, bf16 and
    f32 out) at every pool geometry on the residue case, into
    NaN-prefilled outputs, each against its plain version under its gate
    (``compare_gemm``, ``compare_gemm_quant``, ``compare_gemm_bf16``):
    kernel -> rows."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.plan import make_tile_plan
    sizes = residue_sizes()
    g, total = sizes.numel(), int(sizes.sum())
    m, k = total + RESIDUE_TAIL, RESIDUE_KN
    n = k
    gs = sizes.cuda()
    a = torch.randn((m, k), generator=gen, device="cuda")
    w = torch.randn((g, k, n), generator=gen, device="cuda") * k ** -0.5
    a8, sa = ref.quantize_tilewise_ref(a)
    b8, sb = ref.quantize_blockwise_ref(w)
    a8.view(torch.uint8)[total:] = 0x7F                 # e4m3 NaN
    sa[total:] = float("nan")
    x = a.bfloat16()
    x[total:] = float("nan")
    wn = w.bfloat16()
    wk = wn.transpose(1, 2).contiguous().transpose(1, 2)
    del a, w
    rows = {"gmm": [], "gmm_quant": [], "gmm_bf16": []}
    for bm, bn in pool_geometries():
        plan = make_tile_plan(gs, m, block_m=bm, num_groups=g)
        name = f"residues_bm{bm}_bn{bn}"
        for dt in (torch.bfloat16, torch.float32):
            kw = dict(num_groups=g, block_m=bm, block_n=bn, out_dtype=dt,
                      plan=plan)
            rows["gmm"].append(compare_gemm(f"{name}_{str(dt)[6:]}",
                                            (a8, sa, b8, sb, gs), kw, plan,
                                            nan_out=True))
            if dt == torch.bfloat16:
                rows["gmm_quant"].append(compare_gemm_quant(
                    name, (a8, sa, b8, sb, gs), kw, plan, nan_out=True))
            for wl, tag in ((wn, ""), (wk, "_wT")):
                rows["gmm_bf16"].append(compare_gemm_bf16(
                    f"{name}_{str(dt)[6:]}{tag}", (x, wl, gs), kw, plan,
                    nan_out=True))
    return rows


# tile geometries no kernel is built for: each must raise
UNBUILT_TILES = ({"block_m": 24}, {"block_m": 32}, {"block_k": 256})


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
    "yi_tp4_prefill": (4, 8, 1, 128, 128),
    "qwen3_tp4_train": (4, 4, 2, 256, 128),
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


# the kernel table's shapes every pool geometry is timed at: name ->
# (group sizes, M, K, N), bf16 out; and B2's training dgrad (f32 out),
# whose N 2048 takes the 256-wide tile
BLOCK_M_TIMED = {"prefill": ("prefill", 1024, 2048, 1408),
                 "decode": ("decode", 16, 2048, 1408),
                 "train": ("train", 16384, 2048, 1408),
                 "dgrad": ("train", 16384, 1408, 2048)}


def time_block_ms(gen, sizes) -> dict:
    """B2, B7 and B5 at every block_m of the pool (block_n 128) at the
    kernel table's prefill, decode and 16384-row shapes, and B2 at every
    pool geometry (block_n 128 and 256) at the f32 training dgrad:
    CUDA-graph replays, each call on its own copy of the operands,
    enough copies that each reads them from HBM, as the table's rows.
    Returns kernel -> shape -> "block_m/block_n" -> ms."""
    import torch
    from repro_torch.kernels import grouped_gemm_kernel as gk
    from repro_torch.kernels import ref
    from repro_torch.kernels.plan import make_tile_plan
    out = {"gmm": {}, "gmm_quant": {}, "gmm_bf16": {}}
    for name, (which, m, k, n) in BLOCK_M_TIMED.items():
        gs = sizes[which].cuda()
        g, visited = gs.numel(), int((sizes[which] > 0).sum())
        dgrad = name == "dgrad"

        def fp8():
            a8, sa = ref.quantize_tilewise_ref(
                torch.randn((m, k), generator=gen, device="cuda"))
            b8, sb = ref.quantize_blockwise_ref(torch.randn(
                (g, k, n), generator=gen, device="cuda") * k ** -0.5)
            return a8, sa, b8, sb

        def bf16():
            return (torch.randn((m, k), generator=gen,
                                device="cuda").bfloat16(),
                    (torch.randn((g, k, n), generator=gen, device="cuda")
                     * k ** -0.5).bfloat16())
        f8 = rotation(fp8, m * k + visited * k * n)
        b16 = [] if dgrad else rotation(bf16, 2 * (m * k + visited * k * n))
        runs = (("gmm", gk.gmm_cuda, f8),) if dgrad else (
            ("gmm", gk.gmm_cuda, f8), ("gmm_quant", gk.gmm_quant_cuda, f8),
            ("gmm_bf16", gk.gmm_bf16_cuda, b16))
        dt = torch.float32 if dgrad else torch.bfloat16
        for bm, bn in pool_geometries():
            if bn != 128 and not dgrad:
                continue
            plan = make_tile_plan(gs, m, block_m=bm, num_groups=g)
            kw = dict(num_groups=g, block_m=bm, block_n=bn, plan=plan)
            for kernel, fn, ins in runs:
                if kernel != "gmm_quant":
                    kw["out_dtype"] = dt

                def call(i, fn=fn, ins=ins, kw=dict(kw)):
                    return fn(*ins[i % len(ins)], gs, **kw)
                out[kernel].setdefault(name, {})[f"{bm}/{bn}"] = graph_ms(
                    call, iters=len(ins) * -(-10 // len(ins)))
        del f8, b16
    for kernel, shapes in out.items():
        emit({"phase": "kernel_time_block_m", "kernel": kernel,
              "ms": shapes})
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


# the wgrads' times at every geometry: (kernel, geometry, shape) -> row
WGRAD_GEOMETRY_TIMES = {}
# the shapes every geometry is timed at: name -> (M, K, N, groups, empty)
WGRAD_GEOMETRY_TIMED = {"shared_gate_up": (4096, 2048, 5632, 1, 0),
                        "routed_1536": (16384, 2048, 1536, 60, 8)}


def time_wgrad_geometries(gen, cpu_gen, worst) -> None:
    """B4 and B6 at every geometry of wgrad_geometries(), bf16 and f32 dw,
    at WGRAD_GEOMETRY_TIMED's shapes, timed as the table's wgrad rows are
    (graph replays; each call writes a dw of 23-755 MB), the operands
    cycling through copies that overflow the L2 with the dw, with
    the plain version's eager time, the bound and, for B4,
    ``F.grouped_mm(x.T, dy, offs=...)`` on the same operands; into
    WGRAD_GEOMETRY_TIMES, a line each."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import wgrad_kernel as wk
    for shape, (m, k, n, g, empty) in WGRAD_GEOMETRY_TIMED.items():
        sizes = (torch.tensor([m], dtype=torch.int32) if g == 1 else
                 ragged_sizes(cpu_gen, m, g, m, empty=empty))
        total = int(sizes.sum())
        for fp8, kernel in ((False, "wgrad"), (True, "wgrad_fp8")):
            in_bytes = total * (k + n) * (1 if fp8 else 2) + \
                (4 * total * (k + n) // 128 if fp8 else 0)
            copies = rotation(lambda: wgrad_case(gen, m, k, n, sizes, fp8),
                              in_bytes + 2 * g * k * n)
            args, plan = copies[0]
            cuda = counters()[kernel][0]
            plain = wk.gmm_wgrad_fp8_plain if fp8 else wk.gmm_wgrad_plain
            for dt in (torch.bfloat16, torch.float32):
                plain_ms = cuda_ms(lambda i: plain(*args, plan=plan,
                                                   out_dtype=dt),
                                   iters=2, warmup=1)
                lib = (None, "no PyTorch call takes scales that vary along "
                       "the contracted axis")
                if not fp8:
                    x, dy, gs = args
                    ends = torch.cumsum(gs, 0).to(torch.int32)
                    want = plain(*args, plan=plan)
                    if dt == torch.bfloat16:
                        lib = library_call(
                            lambda i: F.grouped_mm(x.T, dy, offs=ends), want,
                            lambda w: w.abs() * 2.0 ** -8
                            + 1e-4 * w.abs().max() + 1e-6)
                    else:
                        lib = library_call(
                            lambda i: F.grouped_mm(x.T, dy, offs=ends,
                                                   out_dtype=torch.float32),
                            want, lambda w: 1e-4 * w.abs().max() + 1e-6)
                    del want
                for geometry, (bn, ns, ks) in wgrad_geometries().items():
                    def call(i, bn=bn, ns=ns, ks=ks, dt=dt):
                        a, p = copies[i % len(copies)]
                        return cuda(*a, plan=p, out_dtype=dt, block_n=bn,
                                    n_span=ns, k_span=ks)
                    row = dict(
                        kernel=kernel, geometry=geometry, case=shape,
                        shape=[m, k, n], groups=g, total_rows=total,
                        out_dtype=str(dt)[6:], input_copies=len(copies),
                        ms=graph_ms(call, iters=2 * len(copies), replays=3),
                        eager_ms=cuda_ms(call, iters=4), plain_ms=plain_ms,
                        bytes=in_bytes + dt.itemsize * g * k * n,
                        flops=2 * total * k * n,
                        peak_flop_per_s=FP8_FLOP_PER_S if fp8
                        else BF16_FLOP_PER_S,
                        max_abs_err=worst[kernel])
                    add_bound(row)
                    row["library_ms"], row["library_note"] = lib
                    WGRAD_GEOMETRY_TIMES[(kernel, geometry, shape,
                                          row["out_dtype"])] = row
                    emit({"phase": "kernel_time_wgrad_geometry", **row})
            del args, copies


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
    # the kernel takes the pool's geometries only; other tiles raise with
    # the resource model's reason
    for tile in UNBUILT_TILES:
        try:
            gk.gmm_cuda(*args, **{**kw, **tile, "plan": None})
            raise AssertionError(f"gmm accepted {tile}")
        except ValueError as exc:
            if "no CUDA variant" not in str(exc):
                raise
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
    for key, rows in check_wgrad_spans(gen, cpu_gen).items():
        results[key] += rows

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
    for tile in UNBUILT_TILES:
        try:
            gk.gmm_bf16_cuda(*bargs, **{**bkw, **tile, "plan": None})
            raise AssertionError(f"gmm_bf16 accepted {tile}")
        except ValueError as exc:
            if "no CUDA variant" not in str(exc):
                raise
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
    # B2, B7 and B5 at every pool geometry on the residue case
    for kernel, rows in check_residues(gen).items():
        results[kernel] += rows
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
    # B2, B7 and B5 at every block_m of the pool, at the same shapes
    block_ms = time_block_ms(gen, drawn)
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
    for kernel, shapes in block_ms.items():
        timing[kernel]["block_m_ms"] = shapes
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
    time_wgrad_geometries(gen, cpu_gen, worst)
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
# training paths' (batch 8 x seq 512): the routed gate/up (N 1408: span 1
# at block_n 128 only), and where every wgrad geometry is legal,
# qwen2-moe's shared experts' and recurrentgemma-2b's MLP gate/up (G = 1)
AUTOTUNE_SHAPES = {
    "gemm": (("qwen2-moe prefill", 1024, 2048, 1408, 60),
             ("deepseek p64 prefill", 1536, 2048, 1408, 64),
             ("qwen2-moe train", 16384, 2048, 1408, 60)),
    "gemm_bf16": (("qwen2-moe prefill", 1024, 2048, 1408, 60),
                  ("deepseek p64 prefill", 1536, 2048, 1408, 64),
                  ("qwen2-moe train", 16384, 2048, 1408, 60)),
    "gemm_quant": (("qwen2-moe prefill", 1024, 2048, 1408, 60),
                   ("deepseek p64 prefill", 1536, 2048, 1408, 64),
                   ("qwen2-moe train", 16384, 2048, 1408, 60)),
    "decode": (("qwen2-moe decode", 16, 2048, 1408, 60),
               ("deepseek decode", 24, 2048, 1408, 64)),
    "wgrad": (("qwen2-moe train", 16384, 2048, 1408, 60),
              ("deepseek train", 24576, 2048, 1408, 64),
              ("qwen2-moe shared train", 4096, 2048, 5632, 1),
              ("recurrentgemma gate/up train", 4096, 2560, 7680, 1)),
    "wgrad_fp8": (("qwen2-moe train", 16384, 2048, 1408, 60),
                  ("deepseek train", 24576, 2048, 1408, 64),
                  ("qwen2-moe shared train", 4096, 2048, 5632, 1),
                  ("recurrentgemma gate/up train", 4096, 2560, 7680, 1)),
}
# B2, B5 and B7 at every pool geometry against block_m 128 (block_n 128):
# name -> (M, K, N, G); the qwen2-moe routed prefill's gate (N 1408: no
# 256-wide tile) and down (N 2048: every geometry) and its decode, and
# minitron-8b's dense (G = 1) gate at a batch-4 decode step
ACROSS_BLOCK_M = {"qwen2-moe prefill": (1024, 2048, 1408, 60),
                  "qwen2-moe prefill down": (1024, 1408, 2048, 60),
                  "qwen2-moe decode": (16, 2048, 1408, 60),
                  "minitron-8b decode": (4, 4096, 16384, 1)}


def check_resources() -> list:
    """(a) Every built variant's shared memory in the static model equals
    what its launch asks (each library's ``kernel_resources`` query),
    the launch may ask it, the threads agree, the registers ptxas gave
    fit one SM at the CTAs an SM the kernel is meant to hold, and its
    thread-block cluster (the wgrads' geometries) has the model's CTAs
    and fits the card at least once."""
    from repro_torch.kernels import build
    from repro_torch.kernels import resources as res
    rows = []
    for v in res.variants():
        q = build.resources(v["library"], *v["args"])
        ctas = v["ctas_per_sm"] or 1
        fit = res.fits_sm(q["registers"], q["threads"], ctas, q["smem"])
        cluster = v.get("cluster_ctas", 1)
        row = {"phase": "autotune_resources", "kernel": v["kernel"],
               "variant": v["variant"], "model_smem": v["smem"],
               "card": q, "model_threads": v["threads"],
               "model_ctas_per_sm": v["ctas_per_sm"],
               "model_cluster_ctas": cluster, "fit": fit}
        emit(row)
        rows.append(row)
        if (q["smem"] != v["smem"] or q["max_dynamic_smem"] < q["smem"]
                or q["threads"] != v["threads"] or not fit["fits"]
                or q["ctas_per_sm"] < ctas or q["cluster_ctas"] != cluster
                or q["max_active_clusters"] < 1):
            raise AssertionError(f"resources {v['kernel']} {v['variant']}: "
                                 f"model {v} against the card's {q}, {fit}")
    return rows


def check_across_block_m() -> list:
    """(b) B2, B5 (w N- and K-contiguous) and B7 at every pool geometry
    whose block_n divides N, against block_m 128 at block_n 128 on the
    same operands: B2 and B5 within one bf16 step (the B2 gate), B7's
    dequantized values within one e4m3 step and one bf16 step (its gate);
    prints whether each is bitwise equal."""
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
        wt = wb.transpose(1, 2).contiguous().transpose(1, 2)
        del a, w

        def run(bm, bn):
            plan = make_tile_plan(sizes, m, block_m=bm, num_groups=g)
            kw = dict(num_groups=g, block_m=bm, block_n=bn, plan=plan)
            return {
                "gmm": gk.gmm_cuda(a8, sa, b8, sb, sizes, **kw).float(),
                "gmm_bf16": gk.gmm_bf16_cuda(xb, wb, sizes, **kw).float(),
                "gmm_bf16_wT": gk.gmm_bf16_cuda(xb, wt, sizes, **kw).float(),
                "gmm_quant": gk.gmm_quant_cuda(a8, sa, b8, sb, sizes, **kw)}
        want = run(128, 128)
        for bm, bn in pool_geometries():
            if n % bn or (bm, bn) == (128, 128):
                continue
            got = run(bm, bn)
            torch.cuda.synchronize()
            for kernel, y in got.items():
                y128 = want[kernel]
                if kernel == "gmm_quant":
                    bitwise = bool(torch.equal(y[0].view(torch.uint8),
                                               y128[0].view(torch.uint8))
                                   and torch.equal(y[1], y128[1]))
                    step = torch.maximum(
                        e4m3_step(y[0])
                        * torch.repeat_interleave(y[1], 128, 1),
                        e4m3_step(y128[0])
                        * torch.repeat_interleave(y128[1], 128, 1))
                    y, y128 = dequant(*y), dequant(*y128)
                else:
                    bitwise = bool(torch.equal(y, y128))
                    step = torch.zeros_like(y128)
                scale = float(y128.abs().max())
                err = (y - y128).abs()
                tol = step + y128.abs() * 2.0 ** -7 + 1e-4 * scale + 1e-30
                bad = int((err > tol).sum())
                row = {"phase": "autotune_across_block_m", "case": name,
                       "kernel": kernel, "shape": [m, k, n], "groups": g,
                       "block_m": bm, "block_n": bn, "against": [128, 128],
                       "bitwise_equal": bitwise,
                       "max_abs_err": float(err.max()),
                       "rel_to_max": float(err.max()) / scale if scale
                       else 0.0, "beyond_tolerance": bad}
                emit(row)
                rows.append(row)
                if bad or not torch.isfinite(y).all():
                    raise AssertionError(
                        f"{kernel} {name}: block_m {bm} / block_n {bn} and "
                        f"128 / 128 differ beyond tolerance at {bad} "
                        "elements, or not finite")
            del got
        del want, a8, sa, b8, sb, xb, wb, wt
    emit({"phase": "autotune_across_block_m_summary",
          "compared": len(rows),
          "bitwise_equal": sum(r["bitwise_equal"] for r in rows),
          "not_bitwise": [[r["case"], r["kernel"], r["block_m"], r["block_n"]]
                          for r in rows if not r["bitwise_equal"]]})
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
    AUTOTUNE_SHAPES, from an empty cache: every candidate the pool keeps
    measured, its ms beside the cost model's prediction, the winner
    measured with nothing skipped; a wgrad's candidates measured once a
    distinct (block_n, n_span, k_span), the others sharing that kernel's
    measurement; then the same call again, a cache hit that measures
    nothing."""
    from repro_torch.kernels import plan as plan_mod
    path = os.path.join(HERE, "build", "chip_smoke_autotune.json")
    if os.path.exists(path):
        os.remove(path)
    plan_mod.clear_cache_memo()
    rows, every = [], len(plan_mod.CONFIG_POOL)
    for op, shapes in AUTOTUNE_SHAPES.items():
        for label, m, k, n, g in shapes:
            with counting_measurements() as calls:
                t0 = time.perf_counter()
                cfg = plan_mod.autotune(m, k, n, g, op=op, cache_path=path,
                                        device="cuda", max_candidates=every)
                tune_s = time.perf_counter() - t0
                rep = plan_mod.last_autotune_report()
                n_first = len(calls)
                again = plan_mod.autotune(m, k, n, g, op=op, cache_path=path,
                                          device="cuda", max_candidates=every)
                hit = plan_mod.last_autotune_report()
            kernels = {(c["block_n"], c["n_span"], c["k_span"])
                       if op.startswith("wgrad") else tuple(c.values())
                       for c, _, _ in rep["candidates"]}
            row = {"phase": "autotune", "op": op, "shape": label,
                   "mkng": [m, k, n, g], "key": rep["key"],
                   "selected": cfg.to_dict(), "source": rep["source"],
                   "candidates": [{"block_m": c["block_m"],
                                   "block_n": c["block_n"],
                                   "n_span": c["n_span"],
                                   "k_span": c["k_span"],
                                   "predicted_ms": p * 1e3,
                                   "measured_ms": None if s is None
                                   else s * 1e3}
                                  for c, p, s in rep["candidates"]],
                   "shared": [[c["block_m"], first["block_m"],
                               [c["block_n"], c["n_span"], c["k_span"]]]
                              for c, first in rep["shared"]],
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
            kept = len(rep["candidates"])
            if (rep["skipped"] or rep["source"] != "measured"
                    or n_first != len(kernels)
                    or n_first + len(rep["shared"]) != kept
                    or any(c["measured_ms"] is None
                           for c in row["candidates"])
                    or again != cfg or not hit["cache_hit"]
                    or len(calls) != n_first):
                raise AssertionError(f"autotune {op} {label}: {row}")
    return rows


# the served MoE engines' decode selections, measured into the run's own
# cache (the one the serve phase's engines read): label -> (M, K, N, G)
# of the routed GEMM at the engine's decode_batch_size (8) x top_k
ENGINE_DECODE = {"qwen2-moe-a2.7b": (8 * 4, 2048, 1408, 60),
                 "deepseek-moe-16b": (8 * 6, 2048, 1408, 64)}


def select_engine_decode_tiles() -> None:
    """(e) The decode pool (block_m 8 and 16) measured on the card at each
    served MoE engine's decode shape into the run's tile-plan cache, so
    that the serve phase's engines take the measured tile: every
    candidate's ms beside the cost model's and the pick."""
    from repro_torch.kernels import plan as plan_mod
    for arch, (m, k, n, g) in ENGINE_DECODE.items():
        cfg = plan_mod.decode_config(m, k, n, g, device="cuda", measure=True,
                                     refresh=True)
        rep = plan_mod.last_autotune_report()
        row = {"phase": "autotune_engine_decode", "arch": arch,
               "mkng": [m, k, n, g], "key": rep["key"],
               "selected_block_m": cfg.block_m, "source": rep["source"],
               "candidates": [{"block_m": c["block_m"],
                               "predicted_ms": p * 1e3,
                               "measured_ms": None if t is None else t * 1e3}
                              for c, p, t in rep["candidates"]],
               "pruned": rep["pruned"], "skipped": rep["skipped"]}
        emit(row)
        if rep["source"] != "measured" or rep["skipped"] or any(
                c["measured_ms"] is None for c in row["candidates"]):
            raise AssertionError(f"engine decode selection {arch}: {row}")


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
    kernel's own query, (b) B2, B5 and B7 at every pool geometry against
    block_m 128, (c) a measured autotune and its cache hit, (e) the
    served engines' decode tiles measured, (d) the padded GEMM's host ops
    with the plan cache.  The serve phase checks the rest: the plan
    builds of the padded deepseek serve, and the MoE tokens of the
    selected decode tiles against the fixed 16-row rule's."""
    check_resources()
    free_memory()
    check_across_block_m()
    free_memory()
    check_autotune()
    free_memory()
    select_engine_decode_tiles()
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
    kernel ms, the device's busy share and the kernels by device time.
    Only the device's activity is traced: the host's operator events
    gave no row read here and tripled the profiler's own cost (~4.7 s
    against ~1.7 s a call on the H100, the same kernel rows)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
    exactly one ``decode_select`` for an MoE model, a decode-pool tile
    around the model's config; none for a dense one) and an Engine pinned
    to the fixed rule decode ran before it (the model's config with
    16-row tiles).  One generate of the pinned one, and of the selecting
    one where it took another tile, is the warm-up; returns ``(engine,
    pinned, its tokens)``."""
    import torch
    from repro_torch.analysis import events
    from repro_torch.kernels import plan as plan_mod
    from repro_torch.kernels.plan import KernelConfig
    from repro_torch.serve.engine import Engine
    cfg = model.cfg
    fixed_cfg = (cfg.resolved_kernel_config or KernelConfig()).with_(
        block_m=16)
    with events.capture() as evs:
        engine = Engine(model, params, max_new_tokens=new)
    selects = events.count(evs, "decode_select")
    dc = engine.decode_config
    if cfg.moe is not None and (
            selects != 1 or dc is None
            or dc.block_m not in plan_mod.DECODE_BLOCK_MS
            or dc != fixed_cfg.with_(block_m=dc.block_m)):
        raise AssertionError(f"{cfg.name}: {selects} decode selections, "
                             f"decode config {engine.decode_config}")
    if cfg.moe is None and (selects or engine.decode_config is not None):
        raise AssertionError(f"{cfg.name}: a dense model selected decode "
                             f"tiles {engine.decode_config}")
    fixed = Engine(model, params, max_new_tokens=new,
                   decode_kernel_config=fixed_cfg)
    tokens = fixed.generate(batch).tokens                  # warm-up
    if dc is not None and dc.block_m != fixed_cfg.block_m:
        # the selected tile's own warm-up (the padded baseline's plan
        # shapes differ by tile)
        engine.generate(batch)
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
              layers=None, sync_check: bool = False, contract=None):
    """One configuration, cut to ``layers`` (None: whole), serving
    ``batch`` on ``params``: a warm-up
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
    cfg = variant_config(variant, **({} if layers is None
                                     else {"num_layers": layers}))
    model = make_model(cfg, "cuda")
    padded = cfg.gemm_backend == PADDED_BASELINE
    if padded:
        # the padded GEMMs plan through the plan cache: from empty, each
        # static padded shape builds once, in the warm-up
        PLAN_CACHE.clear()
    # no tile configs given: prefill runs the model's config; an MoE
    # model's decode the decode pool's selection (8 or 16 rows, measured
    # by the autotune phase; the model's fuse_producer and backend), a
    # dense model's the model's;
    # the warm-up runs the fixed 16-row rule's engine, whose tokens the
    # selection must give bit for bit on an MoE model (and the selecting
    # engine where its tile differs)
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


# the serve phase's depth (None: whole): the MoE models cut to 8 layers
# (deepseek-moe-16b: its dense layer and 7 MoE layers) to keep the script
# within its time; deepseek is served whole in the distributed phase (in
# one process and under EP 4)
SERVE_LAYERS = {"fp8": 8, "qwen3_flash": None, "ds_fp8": 8}


def phase_serve():
    """Batch 4, 16 new tokens, greedy, depth as ``SERVE_LAYERS`` says.
    qwen2-moe-a2.7b, one param tree: each MoE configuration at prompt 64,
    then ``fp8`` and ``fp8_flash`` at prompt 512 (attention the only
    difference); then the full 28-layer qwen3-1.7b in ``qwen3_flash`` at
    prompt 512; then deepseek-moe-16b, one param tree, at prompt 64 and
    512 in ``ds_fp8`` and ``ds_fp8_padded``, whose tokens must be equal
    (the baseline is bitwise the padding-free GEMM).  Returns each run's
    launch counts by path name."""
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
        layers = SERVE_LAYERS[arch_variant]
        cfg = variant_config(arch_variant, **({} if layers is None
                                              else {"num_layers": layers}))
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
                    variant, params, batch, new, path, layers=layers,
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
# to 4).  For the script's time (a decode step here is host-bound, so
# its seconds follow the depth), yi-9b is cut to 8 of 48 layers,
# recurrentgemma-2b to 2 of its cycles (6 of 26) and xlstm-350m to one
# (6 of 24): the tensor_parallel and tp_recurrent phases serve each
# whole, in one process and under TP 4
ZOO_SERVE = {"yi_fp8_flash": (4, 512, 8), "minitron_fp8": (4, 64, None),
             "qwen110_fp8": (4, 64, 4), "pixtral_fp8_flash": (4, 128, None),
             "rg_fp8": (2, 2304, 6), "xlstm_bf16": (4, 512, 6),
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


# steps of the plain-version trajectory the kernels' is held against:
# with 3 warmup steps the learning rate of steps 0-3 is the same whatever
# the run's length (the cosine starts after the warmup), so these are the
# kernel run's first 2 steps, of which 1 updates the weights (2 for the
# script's time: a plain step of the fp8 MoE models takes seconds)
PLAIN_STEPS = 2


def phase_train(variant: str):
    """The configuration at full width, the MoE models cut to 4 layers,
    qwen3-1.7b whole: 8 steps of ``launch/train.py``'s ``train`` (bf16
    wgrad), and for ``fp8`` and ``ds_fp8`` then the same 8 with the fp8
    wgrad; launch counts exact, losses finite, and with the bf16 wgrad the
    loss falls; a profile of one step of each run; the first
    ``PLAIN_STEPS`` bf16-wgrad steps through the plain versions (but for
    ``ds_fp8_padded``, which
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
            # the first PLAIN_STEPS of them through the plain versions:
            # does the trajectory belong to the kernels?
            free_memory()
            with plain_kernels():
                plain = train(cfg, steps=PLAIN_STEPS, batch=batch, seq=seq,
                              lr=1e-3, warmup_steps=3, seed=0,
                              log_every=PLAIN_STEPS, device="cuda",
                              log=lambda line: None)
            # one step agrees to ~1e-4 (train-parity phase); Adam steps
            # through an lr of 1e-3 amplify that, so the trajectories are
            # held at 5e-2 of the plain loss, step by step
            pairs = list(zip(hist[:PLAIN_STEPS], plain.history,
                             strict=True))
            rel = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                      for a, b in pairs)
            emit({"phase": "train_plain", "config": variant, "losses":
                  [h["loss"] for h in plain.history], "grad_norms":
                  [h["grad_norm"] for h in plain.history],
                  "max_abs_loss_diff_vs_kernels": max(
                      abs(a["loss"] - b["loss"]) for a, b in pairs),
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


# recurrentgemma-2b trained on the card under every wgrad geometry: one
# block_pattern cycle at full width (d 2560, d_ff 7680, vocab 256000),
# fp8, remat, 2 steps of batch 8 x seq 512 under each kernel config (the
# model's own ``kernel_config``) at each wgrad precision; "span1" (block_m
# 128, block_n 128) is the witness whose gradients and params every other
# geometry's must equal bit for bit at each step
RG_GEOMETRY_TRAIN = {"arch": "recurrentgemma-2b", "batch": 8, "seq": 512,
                     "steps": 2}
# the block_m of a geometry's kernel config (the forward and dgrad GEMMs
# read it, the wgrads do not): span 2 at 256, the others at 128
RG_BLOCK_M = {"span2": 256}


def rg_geometry_configs() -> dict:
    """name -> the KernelConfig fields of each wgrad geometry's run."""
    return {name: {"block_m": RG_BLOCK_M.get(name, 128), "block_n": bn,
                   "n_span": ns, "k_span": ks}
            for name, (bn, ns, ks) in wgrad_geometries().items()}
# launches a layer of one step: one SwiGLU MLP (G = 1), its forward twice
# (remat), then its backward (PERF.md's FSDP + SP row of this model)
RG_TRAIN_PER_LAYER = {"quantize_tilewise": 7, "act_quantize": 2, "gmm": 9,
                      "wgrad": 3}


@contextlib.contextmanager
def recorded_steps(on_grads, on_params):
    """Run every step of ``launch.train.train`` as its own parts, in its
    order (``grad_fn``, then ``update``), calling ``on_grads(i, grads)``
    between them and ``on_params(i, params)`` after (AdamW updates the
    params in place: copy what must outlive the step)."""
    from repro_torch.launch import train as launch
    real = launch.make_train_step

    def make(*args, **kw):
        step, calls = real(*args, **kw), []

        def recorded(params, opt_state, batch):
            i = len(calls)
            calls.append(1)
            (loss, metrics), grads = step.grad_fn(params, batch)
            on_grads(i, grads)
            params, opt_state, opt_metrics = step.update(params, grads,
                                                         opt_state)
            on_params(i, params)
            return params, opt_state, {**metrics, **opt_metrics,
                                       "loss": loss}
        return recorded
    launch.make_train_step = make
    try:
        yield
    finally:
        launch.make_train_step = real


@contextlib.contextmanager
def wgrad_events(times):
    """Append to ``times`` a pair of CUDA events around every wgrad call
    (B4 or B6, through the kernel modules' public functions) on the
    stream: the device time between them is the call's."""
    import torch
    from repro_torch.kernels import wgrad_kernel as wk
    saved = (wk.gmm_wgrad, wk.gmm_wgrad_fp8)

    def timed_call(fn):
        def call(*a, **kw):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = fn(*a, **kw)
            ev[1].record()
            times.append(ev)
            return out
        return call
    wk.gmm_wgrad, wk.gmm_wgrad_fp8 = (timed_call(f) for f in saved)
    try:
        yield
    finally:
        wk.gmm_wgrad, wk.gmm_wgrad_fp8 = saved


def rg_witness_vs_plain(cfg, witness_grads, hist, batch) -> dict:
    """The witness's first step (its loss, grad norm and gradients, at the
    seeded init) against the plain versions' at the same params and
    batch, within the train-parity phase's bounds: loss 1e-2, grad norm
    2e-2 relative, each MLP weight's gradient 5e-2 of its largest."""
    import torch
    from repro_torch.models.model_zoo import make_model
    from repro_torch.optim.adamw import global_norm
    from repro_torch.train.trainer import value_and_grad
    from repro_torch.tree import tree_paths
    model = make_model(cfg, "cuda")
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0))
    with plain_kernels():
        (loss, _), grads = value_and_grad(model.loss, params, batch)
    norm = float(global_norm(grads))
    mlp = {}
    for (path, g), w in zip(tree_paths(grads), witness_grads):
        if "/mlp/" in path:
            g = g.float()
            mlp[path] = float((w.float() - g).abs().max() / g.abs().max())
    del params, grads
    rec = {"loss_kernels": hist[0]["loss"], "loss_plain": float(loss),
           "loss_abs_err": abs(hist[0]["loss"] - float(loss)),
           "grad_norm_kernels": hist[0]["grad_norm"], "grad_norm_plain": norm,
           "grad_norm_rel_err": abs(hist[0]["grad_norm"] - norm) / norm,
           "mlp_grad_rel_to_max": mlp, "bounds": [1e-2, 2e-2, 5e-2]}
    if not (rec["loss_abs_err"] <= 1e-2 and rec["grad_norm_rel_err"] <= 2e-2
            and max(mlp.values()) <= 5e-2):
        raise AssertionError(f"recurrentgemma witness vs plain: {rec}")
    return rec


def phase_rg_geometries() -> dict:
    """recurrentgemma-2b (RG_GEOMETRY_TRAIN) trained through
    ``launch.train.train`` under each geometry's kernel config
    (:func:`rg_geometry_configs`), at the bf16 and the fp8 wgrad: every
    step's gradients (before AdamW) and updated params bitwise the span-1
    witness's, the witness's first step within the train-parity bounds
    of the plain versions, launch counts exact (RG_TRAIN_PER_LAYER; B6 in B4's place under the
    fp8 wgrad), and every wgrad launch at the run's own geometry (the
    wrappers' ``launches_by_geometry``).  Then one more step with nothing
    recorded: its ms (CUDA events), the wgrad calls' share of it (CUDA
    events around each call) and its peak memory, beside the bytes of the
    witness's copies that peak includes (they stay on the card for the
    comparisons: host copies cost the phase more time than it has), a
    line each.  Returns the witness runs' launch counts by path name; the
    others' go to RG_GEOMETRY_RUNS."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import wgrad_kernel as wk
    from repro_torch.kernels.plan import KernelConfig
    from repro_torch.launch.train import train
    from repro_torch.tree import tree_leaves
    t = RG_GEOMETRY_TRAIN
    base = get_config(t["arch"])
    base = dataclasses.replace(base, precision="fp8",
                               num_layers=len(base.block_pattern))
    paths = {}
    for prec in ("bf16", "fp8"):
        name = "wgrad_fp8" if prec == "fp8" else "wgrad"
        wrapper = wk.gmm_wgrad_fp8_cuda if prec == "fp8" else \
            wk.gmm_wgrad_cuda
        witness = {}
        for geometry, fields in rg_geometry_configs().items():
            cfg = dataclasses.replace(base, kernel_config=KernelConfig(
                **fields, wgrad_precision=prec))
            first = geometry == "span1"
            differ = {"grads": [], "params": []}
            record, times = [True], []

            def keep(i, kind, tree, first=first, differ=differ,
                     record=record):
                if not record[0]:
                    return
                leaves = tree_leaves(tree)
                if first:
                    witness[(i, kind)] = [x.clone() for x in leaves]
                else:
                    differ[kind].append(sum(
                        not torch.equal(a, b)
                        for a, b in zip(leaves, witness[(i, kind)])))
            free_memory()
            reset_counts()
            with recorded_steps(lambda i, g: keep(i, "grads", g),
                                lambda i, p: keep(i, "params", p)), \
                    wgrad_events(times):
                run = train(cfg, steps=t["steps"], batch=t["batch"],
                            seq=t["seq"], lr=1e-3, warmup_steps=3, seed=0,
                            device="cuda", log=lambda line: None)
                torch.cuda.synchronize()
                counts = read_counts()
                by_geometry = dict(wrapper.launches_by_geometry)
                record[0] = False
                times.clear()
                nxt = run.data.batch_at(t["steps"])
                free_memory()
                torch.cuda.reset_peak_memory_stats()
                # its outputs dropped: they would keep this run's params
                # and AdamW state alive into the next run
                step_ms = event_ms(lambda: run.step_fn(
                    run.params, run.opt_state, nxt))[1]
                kept = sum(x.numel() * x.element_size()
                           for leaves in witness.values() for x in leaves)
                peak = torch.cuda.max_memory_allocated()
                wgrad_ms = sum(a.elapsed_time(b) for a, b in times)
            hist = run.history
            batch0 = run.data.batch_at(0)
            del run, nxt
            expect = expected(RG_TRAIN_PER_LAYER,
                              kernel_layers(cfg) * t["steps"])
            if prec == "fp8":
                expect["wgrad_fp8"], expect["wgrad"] = expect["wgrad"], 0
            geo = (fields["block_n"], fields["n_span"], fields["k_span"])
            rec = {"phase": "train_rg_geometry", "arch": cfg.name,
                   "geometry": geometry, "kernel_config": fields,
                   "wgrad_precision": prec, "layers": cfg.num_layers,
                   "params": cfg.param_count(), "batch": t["batch"],
                   "seq": t["seq"], "steps": t["steps"],
                   "losses": [h["loss"] for h in hist],
                   "grad_norms": [h["grad_norm"] for h in hist],
                   "recorded_step_ms": [h["step_ms"] for h in hist],
                   "step_ms": step_ms, "wgrad_ms": wgrad_ms,
                   "wgrad_share": wgrad_ms / step_ms,
                   "max_memory_allocated_gb": peak / 1e9,
                   "witness_gb": kept / 1e9,
                   "peak_less_witness_gb": (peak - kept) / 1e9,
                   "launches": counts, "expected_launches": expect,
                   "wgrad_launches_by_geometry": {
                       str(list(g)): c for g, c in by_geometry.items()},
                   "wgrad_launches_at_geometry": by_geometry.get(geo, 0),
                   "grad_leaves_not_bitwise_witness": differ["grads"],
                   "param_leaves_not_bitwise_witness": differ["params"]}
            if first:
                rec["vs_plain"] = rg_witness_vs_plain(
                    cfg, witness[(0, "grads")], hist, batch0)
            del batch0
            emit(rec)
            if counts != expect:
                raise AssertionError(f"train rg {geometry} ({prec} wgrad): "
                                     f"launch counts {counts} != {expect}")
            if by_geometry != {geo: expect[name]}:
                raise AssertionError(f"train rg {geometry} ({prec} wgrad): "
                                     f"{name} launches by geometry "
                                     f"{by_geometry}, not {expect[name]} "
                                     f"at {geo} alone")
            if not all(math.isfinite(h["loss"]) for h in hist):
                raise AssertionError(f"train rg {geometry}: losses "
                                     f"{rec['losses']}")
            if any(differ["grads"]) or any(differ["params"]) or (
                    not first and len(differ["grads"]) != t["steps"]):
                raise AssertionError(f"train rg {geometry} ({prec} wgrad): "
                                     f"not bitwise the span-1 witness: "
                                     f"{differ}")
            RG_GEOMETRY_RUNS[(geometry, prec)] = rec
            if first:
                paths[f"train_rg_{prec}_wgrad"] = counts
        del witness
    free_memory()
    return paths


# the phase_rg_geometries runs: (geometry, wgrad precision) -> its line
RG_GEOMETRY_RUNS = {}


REMAT_VARIANTS = ("fp8", "ds_fp8")
#: the remat phase's cut and batch (the dry run traces the same)
REMAT_SHAPE = {"layers": 4, "batch": 8, "seq": 512}
#: what the dry run phase predicts, as the earlier phases measured it:
#: ``remat`` by variant (``phase_remat``'s records), ``fsdp`` the
#: fsdp_seq_parallel run's ranks (state bytes and collectives)
MEASURED = {"remat": {}, "fsdp": None}


def phase_remat(variant: str) -> None:
    """Remat on and off on one step's forward and backward: the
    configuration cut to 4 layers, batch 8, seq 512, one seeded param
    tree; each way a warm-up, then 3 timed calls (CUDA events) and the
    peak memory of the last (the other way's gradients wait on the
    host).  The gradients must be bitwise equal, and the peak with remat
    below the peak without."""
    import torch
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.model_zoo import make_model
    from repro_torch.train.trainer import value_and_grad
    from repro_torch.tree import tree_leaves
    rs = REMAT_SHAPE
    cfg = variant_config(variant, num_layers=rs["layers"])
    gen = torch.Generator(device="cuda").manual_seed(4)
    params = make_model(cfg, "cuda").init_params(gen)
    batch = SyntheticLM(DataConfig(seed=1, batch_size=rs["batch"],
                                   seq_len=rs["seq"]), cfg,
                        device="cuda").batch_at(0)
    rows, grads = {}, {}
    for remat in (True, False):
        loss_fn = make_model(dataclasses.replace(cfg, remat=remat),
                             "cuda").loss
        free_memory()
        value_and_grad(loss_fn, params, batch)                  # warm-up
        ms = []
        for _ in range(3):
            grads.pop(remat, None)
            # the allocator keeps the warm-up's cache: an emptied one
            # made the next call pay cudaMalloc (679.2 ms against 179.7)
            gc.collect()
            torch.cuda.reset_peak_memory_stats()
            ((loss, _), g), t = event_ms(
                lambda: value_and_grad(loss_fn, params, batch))
            ms.append(t)
            grads[remat] = (loss, tree_leaves(g))
            grad_bytes = leaf_bytes(g)
            del g
        grads[remat] = (grads[remat][0].cpu(),
                        [x.cpu() for x in grads[remat][1]])
        rows[remat] = {"forward_backward_ms": ms,
                       "forward_backward_ms_median": statistics.median(ms),
                       "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                       "grad_bytes": grad_bytes}
    (la, ga), (lb, gb) = grads[True], grads[False]
    unequal = [i for i, (a, b) in enumerate(zip(ga, gb))
               if not torch.equal(a, b)]
    rec = {"phase": "remat", "config": variant, "arch": cfg.name,
           "layers": cfg.num_layers, "batch": rs["batch"],
           "seq": rs["seq"],
           "params_bytes": leaf_bytes(params),
           "remat_on": rows[True], "remat_off": rows[False],
           "loss_bitwise": bool(torch.equal(la, lb)),
           "grad_leaves": len(ga), "grad_leaves_not_bitwise": unequal}
    emit(rec)
    MEASURED["remat"][variant] = rec
    del grads, ga, gb, params
    free_memory()
    if unequal or not rec["loss_bitwise"]:
        raise AssertionError(f"remat {variant}: {len(unequal)} gradient "
                             f"leaves differ with remat on and off")
    if not rows[True]["peak_gb"] < rows[False]["peak_gb"]:
        raise AssertionError(f"remat {variant}: peak {rows[True]['peak_gb']}"
                             f" GB with remat, {rows[False]['peak_gb']} "
                             f"without")


def phase_checkpoint() -> None:
    """``ds_fp8`` cut to 2 layers (its dense layer and one MoE layer):
    4 steps of ``train`` saving a checkpoint after step 3 into ``build/``;
    then ``train`` resumes from the directory and runs step 4.  The state
    its restore fills (params, AdamW's m, v and f32 masters, the step;
    every leaf set to NaN, or -1, first) must equal the live state leaf
    by leaf, and the loss of the next batch (forward only) from the
    restored params must be bitwise the live params', read before the
    resumed step updates them.  The directory is deleted at the end."""
    import shutil
    import torch
    from repro_torch.checkpoint import checkpointer as ckpt
    from repro_torch.launch.train import train
    from repro_torch.models.model_zoo import make_model
    from repro_torch.tree import tree_leaves
    cfg = variant_config("ds_fp8", num_layers=2)
    d = os.path.join(HERE, "build", "chip_smoke_ckpt")
    shutil.rmtree(d, ignore_errors=True)
    kw = dict(batch=8, seq=512, lr=1e-3, warmup_steps=3, seed=0,
              log_every=1, device="cuda", ckpt_dir=d, save_every=4)
    stamps, seen = [], {}

    def log(line):
        stamps.append((time.perf_counter(), line))
        print("checkpoint", line, flush=True)
    real_restore = ckpt.restore_latest
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
        model = make_model(cfg, "cuda")
        nxt = run.data.batch_at(4)
        with torch.no_grad():
            loss_live = model.loss(run.params, nxt)[0]

        def checked(ckpt_dir, like, **rkw):
            # the resumed run's own restore, checked before its step
            for x in tree_leaves(like):
                x.fill_(float("nan") if x.is_floating_point() else -1)
            t0 = time.perf_counter()
            restored, meta, s = real_restore(ckpt_dir, like, **rkw)
            torch.cuda.synchronize()
            seen.update(restore_s=time.perf_counter() - t0, meta=meta, s=s)
            pairs = zip(tree_leaves(restored), tree_leaves(live),
                        strict=True)
            seen["unequal"] = sum(not torch.equal(a, b) for a, b in pairs)
            with torch.no_grad():
                seen["loss"] = model.loss(restored["params"], nxt)[0]
            return restored, meta, s
        ckpt.restore_latest = checked
        stamps.clear()
        resumed = train(cfg, steps=5, log=log, **kw)
        ckpt.restore_latest = real_restore
        resumed_log = [line for _, line in stamps if "[resume]" in line]
        resumed_steps = [h["step"] for h in resumed.history]
        resumed_loss = resumed.history[-1]["loss"]
        del resumed, run, live
    finally:
        ckpt.restore_latest = real_restore
        shutil.rmtree(d, ignore_errors=True)
    free_memory()
    if not seen:
        raise AssertionError("checkpoint: the resumed run restored nothing")
    s, meta, unequal = seen["s"], seen["meta"], seen["unequal"]
    loss_restored = seen["loss"]
    same = torch.equal(loss_live, loss_restored)
    rec = {"phase": "checkpoint", "config": "ds_fp8", "layers": 2,
           "params": cfg.param_count(), "saved_step": s, "meta_step":
           meta["step"], "leaves": meta["num_leaves"],
           "leaves_not_equal": unequal, "bytes_written": sum(nbytes.values()),
           "files": nbytes, "disk_free_bytes_after_save": free_bytes,
           "save_s": t_saved - t_step, "restore_s": seen["restore_s"],
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


# ---------------------------------------------------------------------------
# phase 11: expert and data parallelism on ranks that share the card
# ---------------------------------------------------------------------------

# serving: deepseek-moe-16b cut to 8 layers (its dense layer and 7 MoE
# layers, as the serve phase cuts it) under EP 4 on a (1, 4) mesh, 4
# tokens (for the script's time: a decode step of the 4 ranks sharing
# the card takes ~2 s at 28 layers); training: its 2-layer cut (the dense
# layer and one MoE layer) under EP 2 x DP 2 on (2, 2), 2 steps, then
# its params restored on (1, 2)
DIST_SERVE = {"layers": 8, "batch": 4, "prompt": 64, "new": 4}
DIST_TRAIN = {"layers": 2, "batch": 8, "seq": 512, "steps": 2}
DIST_WHY = ("one card: NCCL takes one rank a device, so the ranks share "
            "cuda:0 over gloo; this drives the sharding, the EP packing, "
            "the kernels at the EP shapes and the collectives with their "
            "gradients, not NCCL between cards")
# under EP 4 deepseek's shared experts are sliced to 2816 / 4 = 704
# columns, no multiple of 128: every rank runs them as plain bf16
# matmuls, as the reference's shard_map does, and they launch nothing
SERVE_PER_LAYER["ds_fp8_ep4"] = {"quantize_tilewise": 1, "act_quantize": 1,
                                 "gmm": 3}
DS_LOGIT_TOL = 0.15        # deepseek's whole-model fp8 bound (ROADMAP C)
# the (2, 2) train against one process, within the padded train check's
# 1e-3: each step's loss and grad norm against one process's at the
# params the (2, 2) step started from (step 0: the same init; steps 1-3:
# the run's own params, gathered), and the next batch's loss from the
# saved params
DIST_TRAIN_TOL = 1e-3


@contextlib.contextmanager
def packed_tails():
    """Record, for every routed down GEMM the MoE layer runs, its packed
    rows, ``sum(group_sizes)`` and the nonzero elements past it."""
    from repro_torch.core import moe
    real, seen = moe.grouped_linear_fused, []

    def fused(g, u, w, gs, **kw):
        y = real(g, u, w, gs, **kw)
        total = int(gs.sum())
        seen.append((y.shape[0], total, int((y[total:] != 0).sum())))
        return y
    moe.grouped_linear_fused = fused
    try:
        yield seen
    finally:
        moe.grouped_linear_fused = real


@contextlib.contextmanager
def step_params(keep):
    """Record on the host, into the list ``keep``, the params each step
    of ``launch.train.train`` after the first starts from (None: record
    nothing): copies into pinned buffers, queued on the stream before
    the step's update (the buffers' allocation falls inside the step's
    timed span; synchronize before reading them)."""
    import torch
    from repro_torch.launch import train as launch
    from repro_torch.tree import tree_map
    real = launch.make_train_step

    def pinned(x):
        return torch.empty(x.shape, dtype=x.dtype, pin_memory=True).copy_(
            x.detach(), non_blocking=True)

    def make(*args, **kw):
        step, calls = real(*args, **kw), []

        def recorded(params, opt_state, batch):
            if keep is not None and calls:
                keep.append(tree_map(pinned, params))
            calls.append(1)
            return step(params, opt_state, batch)
        return recorded
    launch.make_train_step = make
    try:
        yield
    finally:
        launch.make_train_step = real


def one_process_at(snaps, cfg, data, pspecs, mesh, f32=False) -> list:
    """``[(loss, grad_norm)]`` of one process (no mesh) at each of
    ``snaps`` (this rank's slices of the params steps 1, 2, ... started
    from, on the host), on that step's batch: the ranks that hold a
    part gather each snapshot onto rank 0, which computes; the others
    return [].  With ``f32``, each tuple adds the loss and grad norm of
    one process in f32 (the params upcast, plain products) at the same
    params and each leaf's grad norm there.  Also the seconds spent
    gathering and computing."""
    import torch.distributed as dist
    from repro_torch.distributed import sharding
    from repro_torch.tree import tree_map
    out, secs = [], {"gather": 0.0, "compute": 0.0}
    for i, snap in enumerate(snaps, start=1):
        t0 = time.perf_counter()
        full = sharding.gather_tree(snap, pspecs, mesh, dst=0)
        secs["gather"] += time.perf_counter() - t0
        if mesh.rank == 0:
            t0 = time.perf_counter()
            full = tree_map(lambda x: x.to("cuda"), full)
            out.append(loss_and_norm(cfg, full, data.batch_at(i), f32))
            secs["compute"] += time.perf_counter() - t0
        del full
    dist.barrier()
    return out, secs


def loss_and_norm(cfg, params, batch, f32=False) -> tuple:
    """One process's loss and grad norm at ``params`` on ``batch``; with
    ``f32`` those of the f32 model too (the params upcast, plain
    products, chunked attention) and each leaf's grad norm there (path
    -> norm)."""
    from repro_torch.models.model_zoo import make_model
    from repro_torch.optim import adamw
    from repro_torch.train.trainer import make_grad_fn
    from repro_torch.tree import tree_map, tree_paths
    (loss, _), grads = make_grad_fn(make_model(cfg, "cuda").loss)(params,
                                                                  batch)
    out = (float(loss), float(adamw.global_norm(grads)))
    del grads
    if f32:
        p32 = tree_map(lambda x: x.float(), params)
        (loss, _), grads = make_grad_fn(make_model(f32_of(cfg), "cuda").loss)(
            p32, batch)
        out += (float(loss), float(adamw.global_norm(grads)),
                {p: float(adamw.global_norm({"g": g}))
                 for p, g in tree_paths(grads)})
        del grads, p32
        free_memory()
    return out


def mesh_loss(model, params, batch, mesh) -> float:
    """The loss of the global ``batch`` (no gradient) on ``mesh``: each
    data rank's rows, averaged over the data group."""
    import torch
    from repro_torch.distributed import context as dctx
    from repro_torch.train.trainer import data_rows
    with torch.no_grad():
        loss = model.loss(params, data_rows(batch, mesh))[0].float()
    return float(dctx.all_reduce(loss, mesh.group("data"))
                 / mesh.shape["data"])


def leaves_equal_file(ckpt_dir: str, step: int, leaves) -> int:
    """How many of ``leaves`` differ from the checkpoint's arrays."""
    import numpy as np
    import torch
    from repro_torch.checkpoint.checkpointer import _from_numpy
    bad = 0
    with np.load(os.path.join(ckpt_dir, f"step_{step}", "arrays.npz")) as f:
        for i, x in enumerate(leaves):
            bad += not torch.equal(_from_numpy(f[f"a{i}"]).to(x.device), x)
    return bad


def event_ms(fn):
    """``fn()``'s result and its CUDA-event milliseconds on this rank's
    stream (ranks that share the card also wait on each other)."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def dist_rank(rank: int, world: int, ckpt_dir: str) -> dict:
    """One of 4 ranks on cuda:0: the EP 4 serve on (1, 4), then the
    EP 2 x DP 2 train on (2, 2), whose params it saves (full logical
    arrays) with the next batch's loss."""
    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint import checkpointer as ckpt
    from repro_torch.distributed import context as dctx
    from repro_torch.distributed import sharding
    from repro_torch.kernels import plan as plan_mod
    from repro_torch.launch.mesh import make_mesh, make_mesh_for
    from repro_torch.launch.train import train
    from repro_torch.models.model_zoo import make_model, synthetic_batch
    from repro_torch.models.transformer import storage_specs
    from repro_torch.serve.engine import Engine
    from repro_torch.tree import tree_leaves
    torch.cuda.set_device(0)
    os.environ[plan_mod.CACHE_ENV] = os.path.join(
        HERE, "build", f"tileplan_cache_rank{rank}.json")
    out = {}

    # serve: EP 4, 16 experts a rank, DIST_SERVE's layers
    mesh = make_mesh((1, world), ("data", "model"))
    s = DIST_SERVE
    cfg = variant_config("ds_fp8", num_layers=s["layers"])
    model = make_model(cfg, "cuda", mesh)
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init_params(gen)
    batch = synthetic_batch(gen, cfg, s["prompt"], s["batch"])
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cap = s["prompt"] + s["new"]
    engine = Engine(model, params, max_new_tokens=s["new"])
    with torch.inference_mode():
        engine.prefill(batch, cap)                              # warm-up
    torch.cuda.synchronize()
    dist.barrier()
    dctx.reset_collectives()
    reset_counts()
    res, gen_ms = event_ms(lambda: engine.generate(batch))
    counts = read_counts()
    colls = dict(dctx.COLLECTIVES)
    with torch.inference_mode():
        (last, _), prefill_ms = event_ms(lambda: engine.prefill(batch, cap))
        with packed_tails() as tails:
            engine.prefill(batch, cap)
    out["serve"] = {
        "mesh": list(mesh.sizes), "coords": mesh.coords,
        "experts_here": params["layers"][1]["moe"]["w_gate"].shape[0],
        "init_s": init_s, "generate_ms": gen_ms, "prefill_ms": prefill_ms,
        "decode_ms_per_step": (gen_ms - prefill_ms) / (s["new"] - 1),
        "collectives": colls, "launches": counts,
        "expected_launches": serve_expected("ds_fp8_ep4",
                                            kernel_layers(cfg), s["prompt"],
                                            s["new"]),
        "decode_block_m": decode_block_m(engine),
        "tail_checks": len(tails),
        "tail_nonzero": sum(t[2] for t in tails),
        "packed": [t[:2] for t in tails[:3]],
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "tokens": res.tokens.cpu()}
    if rank == 0:
        out["serve"]["last_logits"] = last.float().cpu()
    del engine, params, model, res, last, batch
    free_memory()
    dist.barrier()

    # train: EP 2 x DP 2, the 2-layer cut, through launch/train.py's train
    t = DIST_TRAIN
    mesh = make_mesh_for(world, model_parallel=2)
    cfg = variant_config("ds_fp8", num_layers=t["layers"])
    torch.cuda.reset_peak_memory_stats()
    dctx.reset_collectives()
    reset_counts()
    snaps = []
    with step_params(snaps if mesh.coord("data") == 0 else None):
        run = train(cfg, steps=t["steps"], batch=t["batch"], seq=t["seq"],
                    seed=0, device="cuda", mesh=mesh, log=lambda line: None)
    torch.cuda.synchronize()
    counts = read_counts()
    colls = dict(dctx.COLLECTIVES)
    peak = torch.cuda.max_memory_allocated()
    state = {"params": run.params}
    pspecs = storage_specs(run.params, cfg, mesh)
    specs = sharding.tree_specs(state, pspecs)
    experts_here = run.params["layers"][1]["moe"]["w_gate"].shape[0]
    t0 = time.perf_counter()
    ckpt.save(ckpt_dir, t["steps"] - 1, state, mesh=mesh, specs=specs)
    save_s = time.perf_counter() - t0
    full = sharding.gather_tree(state, specs, mesh)
    unequal = leaves_equal_file(ckpt_dir, t["steps"] - 1,
                                tree_leaves(full)) if rank == 0 else None
    del full
    model = make_model(cfg, "cuda", mesh)
    next_loss = mesh_loss(model, run.params, run.data.batch_at(t["steps"]),
                          mesh)
    history, data = run.history, run.data
    del run, state, model
    free_memory()
    at_own, at_own_s = one_process_at(snaps, cfg, data, pspecs, mesh)
    del snaps
    out["train"] = {
        "mesh": list(mesh.sizes), "coords": mesh.coords,
        "experts_here": experts_here,
        "history": [(h["loss"], h["grad_norm"], h["step_ms"])
                    for h in history],
        "one_process_at_own_params": at_own, "one_process_s": at_own_s,
        "launches": counts,
        "expected_launches": expected(TRAIN_PER_LAYER["ds_fp8"],
                                      kernel_layers(cfg) * t["steps"]),
        "collectives": colls, "peak_gb": peak / 1e9, "save_s": save_s,
        "saved_leaves_unequal": unequal, "next_loss": next_loss}
    return out


def elastic_rank(rank: int, world: int, ckpt_dir: str,
                 single_loss0: float) -> dict:
    """One of 2 ranks on cuda:0: restore the (2, 2) run's params onto
    (1, 2), check them against the file, and take the next batch's loss;
    then rank 0 alone runs one train step under NCCL (world size 1)."""
    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint import checkpointer as ckpt
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.distributed import context as dctx
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.launch.train import train
    from repro_torch.models.model_zoo import make_model
    from repro_torch.models.transformer import storage_specs
    from repro_torch.tree import tree_leaves
    torch.cuda.set_device(0)
    t = DIST_TRAIN
    mesh = make_mesh_for(world, model_parallel=2)
    cfg = variant_config("ds_fp8", num_layers=t["layers"])
    model = make_model(cfg, "cuda", mesh)
    state = {"params": model.init_params(
        torch.Generator(device="cuda").manual_seed(1))}
    specs = sharding.tree_specs(state, storage_specs(state["params"], cfg,
                                                      mesh))
    t0 = time.perf_counter()
    _, meta, step = ckpt.restore_latest(ckpt_dir, state, mesh=mesh,
                                        specs=specs)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    full = sharding.gather_tree(state, specs, mesh)
    unequal = leaves_equal_file(ckpt_dir, step, tree_leaves(full))
    del full
    data = SyntheticLM(DataConfig(seed=0, batch_size=t["batch"],
                                  seq_len=t["seq"]), cfg, device="cuda")
    out = {"mesh": list(mesh.sizes), "step": step,
           "experts_here":
               state["params"]["layers"][1]["moe"]["w_gate"].shape[0],
           "restore_s": restore_s, "leaves_unequal": unequal,
           "next_loss": mesh_loss(model, state["params"],
                                  data.batch_at(t["steps"]), mesh)}
    del state, model
    free_memory()
    dist.barrier()
    dist.destroy_process_group()
    if rank != 0:
        return out
    # one rank under NCCL: the production backend's device placement
    dist.init_process_group("nccl", rank=0, world_size=1,
                            store=dist.FileStore(os.path.join(
                                ckpt_dir, "nccl_store"), 1))
    dctx.reset_collectives()
    run = train(cfg, steps=1, batch=t["batch"], seq=t["seq"], seed=0,
                device="cuda", mesh=make_mesh_for(1), log=lambda line: None)
    probe = dctx.all_reduce(torch.ones(4, device="cuda"),
                            dist.group.WORLD)
    out["nccl"] = {"backend": dist.get_backend(), "world": 1,
                   "loss0": run.history[0]["loss"],
                   "loss0_bitwise_single_process":
                       run.history[0]["loss"] == single_loss0,
                   "collectives": dict(dctx.COLLECTIVES),
                   "all_reduce_ok": bool(torch.equal(
                       probe, torch.ones(4, device="cuda")))}
    return out


def time_b2_ep() -> list:
    """B2 at deepseek-moe-16b's routed gate shapes, one process alone on
    the card: the whole layer's (64 experts, M = every slot) beside EP 4
    rank 0's (its 16 experts' rows in a capacity buffer), at prefill
    (batch 4 x prompt 64, 128-row tiles) and decode (4 rows, 16-row
    tiles); each checked against the plain version, rows past
    sum(group_sizes) zero (``compare_gemm``)."""
    import torch
    from repro_torch.core.moe import _capacity
    from repro_torch.kernels import grouped_gemm_kernel as gk
    cpu = torch.Generator().manual_seed(5)
    gen = torch.Generator(device="cuda").manual_seed(5)
    k, n, top_k, e, ep = 2048, 1408, 6, 64, 4
    rows = []
    for phase, tokens, bm in (("prefill", 256, 128), ("decode", 4, 16)):
        full = routed_sizes(cpu, tokens, top_k, e)
        slots = tokens * top_k
        cap = _capacity(slots, ep, 2.0, align=bm)
        local = full[:e // ep].long()
        starts = torch.cumsum(local, 0) - local
        local = torch.minimum(local, cap - starts).clamp(min=0).int()
        for label, m, sizes in (("single", slots, full),
                                ("ep4_rank0", cap, local)):
            args, kw, plan = gemm_case(gen, m, k, n, sizes, bm,
                                       torch.bfloat16)
            check = compare_gemm(f"{phase}_{label}", args, kw, plan)
            total = int(sizes.sum())
            visited = int((sizes > 0).sum())
            kb, nb = k // 128, n // 128
            row = {"phase_of": phase, "layout": label, "shape": [m, k, n],
                   "groups": int(sizes.numel()), "total_rows": total,
                   "block_m": bm, "max_abs_err": check["max_abs_err"],
                   "ms": graph_ms(lambda i: gk.gmm_cuda(*args, **kw)),
                   "bytes": m * k + 4 * m * kb
                   + visited * (k * n + 4 * kb * nb) + 2 * m * n,
                   "flops": 2 * total * k * n}
            add_bound(row)
            rows.append(row)
    return rows


def phase_distributed() -> dict:
    """Expert and data parallelism (``repro_torch.launch.mesh``,
    ``distributed/``, the EP/TP branch of ``moe_apply``) on ranks that
    share the card over gloo, then one rank under NCCL.  Returns the
    launch counts of the two new paths (rank 0's; every rank's must be
    equal and exact)."""
    import shutil
    import torch
    from repro_torch.checkpoint import checkpointer as ckpt
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.ranks import run_ranks
    from repro_torch.launch.train import train
    from repro_torch.models.model_zoo import make_model, synthetic_batch
    from repro_torch.serve.engine import Engine
    t_phase = time.perf_counter()
    emit({"phase": "distributed_setup", "ranks": 4, "backend": "gloo",
          "device": "cuda:0", "why": DIST_WHY})
    t = DIST_TRAIN

    # the single-process training run the (2, 2) one is held against
    free_memory()
    cfg2 = variant_config("ds_fp8", num_layers=t["layers"])
    ref = train(cfg2, steps=t["steps"], batch=t["batch"], seq=t["seq"],
                seed=0, device="cuda", log=lambda line: None)
    single = [(h["loss"], h["grad_norm"]) for h in ref.history]
    del ref
    free_memory()
    b2 = time_b2_ep()
    emit({"phase": "distributed_b2", "rows": b2})
    free_memory()

    d = os.path.join(HERE, "build", "chip_smoke_elastic")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    try:
        t0 = time.perf_counter()
        ranks = run_ranks(dist_rank, 4, backend="gloo", store_dir=d,
                          args=(d,), timeout=600)
        ranks_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        elastic = run_ranks(elastic_rank, 2, backend="gloo", store_dir=d,
                            args=(d, single[0][0]), timeout=300)
        elastic_s = time.perf_counter() - t0
        # one process on the saved params: the next batch's loss
        model = make_model(cfg2, "cuda")
        state = {"params": model.init_params(
            torch.Generator(device="cuda").manual_seed(1))}
        ckpt.restore_latest(d, state)
        data = SyntheticLM(DataConfig(seed=0, batch_size=t["batch"],
                                      seq_len=t["seq"]), cfg2, device="cuda")
        with torch.no_grad():
            single_next = float(model.loss(state["params"],
                                           data.batch_at(t["steps"]))[0])
        del model, state
        free_memory()
    finally:
        shutil.rmtree(d, ignore_errors=True)

    # the same model in one process, teacher-forced on the EP tokens
    s = DIST_SERVE
    cfg = variant_config("ds_fp8", num_layers=s["layers"])
    model = make_model(cfg, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model.init_params(gen)
    batch = synthetic_batch(gen, cfg, s["prompt"], s["batch"])
    engine = Engine(model, params, max_new_tokens=s["new"])
    toks = ranks[0]["serve"]["tokens"].cuda()
    with torch.inference_mode():
        last, cache = engine.prefill(batch, s["prompt"] + s["new"])
        ref_logits = [last.float()]
        for i in range(s["new"] - 1):
            lg, cache = engine.decode_step(toks[:, i], cache)
            ref_logits.append(lg.float())
    ep_last = ranks[0]["serve"]["last_logits"].cuda()
    prefill_err = float((ep_last - ref_logits[0]).abs().max()
                        / ref_logits[0].abs().max())
    off_tokens, argmax_equal = 0, 0
    for i, lg in enumerate(ref_logits):
        pick = lg.gather(1, toks[:, i:i + 1])[:, 0]
        top = lg.max(-1).values
        off_tokens += int((pick < top - DS_LOGIT_TOL
                           * lg.abs().max(-1).values).sum())
        argmax_equal += int((toks[:, i] == lg.argmax(-1)).sum())
    del engine, params, model, cache, ref_logits, last, ep_last
    free_memory()

    serve = [r["serve"] for r in ranks]
    train_ = [r["train"] for r in ranks]
    tokens_equal = all(torch.equal(x["tokens"], serve[0]["tokens"])
                       for x in serve)
    emit({"phase": "distributed_serve", "arch": cfg.name,
          "layers": cfg.num_layers, "mesh": serve[0]["mesh"],
          "experts_per_rank": serve[0]["experts_here"], **s,
          "tokens_equal_across_ranks": tokens_equal,
          "prefill_logits_err_rel_to_max": prefill_err,
          "tol": DS_LOGIT_TOL, "tokens_argmax_equal": argmax_equal,
          "tokens_beyond_tol": off_tokens,
          "tokens": serve[0]["tokens"][0].tolist(),
          "ranks": [{k: v for k, v in x.items()
                     if k not in ("tokens", "last_logits")} for x in serve]})
    losses = [h[0] for h in train_[0]["history"]]
    # one process at the params each (2, 2) step started from
    own = [single[0]] + [tuple(x) for x in
                         train_[0]["one_process_at_own_params"]]
    emit({"phase": "distributed_train", "arch": cfg2.name,
          "layers": t["layers"], "mesh": train_[0]["mesh"],
          "experts_per_rank": train_[0]["experts_here"], **t,
          "losses": losses,
          "grad_norms": [h[1] for h in train_[0]["history"]],
          "one_process_at_own_params": own, "tol": DIST_TRAIN_TOL,
          "single_process_trajectory": single,
          "next_loss": train_[0]["next_loss"],
          "next_loss_single_process_saved_params": single_next,
          "ranks": [{k: v for k, v in x.items() if k != "history"}
                    | {"step_ms": [h[2] for h in x["history"]]}
                    for x in train_]})
    emit({"phase": "distributed_elastic", "saved_on": train_[0]["mesh"],
          "restored_on": elastic[0]["mesh"], "ranks": [
              {k: v for k, v in x.items() if k != "nccl"}
              for x in elastic],
          "next_loss_saved_mesh": train_[0]["next_loss"]})
    emit({"phase": "distributed_nccl", **elastic[0]["nccl"]})
    seconds = time.perf_counter() - t_phase
    emit({"phase": "distributed", "seconds": seconds,
          "four_ranks_s": ranks_s, "two_ranks_s": elastic_s})

    failures = []
    for r, x in enumerate(serve):
        if x["launches"] != x["expected_launches"]:
            failures.append(f"serve rank {r}: launches {x['launches']}")
        if x["tail_nonzero"] or not x["tail_checks"]:
            failures.append(f"serve rank {r}: {x['tail_nonzero']} nonzero "
                            f"rows past sum(group_sizes)")
    for r, x in enumerate(train_):
        if x["launches"] != x["expected_launches"]:
            failures.append(f"train rank {r}: launches {x['launches']}")
        if [h[:2] for h in x["history"]] != \
                [h[:2] for h in train_[0]["history"]]:
            failures.append(f"train rank {r}: history differs from rank 0")
    if not tokens_equal:
        failures.append("serve: tokens differ between ranks")
    if not prefill_err <= DS_LOGIT_TOL or off_tokens:
        failures.append(f"serve: prefill logits {prefill_err} of max, "
                        f"{off_tokens} tokens beyond the bound")
    if not losses[-1] < losses[0]:
        failures.append(f"train: loss did not fall {losses}")
    if len(own) != t["steps"]:
        failures.append(f"train: one process at {len(own)} steps")
    for i, (h, (l1, n1)) in enumerate(zip(train_[0]["history"], own)):
        if abs(h[0] - l1) > DIST_TRAIN_TOL * abs(l1) or \
                abs(h[1] - n1) > DIST_TRAIN_TOL * abs(n1):
            failures.append(f"train: step {i} loss, grad norm {h[:2]} vs "
                            f"{(l1, n1)} in one process at its params")
    if abs(single_next - train_[0]["next_loss"]) > \
            DIST_TRAIN_TOL * abs(single_next):
        failures.append(f"train: next loss {train_[0]['next_loss']} vs "
                        f"{single_next} in one process on the saved params")
    if train_[0]["saved_leaves_unequal"]:
        failures.append("elastic: the saved file differs from the live "
                        "params")
    for r, x in enumerate(elastic):
        if x["leaves_unequal"] or x["step"] != t["steps"] - 1:
            failures.append(f"elastic rank {r}: {x['leaves_unequal']} "
                            f"leaves differ (step {x['step']})")
        if abs(x["next_loss"] - train_[0]["next_loss"]) > \
                DIST_TRAIN_TOL * abs(train_[0]["next_loss"]):
            failures.append(f"elastic rank {r}: next loss {x['next_loss']} "
                            f"vs {train_[0]['next_loss']}")
    nccl = elastic[0]["nccl"]
    if not (nccl["loss0_bitwise_single_process"] and nccl["all_reduce_ok"]
            and nccl["collectives"]["calls"]):
        failures.append(f"nccl: {nccl}")
    if failures:
        raise AssertionError("distributed: " + "; ".join(failures))
    return {"serve_ds_fp8_ep4": serve[0]["launches"],
            "train_ds_fp8_ep2_dp2": train_[0]["launches"]}


# tensor parallelism (A15b-1): yi-9b whole served under TP 4 (bf16,
# flash: 8 q heads and 1 kv head a rank at prompt 128), qwen3-1.7b whole
# trained under (1, 4) with remat and flash (4 q heads, 2 kv heads a
# rank); 4 tokens and 2 steps, for the script's time (a decode step of
# the 4 ranks takes ~2 s)
TP_SERVE = {"arch": "yi-9b", "batch": 4, "prompt": 128, "new": 4}
TP_TRAIN = {"arch": "qwen3-1.7b", "batch": 4, "seq": 256, "steps": 2}
# yi-9b TP 4 against one process, both bf16, of the step's largest logit,
# at each of the 16 teacher-forced steps (prefill and 15 decode steps):
# each is ~2e-2 from one process in f32 (2.06e-2 at most on the H100),
# and two such errors may add; the steps read 1.84e-2 to 2.48e-2
TP_LOGIT_TOL = 4e-2
# against one process in f32: TP's error at most this multiple of one
# process's bf16 error, the largest over the steps each (read: 1.03)
TP_WITNESS_MULT = 1.5
TP_WHY = ("one card: NCCL takes one rank a device, so the 4 ranks share "
          "cuda:0 over gloo; times are of ranks sharing one card, and no "
          "NCCL between cards is exercised")


def tp_config(which: dict, **kw):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(which["arch"]), **FLASH, **kw)


def leaf_bytes(tree) -> int:
    from repro_torch.tree import tree_leaves
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


@contextlib.contextmanager
def kept_logits(engine, keep: list):
    """Append to ``keep`` an f32 copy of the logits each prefill and
    decode step of ``engine`` returns."""
    real = {name: getattr(engine, name) for name in ("prefill",
                                                     "decode_step")}

    def keeping(fn):
        def call(*a, **kw):
            logits, cache = fn(*a, **kw)
            keep.append(logits.float())
            return logits, cache
        return call
    for name, fn in real.items():
        setattr(engine, name, keeping(fn))
    try:
        yield keep
    finally:
        for name in real:
            delattr(engine, name)


def tp_rank(rank: int, world: int) -> dict:
    """One of 4 ranks on cuda:0, mesh (1, 4): yi-9b served whole, then
    qwen3-1.7b trained whole (remat on), each step's loss and grad norm
    beside one process's at the params the step started from."""
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import context as dctx
    from repro_torch.distributed.sharding import spec_axes
    from repro_torch.kernels import plan as plan_mod
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import train
    from repro_torch.models.model_zoo import make_model, synthetic_batch
    from repro_torch.models.transformer import storage_specs
    from repro_torch.optim import adamw
    from repro_torch.serve.engine import Engine
    from repro_torch.train.trainer import value_and_grad
    from repro_torch.tree import tree_leaves, tree_paths, tree_unflatten
    torch.cuda.set_device(0)
    os.environ[plan_mod.CACHE_ENV] = os.path.join(
        HERE, "build", f"tileplan_cache_tp{rank}.json")
    mesh = make_mesh((1, world), ("data", "model"))
    out = {}

    # serve: yi-9b, 48 layers, TP 4
    s = TP_SERVE
    cfg = tp_config(s)
    model = make_model(cfg, "cuda", mesh)
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init_params(gen)
    batch = synthetic_batch(gen, cfg, s["prompt"], s["batch"])
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    specs = storage_specs(params, cfg, mesh)
    whole = sum(x.numel() * x.element_size() for p, x in tree_paths(params)
                if not any(specs[p]))
    cap = s["prompt"] + s["new"]
    engine = Engine(model, params, max_new_tokens=s["new"])
    with torch.inference_mode():
        engine.prefill(batch, cap)                              # warm-up
    torch.cuda.synchronize()
    dist.barrier()
    dctx.reset_collectives()
    reset_counts()
    # every step's logits as the generate takes them (its decode steps
    # are fed its own tokens: teacher-forced on them)
    steps = []
    with kept_logits(engine, steps):
        res, gen_ms = event_ms(lambda: engine.generate(batch))
    counts = read_counts()
    colls = dict(dctx.COLLECTIVES)
    with torch.inference_mode():
        (last, cache), prefill_ms = event_ms(
            lambda: engine.prefill(batch, cap))
        lay = cache["layers"][0]
    out["serve"] = {
        "coords": mesh.coords, "init_s": init_s, "generate_ms": gen_ms,
        "prefill_ms": prefill_ms,
        "decode_ms_per_step": (gen_ms - prefill_ms) / (s["new"] - 1),
        "collectives": colls, "launches": counts,
        "expected_launches": {n: (cfg.num_layers if n == "flash_attention"
                                  else 0) for n in SOURCES},
        "weight_bytes": leaf_bytes(params), "whole_leaf_bytes": whole,
        "local_heads": {"q": params["layers"][0]["attn"]["wq"].shape[1]
                        // cfg.resolved_head_dim,
                        "kv": params["layers"][0]["attn"]["wk"].shape[1]
                        // cfg.resolved_head_dim},
        "cache_slots_here": lay["k"].shape[1],
        "cache_first_slot": lay.get("slot0"),
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "tokens": res.tokens.cpu().numpy()}
    if rank == 0:
        out["serve"]["step_logits"] = torch.stack(steps).cpu().numpy()
    del engine, params, model, res, last, batch, cache, lay, steps
    free_memory()
    dist.barrier()

    # train: qwen3-1.7b, 28 layers, TP 4, remat
    t = TP_TRAIN
    cfg = tp_config(t)
    torch.cuda.reset_peak_memory_stats()
    dctx.reset_collectives()
    reset_counts()
    snaps = []
    with step_params(snaps):
        run = train(cfg, steps=t["steps"], batch=t["batch"], seq=t["seq"],
                    seed=0, device="cuda", mesh=mesh, log=lambda line: None)
    torch.cuda.synchronize()
    counts = read_counts()
    colls = dict(dctx.COLLECTIVES)
    peak = torch.cuda.max_memory_allocated()
    pspecs = storage_specs(run.params, cfg, mesh)
    # one more step, split into forward, backward and AdamW by events
    nxt = run.data.batch_at(t["steps"])
    leaves = tree_leaves(run.params)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    for p in leaves:
        p.requires_grad_(True)
    ev[0].record()
    loss, _ = make_model(cfg, "cuda", mesh).loss(run.params, nxt)
    ev[1].record()
    grads = torch.autograd.grad(loss, leaves)
    ev[2].record()
    for p in leaves:
        p.requires_grad_(False)
    opt_cfg = adamw.OptConfig(lr=3e-4, total_steps=t["steps"] + 1,
                              warmup_steps=5, use_master=True)
    adamw.apply_updates(run.params, tree_unflatten(run.params, grads),
                        run.opt_state, opt_cfg,
                        axes=[spec_axes(pspecs[p]) for p, _ in
                              tree_paths(run.params)], mesh=mesh)
    ev[3].record()
    torch.cuda.synchronize()
    split = {"forward_ms": ev[0].elapsed_time(ev[1]),
             "backward_ms": ev[1].elapsed_time(ev[2]),
             "adamw_ms": ev[2].elapsed_time(ev[3])}
    del grads, loss, leaves
    history, data = run.history, run.data
    weight_bytes = leaf_bytes(run.params)
    del run
    free_memory()
    at_own, at_own_s = one_process_at(snaps, cfg, data, pspecs, mesh)
    del snaps
    step0 = None
    if rank == 0:
        full = make_model(cfg, "cuda").init_params(
            torch.Generator(device="cuda").manual_seed(0))
        (l0, _), g0 = value_and_grad(make_model(cfg, "cuda").loss, full,
                                     data.batch_at(0))
        step0 = (float(l0), float(adamw.global_norm(g0)))
        del full, g0
        free_memory()
    out["train"] = {
        "coords": mesh.coords,
        "history": [(h["loss"], h["grad_norm"], h["step_ms"])
                    for h in history],
        "one_process_at_own_params": ([step0] + at_own if rank == 0
                                      else []),
        "one_process_s": at_own_s, "launches": counts,
        "expected_launches": expected(TRAIN_PER_LAYER["qwen3_flash"],
                                      cfg.num_layers * t["steps"]),
        "collectives": colls, "peak_gb": peak / 1e9,
        "weight_bytes": weight_bytes, "split": split}
    return out


def phase_tensor_parallel() -> dict:
    """Dense tensor parallelism (``repro_torch.models`` under a mesh whose
    model axis is 4) on 4 ranks sharing the card over gloo: yi-9b whole
    served under TP 4 and held against one process, teacher-forced on its
    tokens (every step's logits against one process's in bf16, and
    against one process's in f32 no further than one process's bf16
    are), its weight bytes a rank against the whole
    leaves plus a quarter of the rest; qwen3-1.7b whole trained under
    (1, 4) with remat, every step's loss and grad norm within 1e-3 of one
    process's at the params the step started from.  Returns the launch
    counts of the two paths (rank 0's; every rank's exact)."""
    import numpy as np
    import torch
    from repro_torch.launch.ranks import run_ranks
    from repro_torch.models.model_zoo import make_model, synthetic_batch
    from repro_torch.serve.engine import Engine
    from repro_torch.tree import tree_map
    t_phase = time.perf_counter()
    emit({"phase": "tensor_parallel_setup", "ranks": 4, "mesh": [1, 4],
          "backend": "gloo", "device": "cuda:0", "why": TP_WHY})
    free_memory()
    t0 = time.perf_counter()
    d = os.path.join(HERE, "build", "chip_smoke_tp")
    os.makedirs(d, exist_ok=True)
    ranks = run_ranks(tp_rank, 4, backend="gloo", store_dir=d, timeout=900)
    ranks_s = time.perf_counter() - t0

    # yi-9b in one process, teacher-forced on the ranks' tokens: in bf16
    # (the path the ranks split), then in f32 (the same bf16 weights
    # upcast, chunked attention), the witness both are held against
    s = TP_SERVE
    cfg = tp_config(s)
    cap = s["prompt"] + s["new"]
    free_memory()
    torch.cuda.reset_peak_memory_stats()
    model = make_model(cfg, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model.init_params(gen)
    batch = synthetic_batch(gen, cfg, s["prompt"], s["batch"])
    one_bytes = leaf_bytes(params)
    toks = torch.from_numpy(ranks[0]["serve"]["tokens"]).cuda()

    def teacher_forced(engine):
        with torch.inference_mode():
            last, cache = engine.prefill(batch, cap)
            out = [last.float()]
            for i in range(s["new"] - 1):
                lg, cache = engine.decode_step(toks[:, i], cache)
                out.append(lg.float())
        return torch.stack(out)                    # [steps, B, V]
    one = teacher_forced(Engine(model, params, max_new_tokens=s["new"]))
    one_peak = torch.cuda.max_memory_allocated()
    params = tree_map(lambda x: x.float(), params)
    free_memory()
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32,
                                attn_backend="chunked")
    f32 = teacher_forced(Engine(make_model(cfg32, "cuda"), params,
                                max_new_tokens=s["new"]))
    del params, model
    free_memory()
    tp = torch.from_numpy(ranks[0]["serve"]["step_logits"]).cuda()

    def rel(a, b):          # each step's max error, of its largest logit
        return ((a - b).abs().amax(dim=(1, 2))
                / b.abs().amax(dim=(1, 2))).tolist()
    err = {"tp_vs_one": rel(tp, one), "tp_vs_f32": rel(tp, f32),
           "one_vs_f32": rel(one, f32)}
    # each token the ranks took: its logit in one process within the
    # bound of that row's top logit, and how many are the argmax
    pick = one.gather(2, toks.T[:, :, None])[..., 0]
    top = one.max(-1).values
    off_tokens = int((pick < top - TP_LOGIT_TOL
                      * one.abs().amax(-1)).sum())
    argmax_equal = int((toks.T == one.argmax(-1)).sum())
    del one, f32, tp, toks
    free_memory()

    serve = [r["serve"] for r in ranks]
    tr = [r["train"] for r in ranks]
    n = len(ranks)
    whole = serve[0]["whole_leaf_bytes"]
    expect_bytes = whole + (one_bytes - whole) / n
    bytes_rel = abs(serve[0]["weight_bytes"] - expect_bytes) / expect_bytes
    tokens_equal = all(np.array_equal(x["tokens"], serve[0]["tokens"])
                       for x in serve)
    emit({"phase": "tensor_parallel_serve", "arch": cfg.name,
          "layers": cfg.num_layers, "mesh": [1, n], **s,
          "attn_backend": cfg.attn_backend, "precision": cfg.precision,
          "tokens_equal_across_ranks": tokens_equal,
          "logits_err_rel_to_max": err, "tol": TP_LOGIT_TOL,
          "witness_mult": TP_WITNESS_MULT,
          "tokens_argmax_equal": argmax_equal,
          "tokens_beyond_tol": off_tokens,
          "tokens": serve[0]["tokens"][0].tolist(),
          "weight_bytes_rank": serve[0]["weight_bytes"],
          "weight_bytes_one_process": one_bytes,
          "weight_bytes_whole_leaves": whole,
          "weight_bytes_expected_rank": expect_bytes,
          "weight_bytes_rel_err": bytes_rel,
          "peak_gb_one_process": one_peak / 1e9,
          "timing_note": "ms of ranks sharing one card",
          "ranks": [{k: v for k, v in x.items()
                     if k not in ("tokens", "step_logits")} for x in serve]})
    losses = [h[0] for h in tr[0]["history"]]
    own = tr[0]["one_process_at_own_params"]
    emit({"phase": "tensor_parallel_train", "arch": TP_TRAIN["arch"],
          "layers": 28, "mesh": [1, n], **TP_TRAIN, "remat": True,
          "attn_backend": "flash", "losses": losses,
          "grad_norms": [h[1] for h in tr[0]["history"]],
          "one_process_at_own_params": own, "tol": DIST_TRAIN_TOL,
          "timing_note": "ms of ranks sharing one card",
          "ranks": [{k: v for k, v in x.items()
                     if k not in ("history", "one_process_at_own_params")}
                    | {"step_ms": [h[2] for h in x["history"]]}
                    for x in tr]})
    seconds = time.perf_counter() - t_phase
    emit({"phase": "tensor_parallel", "seconds": seconds,
          "four_ranks_s": ranks_s})

    failures = []
    for r, x in enumerate(serve):
        if x["launches"] != x["expected_launches"]:
            failures.append(f"serve rank {r}: launches {x['launches']}")
        if x["local_heads"] != {"q": 8, "kv": 1}:
            failures.append(f"serve rank {r}: heads {x['local_heads']}")
        if x["cache_slots_here"] * n != s["prompt"] + s["new"]:
            failures.append(f"serve rank {r}: {x['cache_slots_here']} "
                            f"cache slots")
    for r, x in enumerate(tr):
        if x["launches"] != x["expected_launches"]:
            failures.append(f"train rank {r}: launches {x['launches']}")
        if [h[:2] for h in x["history"]] != \
                [h[:2] for h in tr[0]["history"]]:
            failures.append(f"train rank {r}: history differs from rank 0")
    if not tokens_equal:
        failures.append("serve: tokens differ between ranks")
    if not max(err["tp_vs_one"]) <= TP_LOGIT_TOL or off_tokens:
        failures.append(f"serve: logits {err['tp_vs_one']} of max, "
                        f"{off_tokens} tokens beyond the bound")
    if not max(err["tp_vs_f32"]) <= TP_WITNESS_MULT * max(err["one_vs_f32"]):
        failures.append(f"serve: against f32, TP {err['tp_vs_f32']} and "
                        f"one process {err['one_vs_f32']}")
    if not bytes_rel <= 0.02:
        failures.append(f"serve: weight bytes a rank {bytes_rel} off")
    if len(own) != TP_TRAIN["steps"]:
        failures.append(f"train: one process at {len(own)} steps")
    for i, (h, (l1, n1)) in enumerate(zip(tr[0]["history"], own)):
        if abs(h[0] - l1) > DIST_TRAIN_TOL * abs(l1) or \
                abs(h[1] - n1) > DIST_TRAIN_TOL * abs(n1):
            failures.append(f"train: step {i} loss, grad norm {h[:2]} vs "
                            f"{(l1, n1)} in one process at its params")
    if not all(math.isfinite(v) for v in losses):
        failures.append(f"train: losses {losses}")
    if failures:
        raise AssertionError("tensor_parallel: " + "; ".join(failures))
    return {"serve_yi_bf16_flash_tp4": serve[0]["launches"],
            "train_qwen3_flash_tp4": tr[0]["launches"]}


# A15b-2: the recurrent and audio families served whole under tensor
# parallelism (recurrentgemma-2b fp8 and xlstm-350m bf16 on (1, 4):
# recurrentgemma's 10 q heads do not divide 4 and run whole beside its
# split RG-LRU width and MLP; whisper-tiny fp8 + flash on (2, 2), TP 2),
# each teacher-forced against one process; then recurrentgemma-2b at full
# width, cut to one cycle, trained on (2, 2) under FSDP, sequence
# parallelism and remat.  One spawn of 4 ranks on cuda:0 runs both.
F32 = {"dtype": "float32"}      # the model in f32 (plain products)
TPR_SERVE = {
    # name: (arch, config fields, mesh, batch, prompt, new tokens)
    "rg_fp8_tp4": ("recurrentgemma-2b", {"precision": "fp8"}, (1, 4), 4,
                   128, 4),
    "rg_f32_tp4": ("recurrentgemma-2b", F32, (1, 4), 4, 128, 4),
    "xlstm_bf16_tp4": ("xlstm-350m", {}, (1, 4), 4, 256, 4),
    "xlstm_f32_tp4": ("xlstm-350m", F32, (1, 4), 4, 256, 4),
    "whisper_fp8_flash_tp2": ("whisper-tiny", {"precision": "fp8", **FLASH},
                              (2, 2), 4, 128, 4),
}
# each step's TP logits against one process in the same recipe, of the
# step's largest logit.  f32: no e4m3 rounding follows the ranks'
# partial sums, so only f32 reassociation and the decode caches' bf16,
# carried through the layers, separate them (read on the H100: 1.2e-4
# recurrentgemma, 1.6e-4 xlstm); a wrong channel, head or gate slice is
# O(1).
# The rounded recipes: their largest readings on the H100 (fp8
# recurrentgemma 0.199, its random-weight fp8 recipe 0.39 from f32 in one
# process; xlstm bf16 0.076; whisper fp8 0.029) with a quarter or more
# to spare, whisper at the tensor_parallel phase's bound
TPR_TOL = {"rg_fp8_tp4": 0.25, "rg_f32_tp4": 1e-3, "xlstm_bf16_tp4": 0.1,
           "xlstm_f32_tp4": 1e-3, "whisper_fp8_flash_tp2": TP_LOGIT_TOL}
# 2 steps, and 4 tokens a TPR_SERVE model, for the script's time (an FSDP
# + SP step and its TP-alone witnesses take ~40 s of ranks sharing the
# card)
FSDP_TRAIN = {"arch": "recurrentgemma-2b", "layers": 3, "batch": 4,
              "seq": 256, "steps": 2, "mesh": (2, 2)}
# each rounded recipe's TP logits against one process in f32 no further
# than this multiple of one process's own error (fp8 or bf16) against
# f32, the largest over the teacher-forced steps each (the
# tensor_parallel phase's witness)
TPR_WITNESS_MULT = 1.5
# the FSDP + SP run's fp8 grad norm against one process's fp8 recipe at
# the same params: TP's row-parallel partials, summed in another order,
# round to bf16 and then to e4m3 tiles differently.  The run equals TP
# alone, and TP alone in f32 equals one process in f32 within
# DIST_TRAIN_TOL, at each step's params; over seeds 0-3 on the H100
# (``--fsdp-seeds``) the fp8 gap read 2.9e-3 at most, the fp8 recipe
# itself 1.6e-2 from f32
FSDP_FP8_NORM_TOL = 1e-2


def f32_of(cfg):
    """``cfg`` in f32 with plain products and chunked attention."""
    import torch
    return dataclasses.replace(cfg, dtype=torch.float32, precision="bf16",
                               attn_backend="chunked")


def tpr_config(name: str, **kw):
    from repro_torch.configs import get_config
    arch, repl = TPR_SERVE[name][:2]
    cfg = dataclasses.replace(get_config(arch),
                              **{k: v for k, v in repl.items()
                                 if k != "dtype"}, **kw)
    return f32_of(cfg) if repl.get("dtype") == "float32" else cfg


def fsdp_config(**kw):
    from repro_torch.configs import get_config
    t = FSDP_TRAIN
    return dataclasses.replace(get_config(t["arch"]), precision="fp8",
                               num_layers=t["layers"], seq_shard=True, **kw)


def spec_bytes(state, pspecs, cfg, mesh) -> int:
    """Bytes a rank holds of ``state`` (the params, or a tree holding
    trees of their structure) by the specs' arithmetic on the logical
    shapes (``pspecs``: the params' storage specs)."""
    from repro_torch.distributed import sharding
    from repro_torch.models.transformer import param_shapes
    from repro_torch.tree import tree_paths
    shapes = param_shapes(cfg)
    specs = sharding.tree_specs(state, pspecs)
    n = 0
    for path, x in tree_paths(state):
        parts = path.split("/")
        shape = next((shapes[q] for q in ("/".join(parts[j:])
                                         for j in range(len(parts)))
                      if q in shapes), tuple(x.shape))
        n += sharding.local_numel(shape, specs[path], mesh) \
            * x.element_size()
    return n


def a15b2_rank(rank: int, world: int, seeds=(0,), serve=True) -> dict:
    """One of 4 ranks on cuda:0: with ``serve``, each TPR_SERVE model
    served whole (a warm-up prefill, then a timed generate whose steps'
    logits rank 0 keeps); then the FSDP_TRAIN run from each of ``seeds``
    (:func:`fsdp_rank_run`)."""
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import context as dctx
    from repro_torch.kernels import plan as plan_mod
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model_zoo import make_model, synthetic_batch
    from repro_torch.serve.engine import Engine
    torch.cuda.set_device(0)
    os.environ[plan_mod.CACHE_ENV] = os.path.join(
        HERE, "build", f"tileplan_cache_a15b2_{rank}.json")
    meshes = {s: make_mesh(s, ("data", "model")) for s in ((1, 4), (2, 2))}
    out = {"serve": {}, "train": {}}
    for name, (_, _, sizes, b, prompt, new) in (TPR_SERVE.items() if serve
                                                else ()):
        t_model = time.perf_counter()
        mesh = meshes[sizes]
        cfg = tpr_config(name)
        model = make_model(cfg, "cuda", mesh)
        gen = torch.Generator(device="cuda").manual_seed(0)
        free_memory()
        torch.cuda.reset_peak_memory_stats()
        params = model.init_params(gen)
        batch = synthetic_batch(gen, cfg, prompt, b)
        cap = prompt + new
        engine = Engine(model, params, max_new_tokens=new)
        with torch.inference_mode():
            engine.prefill(batch, cap)                          # warm-up
        torch.cuda.synchronize()
        dist.barrier()
        dctx.reset_collectives()
        reset_counts()
        steps = []
        with kept_logits(engine, steps):
            res, gen_ms = event_ms(lambda: engine.generate(batch))
        counts = read_counts()
        colls = dict(dctx.COLLECTIVES)
        with torch.inference_mode():
            _, prefill_ms = event_ms(lambda: engine.prefill(batch, cap))
        out["serve"][name] = {
            "coords": mesh.coords, "generate_ms": gen_ms,
            "prefill_ms": prefill_ms,
            "decode_ms_per_step": (gen_ms - prefill_ms) / (new - 1),
            "collectives": colls, "launches": counts,
            "expected_launches": zoo_expected(cfg, prompt, new),
            "weight_bytes": leaf_bytes(params),
            "weight_bytes_rule": spec_bytes(params, model.specs, cfg, mesh),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "tokens": res.tokens.cpu().numpy(),
            "step_logits": (torch.stack(steps).cpu().numpy() if rank == 0
                            else None),
            "seconds": time.perf_counter() - t_model}
        del engine, params, model, res, batch, steps
        free_memory()
        dist.barrier()
    for seed in seeds:
        t_train = time.perf_counter()
        out["train"][seed] = fsdp_rank_run(meshes[FSDP_TRAIN["mesh"]], seed)
        out["train"][seed]["seconds"] = time.perf_counter() - t_train
    return out


def fsdp_rank_run(mesh, seed: int) -> dict:
    """This rank's part of the FSDP_TRAIN run from ``seed`` (recurrentgemma
    at full width, one cycle, on (2, 2): FSDP, sequence parallelism,
    remat), then, at the params each step started from: one process's
    fp8 loss and grad norm and its f32 ones with each leaf's f32 grad
    norm (rank 0's), and TP alone's (no FSDP, no sequence parallelism)
    in fp8 and in f32 (with each leaf's)."""
    import torch
    from repro_torch.distributed import context as dctx
    from repro_torch.distributed.sharding import spec_axes, use_leaf
    from repro_torch.launch.train import train
    from repro_torch.models.model_zoo import make_model
    from repro_torch.models.transformer import storage_specs
    from repro_torch.optim import adamw
    from repro_torch.train.trainer import make_grad_fn
    from repro_torch.tree import tree_map, tree_paths, tree_unflatten
    t = FSDP_TRAIN
    cfg = fsdp_config()
    torch.cuda.reset_peak_memory_stats()
    dctx.reset_collectives()
    reset_counts()
    snaps = []
    t0 = time.perf_counter()
    with step_params(snaps):
        run = train(cfg, steps=t["steps"], batch=t["batch"], seq=t["seq"],
                    seed=seed, device="cuda", mesh=mesh, fsdp=True,
                    log=lambda line: None)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    counts = read_counts()
    colls = dict(dctx.COLLECTIVES)
    peak = torch.cuda.max_memory_allocated()
    state = {"params": run.params, "opt": run.opt_state}
    pspecs = storage_specs(run.params, cfg, mesh, fsdp=True)
    state_bytes = leaf_bytes(state)
    state_rule = spec_bytes(state, pspecs, cfg, mesh)
    state_no_fsdp = spec_bytes(state, storage_specs(run.params, cfg, mesh),
                               cfg, mesh)
    history, data = run.history, run.data
    del run, state
    free_memory()
    at_own, at_own_s = one_process_at(snaps, cfg, data, pspecs, mesh,
                                      f32=True)

    def loss_norm(model, params, specs, batch, leaves=False):
        (loss, _), grads = make_grad_fn(model.loss, mesh=mesh, specs=specs)(
            params, batch)
        axes = [spec_axes(specs[p]) for p, _ in tree_paths(grads)]
        out = (float(loss), float(adamw.global_norm(grads, axes=axes,
                                                    mesh=mesh)))
        if leaves:
            out += ({p: float(adamw.global_norm({"g": g}, axes=[a],
                                                mesh=mesh))
                     for (p, g), a in zip(tree_paths(grads), axes)},)
        return out

    # the same params under TP alone in fp8, which the run should equal,
    # and in f32, held against one process in f32 where no bf16 or e4m3
    # rounding follows the partial sums
    t0 = time.perf_counter()
    tp_cfg = dataclasses.replace(cfg, seq_shard=False)
    tp_model = make_model(tp_cfg, "cuda", mesh)
    tp_model32 = make_model(f32_of(tp_cfg), "cuda", mesh)
    tp_at, f32_at = [], []
    for i in range(t["steps"]):
        if i == 0:
            own = make_model(cfg, "cuda", mesh, fsdp=True).init_params(
                torch.Generator(device="cuda").manual_seed(seed))
        else:
            own = tree_map(lambda x: x.to("cuda"), snaps[i - 1])
        with torch.no_grad():
            params = tree_unflatten(own, [use_leaf(x, pspecs[p], mesh)
                                          for p, x in tree_paths(own)])
        del own
        tp_at.append(loss_norm(tp_model, params,
                               storage_specs(params, tp_cfg, mesh),
                               data.batch_at(i)))
        params = tree_map(lambda x: x.float(), params)
        f32_at.append(loss_norm(
            tp_model32, params, storage_specs(params, tp_model32.cfg, mesh),
            data.batch_at(i), leaves=True))
        del params
        free_memory()
    tp_s = time.perf_counter() - t0
    del snaps
    step0 = None
    if mesh.rank == 0:
        full = make_model(cfg, "cuda").init_params(
            torch.Generator(device="cuda").manual_seed(seed))
        step0 = loss_and_norm(cfg, full, data.batch_at(0), f32=True)
        del full
        free_memory()
    return {
        "coords": mesh.coords, "train_s": train_s,
        "history": [(h["loss"], h["grad_norm"], h["step_ms"])
                    for h in history],
        "one_process_at_own_params": ([step0] + at_own if mesh.rank == 0
                                      else []),
        "tp_alone_at_own_params": tp_at,
        "tp_alone_f32_at_own_params": f32_at, "tp_alone_s": tp_s,
        "one_process_s": at_own_s, "launches": counts, "collectives": colls,
        "peak_gb": peak / 1e9, "state_bytes": state_bytes,
        "state_bytes_rule": state_rule,
        "state_bytes_without_fsdp": state_no_fsdp}


def teacher_forced(model, params, batch, toks, cap: int, new: int):
    """One process's logits of a prefill and ``new - 1`` decode steps fed
    ``toks`` [B, new], stacked [steps, B, V] in f32."""
    import torch
    from repro_torch.serve.engine import Engine
    engine = Engine(model, params, max_new_tokens=new)
    with torch.inference_mode():
        last, cache = engine.prefill(batch, cap)
        out = [last.float()]
        for i in range(new - 1):
            lg, cache = engine.decode_step(toks[:, i], cache)
            out.append(lg.float())
    return torch.stack(out)


def check_serve(name: str, serve: list) -> "list[str]":
    """The tp_recurrent gates of the TPR_SERVE model ``name`` on the
    ranks' readings ``serve``: its every step teacher-forced in one
    process in its own recipe (TP within TPR_TOL of it) and, for a
    rounded recipe, in f32 (TP within TPR_WITNESS_MULT of one process's
    own error); launches and weight bytes a rank exact.  Emits its line
    and returns the failures."""
    import numpy as np
    import torch
    from repro_torch.models.model_zoo import make_model, synthetic_batch
    from repro_torch.tree import tree_map
    _, _, sizes, b, prompt, new = TPR_SERVE[name]
    cfg = tpr_config(name)
    rounded = cfg.dtype != torch.float32
    cap = prompt + new
    free_memory()
    torch.cuda.reset_peak_memory_stats()
    model = make_model(cfg, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model.init_params(gen)
    batch = synthetic_batch(gen, cfg, prompt, b)
    one_bytes = leaf_bytes(params)
    toks = torch.from_numpy(serve[0]["tokens"]).cuda()
    one = teacher_forced(model, params, batch, toks, cap, new)
    one_peak = torch.cuda.max_memory_allocated()
    f32 = one
    if rounded:
        params = tree_map(lambda x: x.float(), params)
        free_memory()
        f32 = teacher_forced(make_model(f32_of(cfg), "cuda"), params, batch,
                             toks, cap, new)
    del params, model
    free_memory()
    tp = torch.from_numpy(serve[0]["step_logits"]).cuda()

    def rel(a, b):      # each step's max error, of its largest logit
        return ((a - b).abs().amax(dim=(1, 2))
                / b.abs().amax(dim=(1, 2))).tolist()
    err = {"tp_vs_one": rel(tp, one), "tp_vs_f32": rel(tp, f32),
           "one_vs_f32": rel(one, f32)}
    argmax_equal = int((toks.T == one.argmax(-1)).sum())
    del one, f32, tp, toks
    free_memory()
    tokens_equal = all(np.array_equal(x["tokens"], serve[0]["tokens"])
                       for x in serve)
    emit({"phase": "tp_recurrent_serve", "config": name, "arch": cfg.name,
          "layers": cfg.num_layers, "mesh": list(sizes), "batch": b,
          "prompt": prompt, "new": new, "precision": cfg.precision,
          "dtype": str(cfg.dtype).removeprefix("torch."),
          "attn_backend": cfg.attn_backend,
          "tokens_equal_across_ranks": tokens_equal,
          "logits_err_rel_to_max": err,
          "largest_err_tp_vs_one": max(err["tp_vs_one"]),
          "tol": TPR_TOL[name],
          "witness_mult": TPR_WITNESS_MULT if rounded else None,
          "tokens_argmax_equal": argmax_equal,
          "tokens_total": int(serve[0]["tokens"].size),
          "weight_bytes_rank": serve[0]["weight_bytes"],
          "weight_bytes_rule": serve[0]["weight_bytes_rule"],
          "weight_bytes_one_process": one_bytes,
          "peak_gb_one_process": one_peak / 1e9,
          "timing_note": "ms of ranks sharing one card",
          "ranks": [{k: v for k, v in x.items()
                     if k not in ("tokens", "step_logits")}
                    for x in serve]})
    failures = []
    for r, x in enumerate(serve):
        if x["launches"] != x["expected_launches"]:
            failures.append(f"{name} rank {r}: launches {x['launches']}")
        if x["weight_bytes"] != x["weight_bytes_rule"]:
            failures.append(f"{name} rank {r}: {x['weight_bytes']} weight "
                            f"bytes, the rule's {x['weight_bytes_rule']}")
    if not tokens_equal:
        failures.append(f"{name}: tokens differ between ranks")
    if not all(map(math.isfinite, err["tp_vs_one"])) or \
            not max(err["tp_vs_one"]) <= TPR_TOL[name]:
        failures.append(f"{name}: TP vs one process {err['tp_vs_one']}, "
                        f"bound {TPR_TOL[name]}")
    if rounded and not max(err["tp_vs_f32"]) <= TPR_WITNESS_MULT * max(
            err["one_vs_f32"]):
        failures.append(f"{name}: against f32, TP {err['tp_vs_f32']} and "
                        f"one process {err['one_vs_f32']}")
    return failures


def check_fsdp(tr: list, seed: int) -> "list[str]":
    """The fsdp_seq_parallel gates on the ranks' readings ``tr`` of the
    run from ``seed``, at each step's params: the fp8 loss within
    DIST_TRAIN_TOL of one process's and the grad norm within
    FSDP_FP8_NORM_TOL; loss and grad norm within DIST_TRAIN_TOL of TP
    alone's; TP alone in f32: the loss, the grad norm and each leaf's
    grad norm within DIST_TRAIN_TOL of one process's; the ranks'
    histories and launches equal, B1-B4 launched, state bytes a rank
    exact.  Emits its line and returns the failures."""
    t = FSDP_TRAIN
    hist = tr[0]["history"]
    own = tr[0]["one_process_at_own_params"]
    tp_alone, f32 = tr[0]["tp_alone_at_own_params"], \
        tr[0]["tp_alone_f32_at_own_params"]

    def rel(a, b):
        return abs(a - b) / abs(b) if b else abs(a)
    steps = list(zip(hist, own, tp_alone, f32))
    readings = {
        "loss_vs_one": [rel(h[0], o[0]) for h, o, _, _ in steps],
        "grad_norm_vs_one": [rel(h[1], o[1]) for h, o, _, _ in steps],
        "one_grad_norm_vs_f32": [rel(o[1], o[3]) for _, o, _, _ in steps],
        "vs_tp_alone": [max(rel(h[0], a[0]), rel(h[1], a[1]))
                        for h, _, a, _ in steps],
        "tp_f32_loss_vs_one": [rel(f[0], o[2]) for _, o, _, f in steps],
        "tp_f32_grad_norm_vs_one": [rel(f[1], o[3])
                                    for _, o, _, f in steps],
        "tp_f32_worst_leaf": [max(((rel(f[2].get(p, math.inf), n), p)
                                for p, n in o[4].items()),
                               default=(math.inf, None))
                           for _, o, _, f in steps]}
    losses = [h[0] for h in hist]
    emit({"phase": "fsdp_seq_parallel", "seed": seed, "arch": t["arch"],
          "layers": t["layers"], "mesh": list(t["mesh"]), "fsdp": True,
          "seq_shard": True, "remat": True, "precision": "fp8",
          "batch": t["batch"], "seq": t["seq"], "steps": t["steps"],
          "params": fsdp_config().param_count(), "losses": losses,
          "grad_norms": [h[1] for h in hist],
          "one_process_at_own_params": [o[:4] for o in own],
          "tp_alone_at_own_params": tp_alone,
          "tp_alone_f32_at_own_params": [f[:2] for f in f32],
          "rel": readings, "tol": DIST_TRAIN_TOL,
          "fp8_grad_norm_tol": FSDP_FP8_NORM_TOL,
          "state_bytes_rank": tr[0]["state_bytes"],
          "state_bytes_rule": tr[0]["state_bytes_rule"],
          "state_bytes_rank_without_fsdp":
              tr[0]["state_bytes_without_fsdp"],
          "timing_note": "ms of ranks sharing one card",
          "ranks": [{k: v for k, v in x.items()
                     if k not in ("history", "one_process_at_own_params",
                                  "tp_alone_at_own_params",
                                  "tp_alone_f32_at_own_params")}
                    | {"step_ms": [h[2] for h in x["history"]]}
                    for x in tr]})
    failures = []
    for r, x in enumerate(tr):
        if x["launches"] != tr[0]["launches"]:
            failures.append(f"fsdp rank {r}: launches {x['launches']}")
        if x["state_bytes"] != x["state_bytes_rule"]:
            failures.append(f"fsdp rank {r}: {x['state_bytes']} state "
                            f"bytes, the rule's {x['state_bytes_rule']}")
        if [h[:2] for h in x["history"]] != [h[:2] for h in hist]:
            failures.append(f"fsdp rank {r}: history differs from rank 0")
    for k in ("quantize_tilewise", "act_quantize", "gmm", "wgrad"):
        if not tr[0]["launches"].get(k):
            failures.append(f"fsdp: {k} never launched")
    if not len(own) == len(tp_alone) == len(f32) == t["steps"]:
        failures.append(f"fsdp: one process at {len(own)} steps, TP alone "
                        f"at {len(tp_alone)}, f32 at {len(f32)}")
    bounds = {"loss_vs_one": DIST_TRAIN_TOL,
              "grad_norm_vs_one": FSDP_FP8_NORM_TOL,
              "vs_tp_alone": DIST_TRAIN_TOL,
              "tp_f32_loss_vs_one": DIST_TRAIN_TOL,
              "tp_f32_grad_norm_vs_one": DIST_TRAIN_TOL}
    for k, bound in bounds.items():
        for i, v in enumerate(readings[k]):
            if not v <= bound:
                failures.append(f"fsdp seed {seed}: step {i} {k} {v}, "
                                f"bound {bound}")
    for i, (v, path) in enumerate(readings["tp_f32_worst_leaf"]):
        if not v <= DIST_TRAIN_TOL:
            failures.append(f"fsdp seed {seed}: step {i} TP's f32 grad "
                            f"norm of {path} {v} from one process's")
    if not all(math.isfinite(v) for v in losses):
        failures.append(f"fsdp: losses {losses}")
    return failures


def phase_a15b2(seeds=(0,), serve=True) -> dict:
    """The ``tp_recurrent`` and ``fsdp_seq_parallel`` phases (A15b-2) on 4
    ranks sharing the card over gloo: each TPR_SERVE model served whole
    under TP (:func:`check_serve`), then the FSDP_TRAIN run from each of
    ``seeds`` (:func:`check_fsdp`).  ``serve=False`` runs the training
    alone.  Returns the launch counts of the paths (rank 0's, the first
    seed's run)."""
    from repro_torch.launch.ranks import run_ranks
    t_phase = time.perf_counter()
    emit({"phase": "tp_recurrent_setup", "ranks": 4, "backend": "gloo",
          "device": "cuda:0", "why": TP_WHY, "seeds": list(seeds)})
    free_memory()
    d = os.path.join(HERE, "build", "chip_smoke_a15b2")
    os.makedirs(d, exist_ok=True)
    t0 = time.perf_counter()
    ranks = run_ranks(a15b2_rank, 4, backend="gloo", store_dir=d,
                      timeout=900, args=(tuple(seeds), serve))
    ranks_s = time.perf_counter() - t0
    failures, paths = [], {}
    for name in TPR_SERVE if serve else ():
        serve_ranks = [r["serve"][name] for r in ranks]
        failures += check_serve(name, serve_ranks)
        paths[f"serve_{name}"] = serve_ranks[0]["launches"]
    for seed in seeds:
        tr = [r["train"][seed] for r in ranks]
        failures += check_fsdp(tr, seed)
        paths.setdefault("train_rg_fp8_fsdp_sp", tr[0]["launches"])
        if MEASURED["fsdp"] is None:
            MEASURED["fsdp"] = [{"state_bytes": x["state_bytes"],
                                 "collectives": x["collectives"]}
                                for x in tr]
    emit({"phase": "a15b2", "seconds": time.perf_counter() - t_phase,
          "four_ranks_s": ranks_s})
    if failures:
        raise AssertionError("a15b2: " + "; ".join(failures))
    return paths


#: one production cell a family for the dry run phase (16 x 16, one
#: cycle of the block pattern): the dense, MoE, hybrid, ssm, audio and
#: vlm families
DRYRUN_FAMILIES = ("qwen3-1.7b", "deepseek-moe-16b", "recurrentgemma-2b",
                   "xlstm-350m", "whisper-tiny", "pixtral-12b")
DRYRUN_SHAPE = "decode_32k"


def wait_measured(path: str, parent: int) -> dict:
    """``MEASURED`` as the card's process (pid ``parent``) writes it to
    ``path`` once its phases are done; exits if that process is gone."""
    while not os.path.exists(path):
        if os.getppid() != parent:
            raise SystemExit("dryrun: the card's process is gone")
        time.sleep(0.5)
    with open(path) as f:
        return json.load(f)


def dryrun_check(path: str, parent: int) -> "list[str]":
    """The dry run's predictions, traced on fake tensors with no device
    while the card's process runs its phases: (a) the remat phase's fp8
    run on a 1 x 1 mesh, (b) each rank of the fsdp_seq_parallel run, (c)
    one production cell a family; then (a) and (b) against what that
    process measured (``MEASURED``, read back from ``path`` once it is
    written by the process of pid ``parent``).  Emits a line each;
    returns the failures."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    failures = []
    one = ((1, 1), ("data", "model"))
    t = REMAT_SHAPE
    cfg = variant_config("fp8", num_layers=t["layers"])
    shape = ShapeConfig("remat", t["seq"], t["batch"], "train")
    remat_recs = {}
    for remat in (True, False):
        t0 = time.perf_counter()
        rec = dryrun.lower_cell(cfg.name, shape, multi_pod=False,
                                mesh_sizes=one, config=dataclasses.replace(
                                    cfg, remat=remat))
        remat_recs[remat] = (rec, time.perf_counter() - t0)
    t = FSDP_TRAIN
    cfg = fsdp_config()
    shape = ShapeConfig("fsdp", t["seq"], t["batch"], "train")
    fsdp_recs = []
    for rank in range(math.prod(t["mesh"])):
        t0 = time.perf_counter()
        rec = dryrun.lower_cell(cfg.name, shape, multi_pod=False, rank=rank,
                                mesh_sizes=(t["mesh"], ("data", "model")),
                                config=cfg)
        fsdp_recs.append((rec, time.perf_counter() - t0))
    for arch in DRYRUN_FAMILIES:
        t0 = time.perf_counter()
        rec = dryrun.lower_cell(arch, DRYRUN_SHAPE, multi_pod=False,
                                config=dryrun.cut_to_cycles(
                                    get_config(arch)), rank=17)
        emit({"phase": "dryrun_cell", "arch": arch, "shape": DRYRUN_SHAPE,
              "mesh": rec["mesh"], "layers": rec["layers"],
              "memory": rec["memory"], "cache_bytes": rec["cache_bytes"],
              "cache_bytes_reference_layout":
                  rec["cache_bytes_reference_layout"],
              "collectives": rec["collectives"],
              "kernels": rec["cost"]["kernels"],
              "roofline": rec["roofline"],
              "seconds": time.perf_counter() - t0})
    measured = wait_measured(path, parent)
    got = measured["remat"]["fp8"]
    traced = {k: REMAT_SHAPE[k] for k in ("layers", "batch", "seq")}
    if {k: got[k] for k in traced} != traced:
        failures.append(f"dryrun remat: traced {traced}, measured "
                        f"{ {k: got[k] for k in traced} }")
    for remat, key in ((True, "remat_on"), (False, "remat_off")):
        rec, seconds = remat_recs[remat]
        mem = rec["memory"]
        args = mem["argument_breakdown"]
        # the phase times forward and backward alone: params, the batch,
        # then the gradient pass's own peak
        peak = args["params"] + args["batch"] + mem["grad_phase_peak_bytes"]
        row = {"phase": "dryrun_remat", "config": "fp8", "remat": remat,
               "params_bytes": [args["params"], got["params_bytes"]],
               "grad_bytes": [rec["train"]["grad_bytes"],
                              got[key]["grad_bytes"]],
               "peak_gb_predicted": peak / 1e9,
               "peak_gb_measured": got[key]["peak_gb"],
               "peak_gap_gb": peak / 1e9 - got[key]["peak_gb"],
               "kernels": {k: w["calls"] for k, w in
                           rec["cost"]["kernels"].items()},
               "seconds": seconds}
        emit(row)
        for what in ("params_bytes", "grad_bytes"):
            if row[what][0] != row[what][1]:
                failures.append(f"dryrun remat={remat}: {what} predicted "
                                f"{row[what][0]}, measured {row[what][1]}")
    if len(measured["fsdp"]) != len(fsdp_recs):
        failures.append(f"dryrun fsdp: {len(fsdp_recs)} ranks traced, "
                        f"{len(measured['fsdp'])} measured")
    for rank, ((rec, seconds), got) in enumerate(zip(fsdp_recs,
                                                     measured["fsdp"])):
        args = rec["memory"]["argument_breakdown"]
        # a step's collectives, times the run's steps
        pred = {k: {f: v * t["steps"] for f, v in c.items()}
                for k, c in rec["collectives"]["per_type"].items()}
        row = {"phase": "dryrun_fsdp_seq_parallel", "rank": rank,
               "state_bytes": [args["params"] + args["opt_state"],
                               got["state_bytes"]],
               "collectives_predicted": pred,
               "collectives_measured": got["collectives"]["per_type"],
               "temp_gb_predicted": rec["memory"]["temp_bytes"] / 1e9,
               "seconds": seconds}
        emit(row)
        if row["state_bytes"][0] != row["state_bytes"][1]:
            failures.append(f"dryrun fsdp rank {rank}: state bytes "
                            f"{row['state_bytes']}")
        if pred != row["collectives_measured"]:
            failures.append(f"dryrun fsdp rank {rank}: collectives "
                            f"predicted {pred}, measured "
                            f"{row['collectives_measured']}")
    return failures


def stop_process(proc) -> None:
    """End ``proc`` if it still runs, and reap it."""
    if proc.poll() is None:
        proc.kill()
    proc.wait()


def start_dryrun() -> dict:
    """Start the dry run phase (:func:`dryrun_check`) in a process of its
    own that sees no card (its fake process group never meets the gloo
    phases), its output to files under ``build/``: it traces while this
    process runs its phases, then waits for ``MEASURED``
    (:func:`phase_dryrun_examples` writes it).  It is ended when this
    process exits, however it exits.  Returns the process, its paths and
    the card memory check's failures."""
    import atexit
    import subprocess
    import torch
    from repro_torch.launch import dryrun
    failures = []
    total = torch.cuda.get_device_properties(0).total_memory
    emit({"phase": "dryrun_card", "card_bytes": dryrun.CARD_BYTES,
          "total_memory": total, "card": dryrun.CARD})
    if total != dryrun.CARD_BYTES:
        failures.append(f"dryrun: CARD_BYTES {dryrun.CARD_BYTES}, the "
                        f"card's total_memory {total}")
    d = os.path.join(HERE, "build")
    os.makedirs(d, exist_ok=True)
    paths = {k: os.path.join(d, f"dryrun_{k}") for k in (
        "measured.json", "stdout.txt", "stderr.txt")}
    if os.path.exists(paths["measured.json"]):
        os.remove(paths["measured.json"])
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    with open(paths["stdout.txt"], "w") as out, \
            open(paths["stderr.txt"], "w") as err:
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                 "--dryrun-check", paths["measured.json"],
                                 "--dryrun-parent", str(os.getpid())],
                                env=env, stdout=out, stderr=err)
    atexit.register(stop_process, proc)
    return {"proc": proc, "paths": paths, "failures": failures}


def phase_examples() -> None:
    """Both unported examples' ports at smoke size on the card, through
    their ``main``: quickstart's loss falls (its main raises otherwise)
    and the serve example returns batch x max-new tokens."""
    sys.path.insert(0, os.path.join(HERE, "examples"))
    import quickstart_torch
    import serve_decode_torch
    t0 = time.perf_counter()
    first, last, _ = quickstart_torch.main(["--device", "cuda"])
    t1 = time.perf_counter()
    res = serve_decode_torch.main(["--device", "cuda"])
    t2 = time.perf_counter()
    emit({"phase": "examples", "quickstart_loss": [first, last],
          "quickstart_s": t1 - t0, "serve_decode_tokens":
              list(res.tokens.shape), "serve_decode_s": t2 - t1})
    if tuple(res.tokens.shape) != (4, 16):
        raise AssertionError(f"serve_decode_torch: tokens of shape "
                             f"{tuple(res.tokens.shape)}, not (4, 16)")


def phase_dryrun_examples(dry: dict) -> None:
    """``MEASURED`` to the dry run's process (started by
    :func:`start_dryrun`), the examples on the card meanwhile; then the
    dry run's lines and gates."""
    from repro_torch.kernels import abstract
    proc, paths, failures = dry["proc"], dry["paths"], dry["failures"]
    tmp = paths["measured.json"] + ".tmp"
    with open(tmp, "w") as f:
        json.dump(MEASURED, f)
    os.replace(tmp, paths["measured.json"])
    try:
        with timed("examples"):
            phase_examples()
        # every phase of this process ran on real tensors: none took a
        # kernel's shape-only route (the dry run's is the child's)
        emit({"phase": "abstract_route", "launches_here": abstract.WORK})
        if abstract.WORK:
            failures.append(f"real tensors took the shape-only kernels: "
                            f"{abstract.WORK}")
        proc.wait(timeout=600)
    finally:
        # a failed phase or an expired wait leaves no tracing child
        stop_process(proc)
    with open(paths["stdout.txt"]) as f:
        print(f.read(), end="", flush=True)
    if proc.returncode:
        with open(paths["stderr.txt"]) as f:
            err = f.read()
        failures.append(f"dryrun: exit {proc.returncode}: {err[-3000:]}")
    if failures:
        raise AssertionError("; ".join(failures))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="probe, build, kernel, autotune and analysis "
                         "checks only")
    ap.add_argument("--fsdp-seeds", default=None,
                    help="comma-separated seeds: the fsdp_seq_parallel "
                         "phase alone, its run from each")
    ap.add_argument("--dryrun-check", default=None,
                    help=argparse.SUPPRESS)    # the dry run phase's process
    ap.add_argument("--dryrun-parent", type=int, default=None,
                    help=argparse.SUPPRESS)    # and the pid it waits on
    args = ap.parse_args(argv)
    if args.dryrun_check:
        failures = dryrun_check(args.dryrun_check, args.dryrun_parent)
        for line in failures:
            print(line, file=sys.stderr)
        return 1 if failures else 0
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
    if args.fsdp_seeds is not None:
        seeds = [int(x) for x in args.fsdp_seeds.split(",")]
        with timed("fsdp_seq_parallel seeds"):
            phase_a15b2(seeds, serve=False)
        print(info["nvidia_smi"], flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
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
        with timed("train_rg_geometries"):
            paths.update(phase_rg_geometries())
        for variant in REMAT_VARIANTS:
            free_memory()
            with timed(f"remat {variant}"):
                phase_remat(variant)
        # the dry run traces off the card while the phases below run
        dry = start_dryrun()
        free_memory()
        with timed("checkpoint"):
            phase_checkpoint()
        free_memory()
        with timed("distributed"):
            paths.update(phase_distributed())
        free_memory()
        with timed("tensor_parallel"):
            paths.update(phase_tensor_parallel())
        free_memory()
        with timed("tp_recurrent + fsdp_seq_parallel"):
            paths.update(phase_a15b2())
        free_memory()
        with timed("dryrun + examples"):
            phase_dryrun_examples(dry)
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
            if "block_m_ms" in t:
                row["block_m_ms"] = t["block_m_ms"]
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
        # B4 and B6 at each other wgrad geometry of the pool: timed at the
        # ragged routed_1536 shape with a bf16 dw (the rest under
        # "times", beside span 1's); launches: the wrapper's count at
        # that geometry in the recurrentgemma run under it at its wgrad
        # precision
        for name in ("wgrad", "wgrad_fp8"):
            prec = "fp8" if name == "wgrad_fp8" else "bf16"
            for geometry, geo in wgrad_geometries().items():
                if geometry == "span1":
                    continue
                t = WGRAD_GEOMETRY_TIMES[(name, geometry, "routed_1536",
                                          "bfloat16")]
                run = RG_GEOMETRY_RUNS[(geometry, prec)]
                row = {"name": f"{name}_{geometry}", "route": "cuda",
                       "source": SOURCES[name], "replaces": REPLACES[name],
                       "geometry": dict(zip(("block_n", "n_span", "k_span"),
                                            geo)),
                       "launches": run["wgrad_launches_at_geometry"],
                       "launches_by_path": {
                           f"train_rg_{geometry}_{prec}_wgrad":
                           run["wgrad_launches_at_geometry"]},
                       "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                       "eager_ms": t["eager_ms"], "plain_ms": t["plain_ms"],
                       "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                       "library_ms": t["library_ms"],
                       "library_note": t["library_note"], "times": {}}
                for (kn, g, shape, dt), tt in WGRAD_GEOMETRY_TIMES.items():
                    if (kn, g) == (name, geometry):
                        one = WGRAD_GEOMETRY_TIMES[(kn, "span1", shape, dt)]
                        row["times"][f"{shape} {dt}"] = {
                            "shape": tt["shape"], "span1_ms": one["ms"],
                            **{k: tt[k] for k in (
                                "ms", "eager_ms", "plain_ms", "bound_ms",
                                "bound_by", "library_ms")}}
                rows.append(row)
        # flash attention ran on the serve and train paths of both models,
        # and on the zoo's serve paths that reach it
        for p in ("serve_fp8_flash", "serve_qwen3_flash", "train_fp8_flash",
                  "train_qwen3_flash", "serve_yi_fp8_flash",
                  "serve_pixtral_fp8_flash", "serve_whisper_fp8_flash",
                  "serve_yi_bf16_flash_tp4", "train_qwen3_flash_tp4",
                  "serve_whisper_fp8_flash_tp2"):
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
