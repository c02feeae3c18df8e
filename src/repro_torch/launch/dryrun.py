"""Dry run of the port: one rank of a production mesh, traced on fake
tensors, for every (architecture x input shape) cell; the JAX package's
``launch/dryrun.py``.

A cell creates a ``fake`` process group of the mesh's size (256 ranks
for 16 x 16, 512 for 2 x 16 x 16) at one rank, builds the mesh's axis
groups on it, and runs that rank's step under
``torch._subclasses.fake_tensor.FakeTensorMode``: the model on the mesh
with FSDP, its params and AdamW state (f32 masters), then the train
step (``train.trainer.make_train_step``), the prefill or a decode step.
Fake tensors carry shapes and dtypes and no data, so nothing is
allocated and no device is touched: this runs on the CPU by design.
The kernels take their shape-only versions there
(``kernels/abstract.py``), which count the work of each launch at the
static M (the routed capacity).  The collectives run on the fake group,
which moves nothing, and are counted by type
(``distributed.context.COLLECTIVES``).

Each cell writes one JSON record with the reference's keys where the
port has the quantity:

- ``memory``: ``argument_bytes`` (this rank's params, optimizer state,
  batch and cache; ``argument_breakdown`` has each), ``output_bytes``,
  ``temp_bytes`` (the peak of live fake storages beyond the arguments;
  with gradient accumulation, plus the f32 accumulator the trainer keeps,
  ``accum_buffer_bytes``), ``grad_phase_peak_bytes`` (the forward and
  backward's peak alone) and ``alias_bytes`` (null: nothing is donated);
  ``fits_card``: whether argument plus temp bytes fit :data:`CARD_BYTES`;
- ``cost``: ``flops_per_device`` (``torch.utils.flop_counter`` over the
  aten ops, plus the kernels' counted flops, each also alone),
  ``bytes_accessed_unfused`` (every aten op's input and output bytes, views
  and bare allocations excepted, plus the kernels' counted bytes: eager
  PyTorch runs each op as its own pass), and the kernels' work by name;
- ``collectives``: calls, input bytes and result bytes by type, and
  ``wire_bytes_per_device``: the result bytes under the reference's ring
  weights, as its ``collective_bytes`` weighs its HLO's result buffers
  (an all-gather's result is the group's size times its input);
- ``top_flops`` / ``top_bytes``: the 8 largest ops (kernels as
  ``kernel:<name>``);
- ``roofline``: the three terms against :data:`CARD`'s spec-sheet figures
  (not measurements), the model flops and the dominant term;
- ``cache_bytes`` (decode): this rank's cache in the port's layout and
  ``cache_bytes_reference_layout``, the same leaves placed by the
  reference's ``_CACHE_RULES`` (it keeps the recurrent states and
  whisper's cross K/V whole over ``model``; the port splits them).

Where the reference differs: a train step traces one microbatch (its
global rows split over the batch ranks) and scales the gradient part by
the accumulation count, as the reference re-scales loop bodies;
``lower_s`` / ``compile_s`` are ``trace_s``; XLA's memory analysis and
HLO cost have no counterpart.  A cell that raises is recorded ``ok:
false`` with its error and the tail of its traceback.  ``--all`` runs
each cell in a process of its own (a process has one default process
group).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import traceback
import weakref
from typing import Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCHS, get_config, run_hints
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig, \
    cell_is_runnable
from repro_torch.distributed import context as dctx
from repro_torch.kernels import abstract
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import transformer as tfm
from repro_torch.models.model_zoo import batch_struct, make_model
from repro_torch.optim import adamw
from repro_torch.train.trainer import make_train_step
from repro_torch.tree import tree_leaves, tree_paths

# --- the card (roofline constants) -----------------------------------------
#: the card the figures below are for, as ``nvidia-smi --query-gpu=name,
#: power.limit`` reads it
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
#: spec-sheet figures of the H100 SXM (dense tensor-core rates, HBM3, one
#: direction of NVLink 4's 900 GB/s), not measurements.  The port's fp8
#: kernels widen e4m3 to f16 / bf16 for wgmma, so every flop takes the
#: bf16 rate; ``compute_s_e4m3`` is the kernels' flops at the e4m3 rate.
PEAK_FLOPS = 989e12
PEAK_FLOPS_E4M3 = 1979e12
HBM_BW = 3.35e12
NVLINK_BW = 450e9
#: ``torch.cuda.get_device_properties(0).total_memory`` on that card
CARD_BYTES = 85_017_493_504

# ring-algorithm wire-cost weights on a collective's result bytes (bytes
# actually serialized per device); ``gather`` (a checkpoint's) as an
# all-gather
_WIRE_WEIGHT = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
                "all-to-all": 1.0, "collective-permute": 1.0, "gather": 1.0}

# the reference's cache placement, by leaf name
_CACHE_RULES = {
    "k": ("batch", "kv_seq", None, None),
    "v": ("batch", "kv_seq", None, None),
    "xkv": ("batch", None, None, None),
    "C": ("batch", None, None, None),
    "n": ("batch", None, None),
    "c": ("batch", None),
    "h": ("batch", None),
    "conv": ("batch", None, None),
    "enc_out": ("batch", None, None),
    "len": (),
}

# aten ops that only allocate (no traffic)
_ALLOCS = frozenset(("empty", "empty_strided", "new_empty",
                     "new_empty_strided", "empty_like"))
TOP = 8


def production_sizes(multi_pod: bool) -> tuple:
    """The production mesh's sizes and axes (``launch.mesh``'s)."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def cut_to_cycles(cfg: ModelConfig, cycles: int = 1) -> ModelConfig:
    """``cfg`` cut to ``cycles`` cycles of its ``block_pattern`` (after its
    dense first layers; whisper: that many encoder and decoder layers),
    the widths untouched."""
    n_pre = cfg.moe.first_dense_layers if cfg.moe is not None else 0
    kw = {"num_layers": n_pre + cycles * len(tuple(cfg.block_pattern)
                                             or ("attn",))}
    if cfg.family == "audio":
        kw = {"num_layers": cycles, "encoder_layers": cycles}
    return dataclasses.replace(cfg, **kw)


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def leaf_bytes(tree) -> int:
    """Bytes of every tensor leaf of ``tree``."""
    return sum(_nbytes(t) for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class _Tally(TorchDispatchMode):
    """One pass over every op: each aten op's input and output bytes
    (views, bare allocations and ops with no tensor output excepted; the
    collectives are counted apart) by op, and the live bytes of
    the storages the ops make (each freed when its last tensor dies),
    with their peak; storages of ``arguments`` are not counted."""

    def __init__(self, arguments):
        super().__init__()
        self.skip = {t.untyped_storage()._cdata for t in _tensors(arguments)}
        self.seen = set()
        self.live = self.peak = 0
        self.op_bytes: "dict[str, int]" = {}

    def _free(self, key, n):
        self.seen.discard(key)
        self.live -= n

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.skip or key in self.seen:
            return
        n = st.nbytes()
        self.seen.add(key)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = _tensors(out)
        name = func.overloadpacket.__name__
        if (func.namespace == "aten" and outs and not func.is_view
                and name not in _ALLOCS):
            n = sum(_nbytes(t) for t in _tensors((args, kwargs)) + outs)
            key = str(func.overloadpacket)
            self.op_bytes[key] = self.op_bytes.get(key, 0) + n
        for t in outs:
            self._track(t)
        return out


def _measure(tally: _Tally, fn, *args):
    """Run ``fn(*args)`` under the tally and a flop counter; returns its
    output and the phase's flops, bytes, kernels' work and collectives
    by op or type."""
    kernels0 = {k: dict(v) for k, v in abstract.WORK.items()}
    colls0 = dict(dctx.COLLECTIVES["per_type"])
    tally.op_bytes = {}
    flops = FlopCounterMode(display=False)
    with flops, tally:
        out = fn(*args)
    kernels = {}
    for k, w in abstract.WORK.items():
        w0 = kernels0.get(k, {"calls": 0, "flops": 0.0, "bytes": 0})
        kernels[k] = {f: w[f] - w0[f] for f in w}
    colls = {}
    for k, c in dctx.COLLECTIVES["per_type"].items():
        colls[k] = {f: v - colls0.get(k, {}).get(f, 0)
                    for f, v in c.items()}
    return out, {
        "flops": {str(k): v for k, v in
                  flops.get_flop_counts().get("Global", {}).items()},
        "bytes": dict(tally.op_bytes), "kernels": kernels,
        "collectives": colls}


def _scaled(phases) -> dict:
    """The phases' counts, each (phase, times) summed ``times`` over."""
    out = {"flops": {}, "bytes": {}, "kernels": {}, "collectives": {}}
    for ph, times in phases:
        for key in ("flops", "bytes"):
            for op, v in ph[key].items():
                out[key][op] = out[key].get(op, 0) + v * times
        for key in ("kernels", "collectives"):
            for name, w in ph[key].items():
                acc = out[key].setdefault(name, {f: 0 for f in w})
                for f, v in w.items():
                    acc[f] += v * times
    return out


def _leaf_name(path: str) -> str:
    return next((p for p in reversed(path.split("/")) if not p.isdigit()),
                "")


def cache_bytes_reference_layout(logical_cache, mesh) -> int:
    """This rank's bytes of a cache (given at its logical, unsharded
    shapes) placed by the reference's ``_CACHE_RULES`` through
    :func:`~repro_torch.distributed.context.spec_for`."""
    total = 0
    for path, leaf in tree_paths(logical_cache):
        if not isinstance(leaf, torch.Tensor):
            continue
        rule = _CACHE_RULES.get(_leaf_name(path), ())
        nd = leaf.dim()
        logical = [None] * (nd - len(rule[:nd])) + list(rule[:nd])
        n = leaf.numel()
        for ax in dctx.spec_for(tuple(leaf.shape), logical, mesh):
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                if a is not None:
                    n //= mesh.shape[a]
        total += n * leaf.element_size()
    return total


def active_params(cfg: ModelConfig) -> "tuple[int, int]":
    """``(all, active)`` params: the port's exact count, and the
    reference's active count (the routed experts a token skips taken
    out)."""
    n = cfg.param_count()
    if cfg.moe is None:
        return n, n
    m = cfg.moe
    return n, n - (cfg.num_layers - m.first_dense_layers) * (
        3 * cfg.d_model * m.d_ff_expert * (m.num_experts - m.top_k))


def _trace(cfg: ModelConfig, shape: ShapeConfig, mesh, arch: str) -> dict:
    """The rank's step under ``FakeTensorMode``: its record's
    measurements (everything but the cell's names)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    batch_ranks = mesh.batch_ranks
    hints = run_hints(arch)
    rec = {}
    with FakeTensorMode():
        model = make_model(cfg, "cpu", mesh, fsdp=True)
        params = model.init_params(torch.Generator().manual_seed(0))
        args = {"params": params}
        if shape.kind == "train":
            # a microbatch keeps >= 1 sample a batch shard
            micro = max(hints.get("train_microbatch", 16), batch_ranks)
            accum = max(1, shape.global_batch // micro)
            opt_cfg = adamw.OptConfig(use_master=True)
            args["opt_state"] = adamw.init_opt_state(params, opt_cfg)
            # every rank is handed the global batch, one microbatch a
            # gradient pass, and takes its rows
            args["batch"] = batch_struct(cfg, shape)
            mb = batch_struct(cfg, shape, shape.global_batch // accum)
            step = make_train_step(model.loss, opt_cfg, mesh=mesh,
                                   specs=model.specs)
            tally = _Tally([args, mb])
            t0 = time.perf_counter()
            ((loss, _), grads), grad = _measure(tally, step.grad_fn,
                                                params, mb)
            grad_peak = tally.peak
            out, upd = _measure(tally, step.update, params, grads,
                                args["opt_state"])
            rec["trace_s"] = time.perf_counter() - t0
            phases = [(grad, accum), (upd, 1)]
            # the trainer's f32 sum of the microbatches' gradients
            accum_buf = sum(4 * g.numel() for g in tree_leaves(grads)) \
                if accum > 1 else 0
            rec["train"] = {"microbatch": shape.global_batch // accum,
                            "accum": accum,
                            "rows_per_rank": (shape.global_batch // accum)
                            // batch_ranks,
                            "grad_bytes": leaf_bytes(grads)}
            outputs = [out, loss]
            del grads
        else:
            b = shape.global_batch
            b_loc = b // batch_ranks if b % batch_ranks == 0 else b
            if shape.kind == "prefill":
                args["batch"] = batch_struct(cfg, shape, b_loc)

                def fn(p, bt):
                    with torch.no_grad():
                        return model.prefill(p, bt,
                                             cache_capacity=shape.seq_len)
                fn_args = (params, args["batch"])
            else:
                frames = None
                if cfg.family == "audio":
                    frames = torch.empty((b_loc, cfg.encoder_seq,
                                          cfg.d_model), dtype=torch.bfloat16)
                with torch.no_grad():
                    args["cache"] = model.init_cache(
                        params, {"frames": frames}, b_loc, shape.seq_len)
                args["batch"] = batch_struct(cfg, shape, b_loc, decode=True)

                def fn(p, tok, cache):
                    with torch.no_grad():
                        return model.decode_step(p, tok, cache)
                fn_args = (params, args["batch"]["tokens"], args["cache"])
                rec["cache_bytes"] = leaf_bytes(args["cache"])
                rec["cache_bytes_reference_layout"] = \
                    cache_bytes_reference_layout(
                        _logical_cache(cfg, b, shape.seq_len), mesh)
            tally = _Tally(args)
            t0 = time.perf_counter()
            out, ph = _measure(tally, fn, *fn_args)
            rec["trace_s"] = time.perf_counter() - t0
            grad_peak, phases, accum_buf = tally.peak, [(ph, 1)], 0
            outputs = [out]
        total = _scaled(phases)
        breakdown = {k: leaf_bytes(v) for k, v in args.items()}
        out_keys = {}
        for t in _tensors(outputs):
            st = t.untyped_storage()
            out_keys[st._cdata] = st.nbytes()
    rec["memory"] = {
        "argument_bytes": sum(breakdown.values()),
        "argument_breakdown": breakdown,
        "output_bytes": sum(out_keys.values()),
        "temp_bytes": tally.peak + accum_buf,
        "accum_buffer_bytes": accum_buf,
        "grad_phase_peak_bytes": grad_peak,
        "alias_bytes": None,
    }
    rec["memory"]["fits_card"] = (rec["memory"]["argument_bytes"]
                                  + rec["memory"]["temp_bytes"]
                                  <= CARD_BYTES)
    rec["_total"] = total
    return rec


def _logical_cache(cfg: ModelConfig, b: int, s: int):
    """The decode cache at its logical shapes (no mesh, the global batch),
    made on fake tensors under the caller's mode."""
    if cfg.family != "audio":
        return tfm.init_cache(cfg, b, s, device="cpu")
    model = make_model(cfg, "cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    frames = torch.empty((b, cfg.encoder_seq, cfg.d_model),
                         dtype=torch.bfloat16)
    with torch.no_grad():
        return model.init_cache(params, {"frames": frames}, b, s)


def wire_bytes(per_type: dict) -> float:
    """Bytes a device sends for the collectives ``per_type`` (type ->
    ``result_bytes``, ...): each type's result bytes times its ring
    weight, the reference's ``collective_bytes``."""
    return sum(_WIRE_WEIGHT[t] * c["result_bytes"]
               for t, c in per_type.items())


def _finish(rec: dict, cfg: ModelConfig, shape: ShapeConfig,
            chips: int) -> dict:
    total = rec.pop("_total")
    k_flops = sum(w["flops"] for w in total["kernels"].values())
    k_bytes = sum(w["bytes"] for w in total["kernels"].values())
    a_flops = sum(total["flops"].values())
    a_bytes = sum(total["bytes"].values())
    flops, nbytes = a_flops + k_flops, a_bytes + k_bytes
    per_type = total["collectives"]
    wire = wire_bytes(per_type)
    rec["cost"] = {"flops_per_device": flops, "flops_aten": a_flops,
                   "flops_kernels": k_flops,
                   "bytes_accessed_unfused": nbytes, "bytes_aten": a_bytes,
                   "bytes_kernels": k_bytes, "kernels": total["kernels"]}
    rec["collectives"] = {"per_type": per_type,
                          "calls": sum(c["calls"] for c in per_type.values()),
                          "bytes": sum(c["bytes"] for c in per_type.values()),
                          "result_bytes": sum(c["result_bytes"]
                                              for c in per_type.values()),
                          "wire_bytes_per_device": wire}
    ops_f = {**total["flops"], **{f"kernel:{k}": w["flops"]
                                  for k, w in total["kernels"].items()}}
    ops_b = {**total["bytes"], **{f"kernel:{k}": w["bytes"]
                                  for k, w in total["kernels"].items()}}
    rec["top_flops"] = sorted(([k, v] for k, v in ops_f.items() if v),
                              key=lambda kv: -kv[1])[:TOP]
    rec["top_bytes"] = sorted(([k, v] for k, v in ops_b.items() if v),
                              key=lambda kv: -kv[1])[:TOP]
    n_params, n_active = active_params(cfg)
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    model_flops = (6 if shape.kind == "train" else 2) * n_active * tokens
    rec["params"] = {"total": n_params, "active": n_active}
    rec["roofline"] = {
        "card": CARD,
        "compute_s": flops / PEAK_FLOPS,
        "compute_s_e4m3": (a_flops / PEAK_FLOPS
                           + k_flops / PEAK_FLOPS_E4M3),
        "memory_s": nbytes / HBM_BW,
        "collective_s": wire / NVLINK_BW,
        "model_flops_total": model_flops,
        "model_flops_per_device": model_flops / chips,
        "useful_flops_ratio": (model_flops / chips) / max(flops, 1.0),
    }
    rec["roofline"]["dominant"] = max(
        ("compute_s", "memory_s", "collective_s"),
        key=lambda k: rec["roofline"][k])
    return rec


def lower_cell(arch: str, shape_name, *, multi_pod: bool, precision=None,
               overrides=None, rank: int = 0, mesh_sizes=None,
               config: Optional[ModelConfig] = None) -> dict:
    """Trace one (arch x shape x mesh) cell at ``rank`` and return its
    record.  ``shape_name``: a key of ``SHAPES`` or a ``ShapeConfig``;
    ``mesh_sizes``: ``(sizes, axes)`` in place of the production mesh;
    ``config``: a config in place of ``get_config(arch)`` (``precision``
    and ``overrides`` apply to either).  Raises where the cell does; the
    fake process group it makes is destroyed on the way out."""
    cfg = config if config is not None else get_config(arch)
    if precision:
        cfg = dataclasses.replace(cfg, precision=precision)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = shape_name if isinstance(shape_name, ShapeConfig) \
        else SHAPES[shape_name]
    sizes, axes = mesh_sizes or production_sizes(multi_pod)
    with fake_group(math.prod(sizes), rank):
        mesh = make_mesh(sizes, axes)
        dctx.reset_collectives()
        abstract.reset()
        rec = {"arch": arch, "shape": shape.name,
               "mesh": "x".join(str(n) for n in sizes), "rank": rank,
               "chips": mesh.size, "precision": cfg.precision,
               "layers": cfg.num_layers, "ok": True}
        rec.update(_trace(cfg, shape, mesh, arch))
        return _finish(rec, cfg, shape, mesh.size)


@contextlib.contextmanager
def fake_group(world: int, rank: int):
    """A default process group of ``world`` ranks on the ``fake`` backend,
    this process its rank ``rank``: its collectives move nothing.
    Destroyed on the way out; a process that has a group already
    raises."""
    # internal to torch: the fake backend and its store
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a dry run needs a process with no process "
                           "group: it makes a fake one of the mesh's size")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _tag(arch, shape, args) -> str:
    tag = f"{arch}_{shape}_{'multi' if args.multi_pod else 'single'}"
    if args.precision:
        tag += f"_{args.precision}"
    if args.moe_dispatch:
        tag += f"_{args.moe_dispatch}"
    if args.seq_shard:
        tag += "_sp"
    return tag


def run_cell(arch: str, shape: str, args) -> dict:
    """One cell as the CLI runs it: its record, or ``ok: false`` with the
    error and the tail of the traceback; written under ``args.out``."""
    overrides = {}
    if args.moe_dispatch:
        overrides["moe_dispatch"] = args.moe_dispatch
    if args.seq_shard:
        overrides["seq_shard"] = True
    try:
        rec = lower_cell(arch, shape, multi_pod=args.multi_pod,
                         precision=args.precision,
                         overrides=overrides or None)
    except Exception as e:  # a failing cell is a finding; record it
        rec = {"arch": arch, "shape": shape,
               "mesh": "2x16x16" if args.multi_pod else "16x16",
               "rank": 0, "ok": False,
               "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-2000:]}
    path = os.path.join(args.out, _tag(arch, shape, args) + ".json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def summary(rec: dict) -> str:
    if not rec["ok"]:
        return f"  FAILED: {rec['error']}"
    r, m = rec["roofline"], rec["memory"]
    return (f"  trace {rec['trace_s']:.1f}s | arg {m['argument_bytes']/1e9:.2f}"
            f" GB temp {m['temp_bytes']/1e9:.2f} GB fits {m['fits_card']} | "
            f"compute {r['compute_s']:.4f}s mem {r['memory_s']:.4f}s "
            f"coll {r['collective_s']:.4f}s -> {r['dominant']} | "
            f"useful {r['useful_flops_ratio']:.2f}")


def table(out_dirs) -> str:
    """The records under each of ``out_dirs`` (one a mesh) as markdown
    rows, one a cell with a column group a mesh: bytes a rank (argument /
    temporaries, GB; "!" where they do not fit the card), flops a rank
    (TFLOP), wire bytes a rank (GB) and the dominant roofline term; a
    cell that raised, ``ok: false``.  ``PERF.md``'s dry-run table::

        PYTHONPATH=src python -c "from repro_torch.launch import dryrun; \
            print(dryrun.table(['build/dryrun', 'build/dryrun_multi']))"
    """
    cells, meshes = {}, []
    for d in out_dirs:
        for name in sorted(os.listdir(d)):
            if not name.endswith(".json"):
                continue
            with open(os.path.join(d, name)) as f:
                rec = json.load(f)
            if rec["mesh"] not in meshes:
                meshes.append(rec["mesh"])
            cells.setdefault((rec["arch"], rec["shape"]), {})[
                rec["mesh"]] = rec
    meshes.sort(key=lambda m: math.prod(int(n) for n in m.split("x")))

    def group(rec):
        if rec is None:
            return "— | — | — | —"
        if not rec["ok"]:
            return "ok: false | — | — | —"
        m, r = rec["memory"], rec["roofline"]
        fits = "" if m["fits_card"] else " !"
        return (f"{m['argument_bytes'] / 1e9:.2f} / "
                f"{m['temp_bytes'] / 1e9:.2f}{fits} | "
                f"{rec['cost']['flops_per_device'] / 1e12:.1f} | "
                f"{rec['collectives']['wire_bytes_per_device'] / 1e9:.1f} | "
                f"{r['dominant'][:-2]} {r[r['dominant']]:.3f}")
    head = " | ".join(f"{m}: arg / temp GB | TFLOP | wire GB | dominant s"
                      for m in meshes)
    rows = [f"| cell | {head} |", "|---" * (1 + 4 * len(meshes)) + "|"]
    for (arch, shape), recs in sorted(cells.items()):
        rows.append(f"| {arch} {shape} | " + " | ".join(
            group(recs.get(m)) for m in meshes) + " |")
    return "\n".join(rows)


def _child_argv(arch, shape, args) -> list:
    argv = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
            arch, "--shape", shape, "--out", args.out]
    for flag, on in (("--multi-pod", args.multi_pod),
                     ("--seq-shard", args.seq_shard)):
        if on:
            argv.append(flag)
    for flag, val in (("--precision", args.precision),
                      ("--moe-dispatch", args.moe_dispatch)):
        if val:
            argv += [flag, str(val)]
    return argv


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Trace one rank of the production mesh for each cell "
                    "on fake tensors (no device).  The reference's "
                    "--moe-reduce-bf16 is not ported: the port sums MoE "
                    "partials in f32, the reference's default (ROADMAP C).")
    ap.add_argument("--arch", default=None, choices=ARCHS)
    ap.add_argument("--shape", default=None, choices=tuple(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--precision", default=None, choices=[None, "bf16", "fp8"],
                    help="default: the port's presets (fp8 for the MoE "
                         "archs); bf16 gives the reference's")
    ap.add_argument("--moe-dispatch", default=None,
                    choices=[None, "ragged", "dense"])
    ap.add_argument("--seq-shard", action="store_true")
    ap.add_argument("--jobs", type=int, default=4,
                    help="--all: cells traced at once, each in a process")
    ap.add_argument("--out", default=os.path.join("build", "dryrun"))
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    if not args.all:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all")
        print(f"=== {_tag(args.arch, args.shape, args)} ===", flush=True)
        rec = run_cell(args.arch, args.shape, args)
        print(summary(rec), flush=True)
        return rec
    cells = [(a, s) for a in ARCHS for s in SHAPES if cell_is_runnable(a, s)]

    def child(cell):
        arch, shape = cell
        p = subprocess.run(_child_argv(arch, shape, args),
                           capture_output=True, text=True)
        return cell, p
    with concurrent.futures.ThreadPoolExecutor(args.jobs) as pool:
        for (arch, shape), p in pool.map(child, cells):
            print(p.stdout, end="", flush=True)
            if p.returncode:
                print(f"  FAILED (exit {p.returncode}): "
                      f"{p.stderr[-2000:]}", flush=True)
    return None


if __name__ == "__main__":
    main()
