"""The port's dry run (``repro_torch.launch.dryrun``) and the shape-only
kernels it traces (``repro_torch.kernels.abstract``), on the CPU.

- ``SHAPES``, ``FULL_ATTENTION_ARCHS`` and ``cell_is_runnable`` equal the
  JAX package's for every arch and shape, and ``batch_struct``'s shapes
  equal its ``batch_struct``'s (tokens in the port's int64).
- Each kernel's shape-only version (B1, B3 in both input modes, B2, B7,
  B5, B4 and B6 at both dw dtypes, B8) on small real inputs: its outputs
  equal the plain version's in shape, dtype and stride, and its counted
  work equals the arithmetic written out here; under ``FakeTensorMode``
  the public function takes it and reads nothing to the host (a fake
  tensor raises on any host read).  A real tensor never takes it, and a
  failing plain version raises rather than fall back to it.
- A fake rank against a real one: on a (2, 2) gloo mesh of spawned CPU
  ranks, smoke qwen3-1.7b, fp8 deepseek-moe-16b, recurrentgemma-2b and
  whisper-tiny each take one FSDP train step (every leaf FSDP could
  shard is: ``sharding.FSDP_MIN_SIZE`` 1); each rank's params and AdamW
  bytes, its collectives' calls and bytes by type and its flops outside
  the kernels equal those ``lower_cell`` predicts for that rank exactly.
- One collective in a group of two: its input, result and
  ring-weighted wire bytes by arithmetic.
- A rank's param bytes on both production meshes equal the sum of
  ``sharding.local_numel`` over ``Model.specs``, for all ten archs.
- The recurrent archs' decode caches: the port's bytes a rank (its
  share of each state's channels or heads) and the reference's layout
  (the states whole over ``model``), each against arithmetic on the
  config's dims (ROADMAP C, "Recurrent decode states split").
"""
import dataclasses

import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import _disable_current_modes
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import base as jbase
from repro.models import model_zoo as jzoo
from repro_torch.configs import ARCHS, FULL_ATTENTION_ARCHS, SHAPES, \
    ShapeConfig, cell_is_runnable, get_config, smoke_config
from repro_torch.distributed import context as dctx
from repro_torch.distributed import sharding
from repro_torch.kernels import abstract, epilogue_kernel, \
    flash_attention_kernel, grouped_gemm_kernel, quant_kernel, wgrad_kernel
from repro_torch.kernels import ref as kref
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.ranks import run_ranks
from repro_torch.models import transformer as tfm
from repro_torch.models.model_zoo import batch_struct, make_model, \
    synthetic_batch
from repro_torch.optim import adamw
from repro_torch.train.trainer import make_train_step
from repro_torch.tree import tree_paths


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs (beside the other test
    workers PyTorch's pool oversubscribes the cores); restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# shapes and batches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_shapes_equal_the_reference(shape):
    want = jbase.SHAPES[shape]
    assert dataclasses.asdict(SHAPES[shape]) == dataclasses.asdict(want)
    assert FULL_ATTENTION_ARCHS == jbase.FULL_ATTENTION_ARCHS
    for arch in ARCHS:
        assert cell_is_runnable(arch, shape) == \
            jbase.cell_is_runnable(arch, shape)


def test_thirty_two_runnable_cells():
    assert sum(cell_is_runnable(a, s) for a in ARCHS for s in SHAPES) == 32


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_struct_equals_the_reference(arch):
    from repro.configs import get_config as jget_config
    for name, shape in SHAPES.items():
        for decode in (False, True):
            for b in (None, 2):
                want = jzoo.batch_struct(jget_config(arch),
                                         jbase.SHAPES[name], b,
                                         decode=decode)
                got = batch_struct(get_config(arch), shape, b, decode=decode)
                assert sorted(got) == sorted(want)
                for k, v in got.items():
                    assert tuple(v.shape) == tuple(want[k].shape), k
                    assert v.dtype == (torch.int64 if k in ("tokens",
                                                            "labels")
                                       else torch.bfloat16)


# ---------------------------------------------------------------------------
# the shape-only kernels
# ---------------------------------------------------------------------------

def _rows(m, k, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((m, k), generator=g).to(dtype)


def _fp8(m, k, seed=0):
    return kref.quantize_tilewise_ref(_rows(m, k, seed=seed))


def _weights(g, k, n, seed=1):
    gen = torch.Generator().manual_seed(seed)
    return kref.quantize_blockwise_ref(torch.randn((g, k, n), generator=gen))


GS = torch.tensor([30, 0, 50], dtype=torch.int32)     # 96 rows, 16 tail


def _gemm_args():
    a8, sa = _fp8(96, 256)
    b8, sb = _weights(3, 256, 256)
    return (a8, sa, b8, sb, GS)


def _b2(block_m, out_dtype, block_n=128):
    # visits: the tiles plus one a group boundary (G - 1)
    tiles = -(-96 // block_m)
    visits, rows = tiles + 2, max(block_m, 64)         # wgmma's 64 rows
    flops = 2 * visits * rows * 256 * 256
    n_tiles = 256 // block_n
    a = visits * n_tiles * block_m * (256 + 4 * 2)
    return flops, a + visits * 256 * 256 + tiles * block_m * 256 * \
        out_dtype.itemsize


def _wgrad_args(fp8):
    x, dy = _rows(96, 256, seed=2), _rows(96, 384, seed=3)
    if fp8:
        return (*kref.quantize_tilewise_ref(x),
                *kref.quantize_tilewise_ref(dy), GS)
    return (x.bfloat16(), dy.bfloat16(), GS)


def _b4(fp8, itemsize):
    visits = 1 + 2
    flops = 2 * visits * 128 * 256 * 384
    if fp8:          # x on each of 3 N steps, dy on each of 2 K steps
        ops = visits * 3 * 128 * 256 + visits * 2 * 128 * 384 + \
            visits * 2 * 3 * 128 * 4 * (2 + 3)
    else:
        ops = (visits * 3 * 128 * 256 + visits * 2 * 128 * 384) * 2
    return flops, ops + 3 * 256 * 384 * itemsize


def _flash_args():
    g = torch.Generator().manual_seed(4)
    q = torch.randn((1, 4, 128, 64), generator=g).bfloat16()
    k = torch.randn((1, 2, 128, 64), generator=g).bfloat16()
    v = torch.randn((1, 2, 128, 64), generator=g).bfloat16()
    return (q, k, v)


F32, BF16 = torch.float32, torch.bfloat16
# name: (module, public function, WORK key, args, kwargs, (flops, bytes))
KERNELS = {
    "B1": (quant_kernel, "quantize_tilewise", "quantize_tilewise",
           lambda: (_rows(32, 256),), {},
           (0.0, 32 * 256 * 4 + 32 * 256 + 32 * 2 * 4)),
    "B3_silu_bf16": (epilogue_kernel, "act_quantize", "act_quantize",
                     lambda: (_rows(32, 256, BF16), _rows(32, 256, BF16, 1)),
                     {}, (0.0, 2 * 32 * 256 * 2 + 32 * 256 + 32 * 2 * 4)),
    "B3_gelu_f32": (epilogue_kernel, "act_quantize", "act_quantize",
                    lambda: (_rows(32, 256),), {"act": "gelu"},
                    (0.0, 32 * 256 * 4 + 32 * 256 + 32 * 2 * 4)),
    "B3_fp8": (epilogue_kernel, "act_quantize", "act_quantize_fp8",
               lambda: (_fp8(32, 256)[0], _fp8(32, 256, 1)[0]),
               {"s_g": _fp8(32, 256)[1], "s_u": _fp8(32, 256, 1)[1]},
               (0.0, 2 * 32 * (256 + 4 * 2) + 32 * 256 + 32 * 2 * 4)),
    "B2_bf16": (grouped_gemm_kernel, "gmm", "gmm", _gemm_args, {},
                _b2(128, BF16)),
    "B2_f32_m16": (grouped_gemm_kernel, "gmm", "gmm", _gemm_args,
                   {"out_dtype": F32, "block_m": 16}, _b2(16, F32)),
    # every other geometry of the pool counts its own visits and tiles:
    # block_m 8 (12 tiles), 64 (2), 256 and 512 (1), block_n 256 (1 N tile)
    "B2_bf16_m8": (grouped_gemm_kernel, "gmm", "gmm", _gemm_args,
                   {"block_m": 8}, _b2(8, BF16)),
    "B2_bf16_m64_n256": (grouped_gemm_kernel, "gmm", "gmm", _gemm_args,
                         {"block_m": 64, "block_n": 256},
                         _b2(64, BF16, 256)),
    "B2_f32_m256": (grouped_gemm_kernel, "gmm", "gmm", _gemm_args,
                    {"out_dtype": F32, "block_m": 256}, _b2(256, F32)),
    "B2_bf16_m512_n256": (grouped_gemm_kernel, "gmm", "gmm", _gemm_args,
                          {"block_m": 512, "block_n": 256},
                          _b2(512, BF16, 256)),
    "B7": (grouped_gemm_kernel, "gmm_quant", "gmm_quant", _gemm_args, {},
           (_b2(128, BF16)[0], _b2(128, BF16)[1] - 128 * 256 * 2
            + 128 * (256 + 4 * 2))),
    "B5": (grouped_gemm_kernel, "gmm_bf16", "gmm_bf16",
           lambda: (_rows(96, 256, BF16), _rows(768, 256, BF16).reshape(
               3, 256, 256), GS), {},
           (2 * 3 * 128 * 256 * 256, 3 * 2 * 128 * 256 * 2
            + 3 * 256 * 256 * 2 + 128 * 256 * 2)),
    "B4_f32": (wgrad_kernel, "gmm_wgrad", "gmm_wgrad",
               lambda: _wgrad_args(False), {}, _b4(False, 4)),
    "B4_bf16": (wgrad_kernel, "gmm_wgrad", "gmm_wgrad",
                lambda: _wgrad_args(False), {"out_dtype": BF16},
                _b4(False, 2)),
    "B6_f32": (wgrad_kernel, "gmm_wgrad_fp8", "gmm_wgrad_fp8",
               lambda: _wgrad_args(True), {}, _b4(True, 4)),
    "B6_bf16": (wgrad_kernel, "gmm_wgrad_fp8", "gmm_wgrad_fp8",
                lambda: _wgrad_args(True), {"out_dtype": BF16},
                _b4(True, 2)),
    # 2 q tiles: 3 (q, k) tile pairs below the diagonal, 2 products each
    "B8": (flash_attention_kernel, "flash_attention", "flash_attention",
           _flash_args, {}, (4 * 4 * 3 * 64 * 64 * 64,
                             2 * (2 * 4 * 128 * 64 + 2 * 2 * 128 * 64))),
}


def _outs(x):
    return list(x) if isinstance(x, tuple) else [x]


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_abstract_kernel_matches_plain_and_counts_its_work(name):
    mod, fn, key, make, kw, (flops, nbytes) = KERNELS[name]
    args = make()
    want = _outs(getattr(mod, f"{fn}_plain")(*args, **kw))
    abstract.reset()
    got = _outs(getattr(mod, f"{fn}_abstract")(*args, **kw))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.shape, g.dtype, g.stride()) == (w.shape, w.dtype,
                                                  w.stride())
    assert abstract.WORK == {key: {"calls": 1, "flops": float(flops),
                                   "bytes": nbytes}}
    # under fake tensors the public function takes it, reading nothing
    abstract.reset()
    with FakeTensorMode() as mode:
        fargs = [mode.from_tensor(a) for a in args]
        fkw = {k: mode.from_tensor(v) if isinstance(v, torch.Tensor) else v
               for k, v in kw.items()}
        fake = _outs(getattr(mod, fn)(*fargs, **fkw))
    assert all(abstract.is_fake(t) for t in fake)
    for g, w in zip(fake, want):
        assert (g.shape, g.dtype, g.stride()) == (w.shape, w.dtype,
                                                  w.stride())
    assert abstract.WORK[key]["calls"] == 1


class _CudaLike(torch.Tensor):
    """A CPU tensor that says it is on a card, to see the CUDA route
    taken."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_only_fake_tensors_take_the_abstract_route(monkeypatch, name):
    """A real CPU tensor takes the plain version, a card's the kernel, a
    fake one the abstract version; a plain version that fails raises
    its own error, with no fallback to the abstract one."""
    mod, fn, _, make, kw, _ = KERNELS[name]
    args = make()
    taken = []
    for route in ("cuda", "abstract"):
        monkeypatch.setattr(mod, f"{fn}_{route}",
                            lambda *a, _r=route, **k: taken.append(_r))
    getattr(mod, fn)(*args, **kw)                  # the plain version runs
    getattr(mod, fn)(args[0].as_subclass(_CudaLike), *args[1:], **kw)
    assert taken == ["cuda"]

    def broken(*a, **k):
        raise RuntimeError("the plain version failed")
    monkeypatch.setattr(mod, f"{fn}_plain", broken)
    with pytest.raises(RuntimeError, match="plain version failed"):
        getattr(mod, fn)(*args, **kw)
    assert taken == ["cuda"]
    with FakeTensorMode() as mode:
        getattr(mod, fn)(*(mode.from_tensor(a) for a in args),
                         **{k: mode.from_tensor(v) if isinstance(
                             v, torch.Tensor) else v for k, v in kw.items()})
    assert taken == ["cuda", "abstract"]


# ---------------------------------------------------------------------------
# a fake rank against a real one
# ---------------------------------------------------------------------------

SEQ, BATCH = 64, 4
REAL = {"qwen3": "qwen3-1.7b", "deepseek_fp8": "deepseek-moe-16b",
        "rg": "recurrentgemma-2b", "whisper": "whisper-tiny"}
PLAINS = {quant_kernel: ("quantize_tilewise",),
          epilogue_kernel: ("act_quantize",),
          grouped_gemm_kernel: ("gmm", "gmm_quant", "gmm_bf16"),
          wgrad_kernel: ("gmm_wgrad", "gmm_wgrad_fp8"),
          flash_attention_kernel: ("flash_attention",)}


def _real_cfg(name):
    cfg = smoke_config(REAL[name])
    return dataclasses.replace(cfg, precision="fp8") \
        if name == "deepseek_fp8" else cfg


def _unseen(fn):
    """``fn`` run with the dispatch modes off: a plain kernel's own ops
    stay outside the flop counter, as a shape-only kernel's do."""
    def run(*a, **kw):
        with _disable_current_modes():
            return fn(*a, **kw)
    return run


def _real_rank(rank, world):
    sharding.FSDP_MIN_SIZE = 1
    for mod, fns in PLAINS.items():
        for fn in fns:
            setattr(mod, f"{fn}_plain", _unseen(getattr(mod, f"{fn}_plain")))
    mesh = make_mesh((2, 2), ("data", "model"))
    out = {}
    for name in REAL:
        cfg = _real_cfg(name)
        model = make_model(cfg, "cpu", mesh, fsdp=True)
        params = model.init_params(torch.Generator().manual_seed(0))
        opt_cfg = adamw.OptConfig(use_master=True)
        opt = adamw.init_opt_state(params, opt_cfg)
        step = make_train_step(model.loss, opt_cfg, mesh=mesh,
                               specs=model.specs)
        batch = synthetic_batch(torch.Generator().manual_seed(1), cfg, SEQ,
                                BATCH)
        nbytes = dryrun.leaf_bytes(params) + dryrun.leaf_bytes(opt)
        dctx.reset_collectives()
        with FlopCounterMode(display=False) as flops:
            step(params, opt, batch)
        out[name] = {"bytes": nbytes, "flops": flops.get_total_flops(),
                     "colls": dctx.COLLECTIVES["per_type"]}
    return out


def test_a_fake_rank_predicts_a_real_one(tmp_path, monkeypatch):
    real = run_ranks(_real_rank, 4, store_dir=str(tmp_path), timeout=600)
    monkeypatch.setattr(sharding, "FSDP_MIN_SIZE", 1)
    shape = ShapeConfig("smoke", SEQ, BATCH, "train")
    for name in REAL:
        for rank, got in enumerate(real):
            rec = dryrun.lower_cell(
                REAL[name], shape, multi_pod=False, rank=rank,
                mesh_sizes=((2, 2), ("data", "model")),
                config=_real_cfg(name))
            mem = rec["memory"]["argument_breakdown"]
            assert rec["train"]["accum"] == 1
            assert mem["params"] + mem["opt_state"] == got[name]["bytes"]
            assert rec["collectives"]["per_type"] == got[name]["colls"], \
                (name, rank)
            assert rec["cost"]["flops_aten"] == got[name]["flops"]
            assert (rec["cost"]["flops_kernels"] > 0) == \
                (name == "deepseek_fp8")
        assert got[name]["colls"]["all-gather"]["calls"] > 0     # FSDP


@pytest.mark.parametrize("kind", ["all-gather", "all-reduce", "gather"])
def test_wire_bytes_of_one_collective_on_two_ranks(kind):
    """One collective on a [3, 5] bf16 tensor (30 bytes) in a group of
    two: the input bytes, the result bytes (an all-gather's and a
    gather's hold both ranks' parts) and the ring-weighted wire bytes
    by arithmetic: all-gather and gather the 60-byte result once,
    all-reduce the 30-byte result twice."""
    x = torch.ones(3, 5, dtype=torch.bfloat16)
    with dryrun.fake_group(2, 0):
        group = dist.group.WORLD
        dctx.reset_collectives()
        if kind == "all-gather":
            assert dctx.all_gather(x, 0, group).shape == (6, 5)
        elif kind == "gather":
            assert sharding._gather_one(x, 0, group, 0).shape == (6, 5)
        else:
            dctx.all_reduce(x, group)
        per_type = dctx.COLLECTIVES["per_type"]
    result, weight = (30, 2.0) if kind == "all-reduce" else (60, 1.0)
    assert per_type == {kind: {"calls": 1, "bytes": 30,
                               "result_bytes": result}}
    assert dctx.COLLECTIVES["bytes"] == 30
    assert dryrun.wire_bytes(per_type) == weight * result


# ---------------------------------------------------------------------------
# bytes a rank on the production meshes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_bytes_a_rank_follow_the_specs(arch, multi_pod):
    cfg = get_config(arch)
    sizes, axes = dryrun.production_sizes(multi_pod)
    rank = 300 if multi_pod else 17
    with dryrun.fake_group(256 * (2 if multi_pod else 1), rank):
        mesh = make_mesh(sizes, axes)
        model = make_model(cfg, "cpu", mesh, fsdp=True)
        with FakeTensorMode():
            params = model.init_params(torch.Generator().manual_seed(0))
        shapes = tfm.param_shapes(cfg)
        want = sum(sharding.local_numel(shapes[p], model.specs[p], mesh)
                   * x.element_size() for p, x in tree_paths(params))
        assert dryrun.leaf_bytes(params) == want


# ---------------------------------------------------------------------------
# the recurrent archs' decode caches in both layouts
# ---------------------------------------------------------------------------

def _cache_arith(cfg, b, s, n_model, n_batch):
    """(port, reference) bytes a rank of one decode cache, from the
    config's dims.  Both split the batch over the batch ranks where it
    divides.  The reference splits the attention slots over the model
    axis and keeps every recurrent state whole there; the port splits
    each state's channels or heads, and the slots, where its
    tensor-parallel block splits the heads, channels or width."""
    bl = b // n_batch if b % n_batch == 0 else b
    hd = cfg.resolved_head_dim
    heads = cfg.num_heads % n_model == 0
    port = ref = 0
    for kind in tfm.layer_kinds(cfg):
        if kind == "attn":
            slots = min(s, cfg.window) if cfg.window else s
            kv = 2 * bl * slots * cfg.num_kv_heads * hd * 2
            port += kv // n_model if heads else kv
            ref += kv // n_model
            continue
        if kind == "rglru":
            w = cfg.lru_width or cfg.d_model
            st = bl * w * 4 + bl * (cfg.conv_width - 1) * w * 2
            split = w % n_model == 0
        elif kind == "mlstm":
            st = bl * cfg.num_heads * (hd * hd + hd) * 4
            split = heads
        else:                                   # slstm: c and n
            st = 2 * bl * cfg.d_model * 4
            split = cfg.d_model % n_model == 0
        port += st // n_model if split else st
        ref += st
    return port, ref


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "xlstm-350m"])
def test_recurrent_cache_bytes_in_both_layouts(arch, shape):
    cfg = dryrun.cut_to_cycles(get_config(arch), 2)
    sh = SHAPES[shape]
    with dryrun.fake_group(256, 5):
        mesh = make_mesh((16, 16), ("data", "model"))
        model = make_model(cfg, "cpu", mesh)
        b = sh.global_batch
        bl = b // 16 if b % 16 == 0 else b
        with FakeTensorMode():
            port = dryrun.leaf_bytes(model.init_cache(None, None, bl,
                                                      sh.seq_len))
            ref = dryrun.cache_bytes_reference_layout(
                dryrun._logical_cache(cfg, b, sh.seq_len), mesh)
    assert (port, ref) == _cache_arith(cfg, b, sh.seq_len, 16, 16)
