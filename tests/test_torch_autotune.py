"""The port's tuning layer (``repro_torch/kernels/plan.py``) against the
JAX package's pure functions on the same arguments, and its selection,
cache, plan cache and the Engine's decode-tile selection on the CPU.

Parity: the pool and ``candidate_pool`` keep the reference's entries;
``cache_key`` differs only in the device kind, the backend name and the
resource model's version; every ``estimate_cost_s*`` and
``wgrad_operand_bytes`` equals the reference's bit for bit under a
TPU-shaped spec (``mma_m=128``, the MXU's rows).  The selection tests
are the reference's (``tests/test_plan.py``), with the measurement
monkeypatched: nothing here times anything (on the CPU every op is
tile-free, so a real selection never measures)."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import plan as jplan
from repro_torch.analysis import events
from repro_torch.configs import smoke_config
from repro_torch.kernels import plan as plan_mod
from repro_torch.kernels import resources as res
from repro_torch.kernels.plan import KernelConfig
from repro_torch.models.model_zoo import make_model
from repro_torch.serve.engine import Engine

H100 = "NVIDIA H100 80GB HBM3"
SHAPES = [(1024, 2048, 1408, 60), (16, 2048, 1408, 60), (1536, 2048, 1408, 64),
          (16384, 1408, 2048, 60), (256, 128, 128, 4), (24, 512, 256, 1),
          (4096, 4096, 4096, 8), (1, 256, 256, 64)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs (its tensors are tiny)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cache(tmp_path, monkeypatch):
    """A fresh cache file (also the default path) and process view."""
    path = str(tmp_path / "tileplan_cache.json")
    monkeypatch.setenv(plan_mod.CACHE_ENV, path)
    plan_mod.clear_cache_memo()
    yield path
    plan_mod.clear_cache_memo()


@pytest.fixture
def tiled(monkeypatch):
    """Treat every op as tiled, so a CPU selection reaches the (patched)
    measurement loop."""
    monkeypatch.setattr(plan_mod, "op_ignores_tiles", lambda op, dev: False)


def _twin(jcfg) -> KernelConfig:
    return KernelConfig.from_dict(jcfg.to_dict())


# ---------------------------------------------------------------------------
# parity with the reference's pure functions
# ---------------------------------------------------------------------------

def test_pool_is_the_references():
    assert [c.to_dict() for c in plan_mod.CONFIG_POOL] == \
        [c.to_dict() for c in jplan.CONFIG_POOL]
    assert plan_mod.DECODE_BLOCK_MS == jplan.DECODE_BLOCK_MS
    assert plan_mod.WGRAD_SPANS == jplan.WGRAD_SPANS
    assert [c.to_dict() for c in plan_mod.DECODE_POOL] == \
        [c.to_dict() for c in jplan.DECODE_POOL]


@pytest.mark.parametrize("family", ["gemm", "wgrad"])
@pytest.mark.parametrize("transposable", [True, False])
@pytest.mark.parametrize("kn", [(2048, 1408), (128, 256), (256, 128),
                                (4096, 4096), (1024, 512), (100, 128)])
def test_candidate_pool_keeps_the_references_entries(kn, transposable,
                                                     family):
    k, n = kn
    got = plan_mod.candidate_pool(k, n, require_transposable=transposable,
                                  family=family)
    want = jplan.candidate_pool(k, n, require_transposable=transposable,
                                family=family)
    assert [c.to_dict() for c in got] == [c.to_dict() for c in want]


def test_cache_keys_differ_only_in_kind_backend_and_model_version():
    for m in (1, 2, 3, 16, 17, 513, 1024, 1536, 16384, 16385):
        assert plan_mod._m_bucket(m) == jplan._m_bucket(m)
        for op in plan_mod._AUTOTUNE_OPS:
            got = plan_mod.cache_key(H100, "cuda", m, 2048, 1408, 60,
                                     op=op).split("|")
            want = jplan.cache_key("TPU v5 lite", "pallas", m, 2048, 1408,
                                   60, op=op).split("|")
            assert got[2:-1] == want[2:-1]
            assert (got[0], got[1]) == (H100, "cuda")
            assert got[-1] == f"rm{res.RESOURCE_MODEL_VERSION}"
    assert set(plan_mod._AUTOTUNE_OPS) == set(jplan._AUTOTUNE_OPS)


@pytest.mark.parametrize("spec_name", ["tpu v5e", "tpu", "cpu"])
def test_cost_model_is_the_references_under_a_tpu_shaped_spec(spec_name):
    js = jplan.DEVICE_SPECS[spec_name]
    spec = plan_mod.DeviceSpec(js.name, js.peak_flops, js.hbm_bw,
                               js.hbm_bytes, mma_m=128)
    for jc in jplan.CONFIG_POOL:
        c = _twin(jc)
        for m, k, n, g in SHAPES:
            for kw in ({}, {"quant_output": True}, {"precision": "bf16"}):
                assert plan_mod.estimate_cost_s(m, k, n, g, c, spec, **kw) \
                    == jplan.estimate_cost_s(m, k, n, g, jc, js, **kw)
            for prec in ("bf16", "fp8"):
                assert plan_mod.wgrad_operand_bytes(
                    m, k, n, g, c, precision=prec) == \
                    jplan.wgrad_operand_bytes(m, k, n, g, jc, precision=prec)
                assert plan_mod.estimate_cost_s_wgrad(
                    m, k, n, g, c, spec, precision=prec) == \
                    jplan.estimate_cost_s_wgrad(m, k, n, g, jc, js,
                                                precision=prec)
            assert plan_mod.estimate_cost_s_quantize(m, k, c, spec) == \
                jplan.estimate_cost_s_quantize(m, k, jc, js)
            assert plan_mod.estimate_cost_s_act_quant(m, k, c, spec) == \
                jplan.estimate_cost_s_act_quant(m, k, jc, js)


def test_the_cards_spec_charges_64_row_mma_passes():
    import dataclasses
    assert (plan_mod._eff_rows(16, 64), plan_mod._eff_rows(16, 128)) == \
        (64, 128)
    assert plan_mod._eff_rows(128, 64) == plan_mod._eff_rows(128, 128) == 128
    # with memory free, a 16-row tile's compute costs twice as much on an
    # MXU-shaped spec as on wgmma's 64-row passes; a 128-row tile the same
    h100 = dataclasses.replace(plan_mod.device_spec(H100), hbm_bw=1e30)
    tpu = dataclasses.replace(h100, mma_m=128)
    m, k, n, g = 16384, 4096, 4096, 1
    c16 = KernelConfig(block_m=16)
    assert plan_mod.estimate_cost_s(m, k, n, g, c16, tpu) == \
        2 * plan_mod.estimate_cost_s(m, k, n, g, c16, h100)
    assert plan_mod.estimate_cost_s(m, k, n, g, KernelConfig(), h100) == \
        plan_mod.estimate_cost_s(m, k, n, g, KernelConfig(), tpu)


# ---------------------------------------------------------------------------
# KernelConfig: (de)serialization and the default seam
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {}, {"block_m": 16, "out_dtype": torch.bfloat16},
    {"out_dtype": torch.float32, "wgrad_precision": "fp8"},
    {"backend": "padded_baseline", "fuse_producer": True},
    {"block_m": 256, "n_span": 4, "k_span": 2},
])
def test_to_dict_round_trips_and_spells_dtypes_as_the_reference(kw):
    cfg = KernelConfig(**kw)
    d = cfg.to_dict()
    assert KernelConfig.from_dict(json.loads(json.dumps(d))) == cfg
    jkw = {k: v for k, v in kw.items() if k != "backend"}
    if "out_dtype" in jkw:
        jkw["out_dtype"] = getattr(jnp, str(kw["out_dtype"])[6:])
    want = jplan.KernelConfig(**jkw).to_dict()
    want["backend"] = kw.get("backend")
    assert d == want


def test_kernel_config_span_checks():
    for bad in (0, -1, 1.5, True):
        with pytest.raises(ValueError, match="n_span"):
            KernelConfig(n_span=bad)
    cfg = KernelConfig(n_span=2, k_span=4)
    assert cfg.effective_blocks("wgrad") == (512, 256)
    assert cfg.effective_blocks("gemm") == (128, 128)
    assert cfg.compatible(512, 256, "wgrad")
    assert not cfg.compatible(256, 256, "wgrad")
    with pytest.raises(ValueError, match="k_span=4"):
        cfg.validate(64, 256, 256, family="wgrad")
    with pytest.raises(ValueError):
        KernelConfig.from_dict({**cfg.to_dict(), "out_dtype": "no_such"})


def test_default_seam():
    assert KernelConfig.default(H100) == KernelConfig(block_m=128)
    assert KernelConfig.default("cpu") == KernelConfig()
    assert plan_mod.pinned_default() is None
    pin = KernelConfig(block_m=16, wgrad_precision="fp8")
    plan_mod.set_default_config(pin)
    try:
        assert plan_mod.pinned_default() is pin
        assert plan_mod.get_default_config() is pin
        assert plan_mod.resolve_config(None) is pin
        assert plan_mod.resolve_config(
            None, wgrad_precision="bf16").wgrad_precision == "bf16"
        assert plan_mod.resolve_config(
            None, backend="padded_baseline").backend == "padded_baseline"
        with plan_mod.default_config(KernelConfig()):
            assert plan_mod.get_default_config() == KernelConfig()
        assert plan_mod.get_default_config() is pin
    finally:
        plan_mod.set_default_config(None)
    assert plan_mod.pinned_default() is None
    assert plan_mod.get_default_config() == KernelConfig.default()


def test_check_backend_points_at_the_registry_item():
    with pytest.raises(NotImplementedError,
                       match=r"kernels/dispatch.py\) has \('cuda', 'plain', "
                             r"'padded_baseline'\)"):
        KernelConfig(backend="pallas")


# ---------------------------------------------------------------------------
# PlanCache / shared_plan
# ---------------------------------------------------------------------------

def _fields(p):
    return (p.group_offsets, p.group_ids, p.m_tile_ids)


def _equal(p, q):
    return (p.m, p.block_m, p.num_groups) == (q.m, q.block_m, q.num_groups) \
        and all(torch.equal(a, b) for a, b in zip(_fields(p), _fields(q)))


def test_shared_plan_is_make_tile_plan_and_builds_once_per_key():
    rng = np.random.default_rng(0)
    cache = plan_mod.PlanCache()
    with events.capture() as evs:
        for bm in (16, 128):
            for _ in range(4):
                sizes = torch.from_numpy(
                    (rng.integers(0, 40, 12) * (rng.random(12) < 0.7))
                    .astype(np.int32))
                got = cache.get(sizes, 600, block_m=bm)
                assert _equal(got, plan_mod.make_tile_plan(sizes, 600,
                                                           block_m=bm))
    # one build (and one plan_build event) for each of the two keys; the
    # four make_tile_plan calls of each emit theirs too
    assert cache.builds == 2
    assert events.count(evs, "plan_build") == 2 + 8
    sizes = torch.tensor([3, 0, 9], dtype=torch.int64)
    cache.get(sizes, 600, block_m=16)          # another dtype: another key
    assert cache.builds == 3
    cache.clear()
    assert cache.builds == 0


def test_an_earlier_plan_survives_a_later_replay():
    cache = plan_mod.PlanCache()
    a = torch.tensor([5, 0, 17, 200, 0, 3, 64, 1], dtype=torch.int32)
    b = torch.tensor([0, 90, 1, 1, 0, 0, 200, 0], dtype=torch.int32)
    pa = cache.get(a, 300, block_m=16)
    keep = [t.clone() for t in _fields(pa)]
    pb = cache.get(b, 300, block_m=16)
    assert cache.builds == 1
    assert all(torch.equal(x, y) for x, y in zip(_fields(pa), keep))
    assert _equal(pb, plan_mod.make_tile_plan(b, 300, block_m=16))
    assert not any(x.data_ptr() == y.data_ptr()
                   for x in _fields(pa) for y in _fields(pb))


def test_a_replay_dispatches_fewer_ops_than_a_build():
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops += 1
            return func(*args, **(kwargs or {}))

    gs = torch.tensor([5, 0, 17, 200], dtype=torch.int32)
    cache = plan_mod.PlanCache()
    cache.get(gs, 300, block_m=16)
    with Count() as build:
        plan_mod.make_tile_plan(gs, 300, block_m=16)
    with Count() as replay:
        cache.get(gs, 300, block_m=16)
    assert replay.ops == build.ops - 2       # no arange, no zeros


def test_padded_gemm_plans_once_per_static_shape():
    from repro_torch.core import padding_baseline as tpb
    from repro_torch.kernels.ref import quantize_blockwise_ref, \
        quantize_tilewise_ref
    g = torch.Generator().manual_seed(0)
    a8, sa = quantize_tilewise_ref(torch.randn((64, 256), generator=g))
    b8, sb = quantize_blockwise_ref(torch.randn((4, 256, 128), generator=g))
    plan_mod.PLAN_CACHE.clear()
    outs = []
    for sizes in ([10, 30, 0, 24], [64, 0, 0, 0], [1, 2, 3, 4]):
        gs = torch.tensor(sizes, dtype=torch.int32)
        outs.append(tpb.grouped_gemm_fp8_padded(
            a8, sa, b8, sb, gs, config=KernelConfig(block_m=16)))
    assert plan_mod.PLAN_CACHE.builds == 1
    assert all(o.shape == (64, 128) for o in outs)


# ---------------------------------------------------------------------------
# selection and the JSON cache (the reference's tests, measurement patched)
# ---------------------------------------------------------------------------

def test_autotune_persists_and_reloads_identically(cache, tiled,
                                                   monkeypatch):
    measured = []

    def fake(config, *a, **kw):
        measured.append(config.block_m)
        return {16: 2e-3, 128: 1e-3}[config.block_m]
    monkeypatch.setattr(plan_mod, "_measure_candidate", fake)
    first = plan_mod.autotune(256, 128, 128, 4, device="cpu",
                              max_candidates=2)
    assert first.block_m == 128 and sorted(measured) == [16, 128]
    rep = plan_mod.last_autotune_report()
    assert rep["source"] == "measured" and not rep["cache_hit"]
    assert {c["block_m"]: s for c, _, s in rep["candidates"]} == \
        {16: 2e-3, 128: 1e-3}
    plan_mod.clear_cache_memo()            # force a re-read from disk
    second = plan_mod.autotune(256, 128, 128, 4, device="cpu",
                               max_candidates=2)
    assert second == first and len(measured) == 2
    assert plan_mod.last_autotune_report()["cache_hit"]


def test_autotune_cost_model_only_where_tile_free(cache, monkeypatch):
    """On the CPU every op is tile-free: the cost model ranks, nothing is
    measured, the entry is still cached (under the "plain" backend)."""
    monkeypatch.setattr(plan_mod, "_measure_candidate",
                        lambda *a, **kw: pytest.fail("measured on the CPU"))
    for op in plan_mod._AUTOTUNE_OPS:
        m, k, n, g = (1024, 2048, 1408, 60)
        if op in ("quantize", "act_quant"):
            n = g = 0
        plan_mod.autotune(m, k, n, g, op=op, device="cpu")
        assert plan_mod.last_autotune_report()["source"] == "cost_model"
    entries = plan_mod.load_cache(cache)
    assert len(entries) == len(plan_mod._AUTOTUNE_OPS)
    assert all(k.startswith("cpu|plain") for k in entries)
    assert all(e["source"] == "cost_model" for e in entries.values())
    wgrad_fp8 = plan_mod.autotune(1024, 2048, 1408, 60, op="wgrad_fp8",
                                  device="cpu")
    assert wgrad_fp8.wgrad_precision == "fp8"


def test_save_cache_merges_concurrent_writers(cache):
    plan_mod.save_cache({"a": {"config": KernelConfig().to_dict()}}, cache)
    plan_mod.clear_cache_memo()            # a second process's view
    plan_mod.save_cache({"b": {"config": KernelConfig().to_dict()}}, cache)
    plan_mod.clear_cache_memo()
    assert set(plan_mod.load_cache(cache)) == {"a", "b"}


def test_autotune_m_bucketing_shares_entries(cache):
    a = plan_mod.autotune(513, 128, 128, 4, device="cpu", measure=False)
    b = plan_mod.autotune(1024, 128, 128, 4, device="cpu", measure=False)
    assert a == b
    assert len(plan_mod.load_cache(cache)) == 1


def test_autotune_measured_request_upgrades_cost_model_entry(cache, tiled,
                                                             monkeypatch):
    seeded = plan_mod.autotune(256, 128, 128, 4, device="cpu",
                               measure=False)
    key = plan_mod.cache_key("cpu", "plain", 256, 128, 128, 4)
    assert plan_mod.load_cache(cache)[key]["source"] == "cost_model"
    monkeypatch.setattr(plan_mod, "_measure_candidate",
                        lambda c, *a, **kw: 0.0 if c == seeded else 1.0)
    upgraded = plan_mod.autotune(256, 128, 128, 4, device="cpu",
                                 measure=True, max_candidates=2)
    (entry,) = plan_mod.load_cache(cache).values()
    assert entry["source"] == "measured" and upgraded == seeded
    monkeypatch.setattr(plan_mod, "_measure_candidate",
                        lambda *a, **kw: pytest.fail("re-measured"))
    again = plan_mod.autotune(256, 128, 128, 4, device="cpu", measure=True)
    assert again == upgraded


def test_the_padded_baseline_tunes_under_its_own_name(cache):
    cfg = plan_mod.autotune(1536, 2048, 1408, 64, device="cpu",
                            backend="padded_baseline")
    assert cfg.backend == "padded_baseline"
    assert plan_mod.last_autotune_report()["key"].startswith(
        "cpu|padded_baseline|M2048|")
    with pytest.raises(NotImplementedError):
        plan_mod.autotune(256, 128, 128, 4, device="cpu", backend="pallas")


# ---------------------------------------------------------------------------
# decode_config and the Engine
# ---------------------------------------------------------------------------

def test_decode_config_selects_the_built_16_row_tile(cache):
    with events.capture() as evs:
        cfg = plan_mod.decode_config(32, 2048, 1408, 60, device="cpu")
    assert events.count(evs, "decode_select") == 1
    assert cfg == KernelConfig(block_m=16)
    rep = plan_mod.last_autotune_report()
    assert rep["key"].endswith(f"|decode|rm{res.RESOURCE_MODEL_VERSION}")
    ((pruned, reason),) = rep["pruned"]
    assert pruned["block_m"] == 8 and reason.startswith("no CUDA variant")


@pytest.mark.parametrize("arch,fields", [
    ("qwen2-moe-a2.7b", {}),
    ("qwen2-moe-a2.7b", {"kernel_config": KernelConfig(fuse_producer=True)}),
    ("deepseek-moe-16b", {"gemm_backend": "padded_baseline"}),
    ("qwen3-1.7b", {}),
])
def test_engine_selects_decode_tiles_once_for_moe_only(cache, arch, fields):
    import dataclasses
    cfg = dataclasses.replace(smoke_config(arch), precision="fp8", **fields)
    model = make_model(cfg, "cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 8),
                           generator=torch.Generator().manual_seed(1))
    with events.capture() as evs:
        engine = Engine(model, params, max_new_tokens=3, device="cpu")
    if cfg.moe is None:
        assert events.count(evs, "decode_select") == 0
        assert engine.decode_config is None
        assert engine._decode_model is engine.model
        old_rule = KernelConfig(block_m=16)
    else:
        assert events.count(evs, "decode_select") == 1
        # the selection is what the fixed rule gave: the model's config
        # with 16-row tiles
        old_rule = (cfg.resolved_kernel_config or KernelConfig()).with_(
            block_m=16)
        assert engine.decode_config == old_rule
    pinned = Engine(model, params, max_new_tokens=3, device="cpu",
                    decode_kernel_config=old_rule)
    batch = {"tokens": tokens}
    assert torch.equal(engine.generate(batch).tokens,
                       pinned.generate(batch).tokens)
