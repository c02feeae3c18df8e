"""The port's static resource model of its Hopper kernels
(``repro_torch/kernels/resources.py``) and its uses in ``plan.py``:
``KernelConfig.validate``'s shared-memory budget, autotune's static
pruning (each pruned entry with its reason), skipped-with-reason
measurement and the resource-model-versioned cache key.  Where the
reference's pure functions carry over unchanged (the degeneracy rules),
they are held against the JAX package's on the same arguments.  Nothing
here times anything: ``_measure_candidate`` is monkeypatched wherever a
selection would measure."""
import json

import pytest
import torch

from repro.kernels import resources as jres
from repro_torch.kernels import plan as plan_mod
from repro_torch.kernels import resources as res
from repro_torch.kernels import wgrad_kernel as wk
from repro_torch.kernels.plan import KernelConfig
from repro_torch.kernels.ref import quantize_tilewise_ref

H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: its tensors are tiny,
    and beside the other test workers a thread pool oversubscribes the
    cores."""
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


# ---------------------------------------------------------------------------
# the model: shared memory, threads, budgets
# ---------------------------------------------------------------------------

def test_shared_memory_mirrors_each_kernels_formula():
    """Hand arithmetic of each source's constants (grouped_gemm.cu
    ``Shape<BM>::kSmem``, gmm_bf16.cu ``smem_bytes``, wgrad_bf16.cu,
    wgrad.cu, flash_attention.cu ``Cfg<D>::kSmem``)."""
    def smem(kernel, **kw):
        return res.kernel_resources(kernel, **kw)["smem"]
    # B2 / B7: 1024 + stages x (NS A boxes + 16 KB B) + 2 x 32 KB + barriers
    assert smem("gmm", block_m=128) == 1024 + 5 * (2 * 8192 + 16384) \
        + 65536 + 2 * 5 * 8
    assert smem("gmm_quant", block_m=16) == 1024 + 8 * (2048 + 16384) \
        + 65536 + 2 * 8 * 8
    # B5: 4 stages x (NC 8 KB A slabs + 16 KB B) + the staged output tile
    assert smem("gmm_bf16", block_m=128, out_itemsize=4) == \
        1024 + 4 * (2 * 8192 + 16384) + 128 * 128 * 4 + 64
    assert smem("gmm_bf16", block_m=16) == 1024 + 4 * (8192 + 16384) \
        + 16 * 128 * 2 + 64
    # B4 and B6 with a bf16 dw tile
    assert smem("wgrad") == 1024 + 4 * 4 * 8192 + 128 * 128 * 2 + 64
    assert smem("wgrad_fp8") == 1024 + 4 * 2 * 8192 + 2 * 6 * 8192 \
        + 128 * 128 * 2 + 12 * 8
    # B8: q, o and 2-stage k and v rings of 64 rows x D
    assert smem("flash_attention", head_dim=128) == 1024 + 6 * 16384 + 80
    assert smem("flash_attention", head_dim=64) == 1024 + 6 * 8192 + 80
    assert smem("quantize_tilewise") == smem("act_quantize") == 0


def test_every_built_variant_fits_the_card():
    budget = res.smem_budget(H100)
    seen = set()
    for v in res.variants():
        seen.add(v["kernel"])
        assert 0 <= v["smem"] <= budget, v
        assert v["threads"] % 32 == 0, v
        ctas = v["ctas_per_sm"] or 1
        assert ctas * (v["smem"] + 1024) <= \
            res.budgets(H100)["smem_per_sm"], v
    assert seen == set(res.KERNELS)
    # B2 / B7 and B5 at both tile heights and both output dtypes
    assert sum(v["kernel"] == "gmm" for v in res.variants()) == 4
    assert sum(v["kernel"] == "gmm_bf16" for v in res.variants()) == 8


def test_register_fit_counts_whole_warps_in_units_of_8():
    # ptxas gives B2's 384 threads 168 registers: 64512 of 65536
    assert res.fits_sm(168, 384, 1, 230480)["fits"]
    assert not res.fits_sm(176, 384, 1, 230480)["fits"]
    # 161 registers cost 168 a thread
    assert res.fits_sm(161, 384, 1, 0)["registers_used"] == 168 * 384
    # B5 at block_m 16: two CTAs of 160 threads
    assert res.fits_sm(168, 160, 2, 103488)["fits"]
    assert not res.fits_sm(168, 160, 2, 120000)["fits"]      # smem
    assert not res.fits_sm(256, 32, 1, 0)["fits"]            # > 255 a thread


def test_budget_prefix_matching():
    assert res.smem_budget(H100) == 232448
    assert res.smem_budget("nvidia h100 pcie") == 232448
    assert res.smem_budget("cpu") == 232448
    assert res.smem_budget("unknown accelerator") == 232448
    assert res.budgets(H100)["regs_per_sm"] == 65536
    assert plan_mod.device_spec(H100).smem_bytes == 232448
    assert plan_mod.device_spec(H100).mma_m == 64
    # the CPU entry carries the card's numbers
    cpu, h100 = plan_mod.device_spec("cpu"), plan_mod.device_spec(H100)
    assert (cpu.peak_flops, cpu.hbm_bw, cpu.mma_m, cpu.smem_bytes) == \
        (h100.peak_flops, h100.hbm_bw, h100.mma_m, h100.smem_bytes) == \
        (989e12, 3.35e12, 64, 232448)


# ---------------------------------------------------------------------------
# the static checks
# ---------------------------------------------------------------------------

def test_alignment_issues_in_the_papers_terms():
    ok = {"block_m": 16, "block_n": 128, "block_k": 128}
    assert res.alignment_issues(ok, k=2048, n=1408) == []
    codes = {c for c, _ in res.alignment_issues(
        {"block_m": 12, "block_n": 96, "block_k": 64})}
    assert codes == {"mma_rows", "swizzle", "quant"}
    # 16-byte global rows for TMA: K = 1400 e4m3 is not, K = 1400 bf16 is
    assert [c for c, _ in res.alignment_issues(ok, k=1400)] == ["tma_row"]
    assert res.alignment_issues(ok, k=1400, itemsize=2) == []


def test_no_cuda_variant_reasons():
    for bm in (8, 64, 256, 512):
        assert "no CUDA variant" in res.missing_variant("gemm", {"block_m": bm})
    for bm in res.CUDA_BLOCK_MS:
        assert res.missing_variant("gemm", {"block_m": bm}) is None
        assert res.missing_variant("gemm_quant", {"block_m": bm}) is None
    assert "tile N and K" in res.missing_variant(
        "gemm", {"block_m": 128, "block_n": 256})
    # the wgrads read no block_m, but have no spans
    assert res.missing_variant("wgrad", {"block_m": 512}) is None
    assert "spans" in res.missing_variant(
        "wgrad", {"block_m": 128, "n_span": 2, "k_span": 2})
    # the quantizers take no tile at all
    assert res.missing_variant("quantize", {"block_m": 8}) is None


@pytest.mark.parametrize("cfg,shape,kw", [
    ({"block_m": 8}, (1, 256, 256), {}),
    ({"block_m": 16}, (1, 256, 256), {}),
    ({"block_m": 512}, (256, 4096, 4096), {}),
    ({"block_m": 128, "block_n": 256}, (4096, 128, 128), {}),
    ({"block_m": 128}, (4096, 256, 256), {"n_span": 4, "k_span": 2}),
    ({"block_m": 128}, (64, 512, 512), {"elementwise": True}),
])
def test_degeneracy_rules_match_the_reference(cfg, shape, kw):
    m, k, n = shape
    assert res.degeneracy_issues(cfg, m=m, k=k, n=n, **kw) == \
        jres.degeneracy_issues(cfg, m=m, k=k, n=n, **kw)


def test_infeasible_reason_order():
    budget = res.smem_budget(H100)
    shape = dict(m=8192, k=4096, n=4096)

    def reason(cfg, **kw):
        return res.infeasible_reason("gemm", cfg, smem_bytes=budget,
                                     **{**shape, **kw})
    assert reason({"block_m": 128}) is None
    assert reason({"block_m": 128, "block_n": 96}).startswith("misaligned")
    assert reason({"block_m": 64}).startswith("no CUDA variant")
    assert reason({"block_m": 128}, m=16).startswith("degenerate grid")
    over = res.infeasible_reason("gemm", {"block_m": 128}, smem_bytes=200000,
                                 **shape)
    assert "shared memory 230480 B" in over and "200000 B" in over


# ---------------------------------------------------------------------------
# KernelConfig.validate's budget check; the wgrad spans
# ---------------------------------------------------------------------------

def test_validate_raises_with_the_computed_bytes():
    # the B2 template at block_m 256: 8 stages of 24 KB, over 232448 B
    with pytest.raises(ValueError, match="263296 B of shared memory"):
        KernelConfig(block_m=256).validate(16384, 4096, 4096)


def test_validate_passes_the_built_pool_entries():
    built = [c for c in plan_mod.CONFIG_POOL
             if res.missing_variant("gemm", c) is None]
    assert {c.block_m for c in built} == {16, 128}
    for cfg in built:
        assert cfg.validate(8192, 4096, 4096) is cfg
        assert cfg.validate(8192, 4096, 4096, family="gemm_quant") is cfg
    for prec in ("bf16", "fp8"):
        cfg = KernelConfig(wgrad_precision=prec)
        assert cfg.validate(8192, 4096, 4096, family="wgrad") is cfg
    with pytest.raises(ValueError, match="unknown family"):
        KernelConfig().validate(8, 128, 128, family="conv")


def test_wgrad_spans_plain_equals_span_one_and_cuda_refuses():
    g = torch.Generator().manual_seed(0)
    x = torch.randn((40, 256), generator=g).bfloat16()
    dy = torch.randn((40, 512), generator=g).bfloat16()
    gs = torch.tensor([10, 0, 25], dtype=torch.int32)
    one = wk.gmm_wgrad(x, dy, gs)
    wide = wk.gmm_wgrad(x, dy, gs, n_span=4, k_span=2)
    assert torch.equal(one, wide)
    with pytest.raises(ValueError, match="k_span=4"):
        wk.gmm_wgrad(x, dy, gs, k_span=4)            # K=256 < 4 x 128
    # the CUDA wrapper refuses a span before it looks at the tensors
    with pytest.raises(ValueError, match="no multi-tile spans"):
        wk.gmm_wgrad_cuda(x, dy, gs, n_span=2)
    (x8, sx), (d8, sd) = (quantize_tilewise_ref(t.float()) for t in (x, dy))
    with pytest.raises(ValueError, match="no multi-tile spans"):
        wk.gmm_wgrad_fp8_cuda(x8, sx, d8, sd, gs, k_span=2)


# ---------------------------------------------------------------------------
# autotune: static pruning, skipped-with-reason measurement
# ---------------------------------------------------------------------------

def test_autotune_prunes_each_entry_with_its_reason(cache):
    plan_mod.reset_prune_stats()
    cfg = plan_mod.autotune(256, 128, 128, 4, device="cpu")
    rep = plan_mod.last_autotune_report()
    assert cfg.block_m in res.CUDA_BLOCK_MS
    legal = [c for c in plan_mod.candidate_pool(128, 128)
             if (c.n_span, c.k_span) == (1, 1)]
    kept = [c for c, _, _ in rep["candidates"]]
    # nothing vanishes: every legal entry is ranked or pruned with a reason
    assert len(kept) + len(rep["pruned"]) == len(legal)
    reasons = {c["block_m"]: r for c, r in rep["pruned"]}
    assert set(reasons) == {8, 64, 256, 512}
    assert all(r.startswith("no CUDA variant") for r in reasons.values())
    assert plan_mod.prune_stats()["gemm"] == 4
    assert rep["source"] == "cost_model" and not rep["skipped"]


def test_autotune_pruned_config_never_reaches_measurement(cache, tiled,
                                                          monkeypatch):
    measured = []

    def spy(config, *a, **kw):
        measured.append(config.block_m)
        return 1e-3 * config.block_m
    monkeypatch.setattr(plan_mod, "_measure_candidate", spy)
    cfg = plan_mod.autotune(256, 128, 128, 4, device="cpu")
    assert sorted(measured) == [16, 128]
    assert cfg.block_m == 16
    assert plan_mod.last_autotune_report()["source"] == "measured"


def test_autotune_measurement_failure_is_skipped_not_fatal(cache, tiled,
                                                          monkeypatch):
    def flaky(config, *a, **kw):
        if config.block_m == 128:
            raise RuntimeError("synthetic launch failure")
        return 1.0
    monkeypatch.setattr(plan_mod, "_measure_candidate", flaky)
    cfg = plan_mod.autotune(256, 128, 128, 4, device="cpu")
    assert cfg.block_m == 16
    rep = plan_mod.last_autotune_report()
    assert any("synthetic launch failure" in r for _, r in rep["skipped"])
    with open(cache) as f:
        (entry,) = json.load(f)["entries"].values()
    assert entry["skipped"] and entry["source"] == "measured"


def test_autotune_all_measurements_failing_falls_back_to_cost_model(
        cache, tiled, monkeypatch):
    def always_fail(config, *a, **kw):
        raise RuntimeError("no card")
    monkeypatch.setattr(plan_mod, "_measure_candidate", always_fail)
    cfg = plan_mod.autotune(256, 128, 128, 4, device="cpu")
    rep = plan_mod.last_autotune_report()
    assert rep["source"] == "cost_model" and len(rep["skipped"]) == 2
    assert cfg == KernelConfig.from_dict(rep["candidates"][0][0])


def test_measurement_needs_a_card_and_a_tiled_op():
    with pytest.raises(ValueError, match="CUDA device"):
        plan_mod._measure_candidate(KernelConfig(), 64, 128, 128, 2,
                                    op="gemm", device=torch.device("cpu"))
    assert plan_mod.op_ignores_tiles("gemm", torch.device("cpu"))
    assert not plan_mod.op_ignores_tiles("gemm", torch.device("cuda"))
    for op in ("quantize", "act_quant", "wgrad", "wgrad_fp8"):
        assert plan_mod.op_ignores_tiles(op, torch.device("cuda"))


def test_decode_on_a_tiny_batch_keeps_a_built_tile(cache):
    """At M=4 the 16-row tile is degenerate and 8 has no CUDA variant:
    the degenerate built tile stands rather than an unbuilt one."""
    cfg = plan_mod.autotune(4, 256, 128, 8, op="decode", device="cpu")
    assert cfg.block_m == 16
    (pruned,) = plan_mod.last_autotune_report()["pruned"]
    assert pruned[0]["block_m"] == 8


# ---------------------------------------------------------------------------
# cache-key versioning
# ---------------------------------------------------------------------------

def test_cache_key_is_namespaced_by_resource_model_version():
    key = plan_mod.cache_key(H100, "cuda", 256, 128, 128, 4)
    assert key.endswith(f"|rm{res.RESOURCE_MODEL_VERSION}")
    key_wgrad = plan_mod.cache_key("cpu", "plain", 256, 128, 128, 4,
                                   op="wgrad")
    assert f"|wgrad|rm{res.RESOURCE_MODEL_VERSION}" in key_wgrad


@pytest.mark.parametrize("stale_key", [
    "cpu|plain|M256|K128|N128|G4",                           # no |rm
    f"cpu|plain|M256|K128|N128|G4|rm{res.RESOURCE_MODEL_VERSION - 1}",
])
def test_old_cache_entries_are_ignored_not_crashed_on(cache, stale_key):
    stale = {"version": 1, "entries": {stale_key: {
        "config": {"block_m": 512, "block_n": 128, "block_k": 128,
                   "backend": None, "out_dtype": None},
        "seconds": 1.0, "source": "measured", "pool_size": 6,
        "op": "gemm"}}}
    with open(cache, "w") as f:
        json.dump(stale, f)
    cfg = plan_mod.autotune(256, 128, 128, 4, device="cpu")
    assert cfg.block_m != 512
    with open(cache) as f:
        entries = json.load(f)["entries"]
    assert stale_key in entries          # preserved, not clobbered
    assert plan_mod.cache_key("cpu", "plain", 256, 128, 128, 4) in entries


def test_prune_stats_reset():
    plan_mod.reset_prune_stats()
    assert plan_mod.prune_stats() == {}
