"""The port's static resource model of its Hopper kernels
(``repro_torch/kernels/resources.py``) and its uses in ``plan.py``:
``KernelConfig.validate``'s shared-memory budget, autotune's static
pruning (each pruned entry with its reason), skipped-with-reason
measurement and the resource-model-versioned cache key.  Where the
reference's pure functions carry over unchanged (the degeneracy rules),
they are held against the JAX package's on the same arguments.  Nothing
here times anything: ``_measure_candidate`` is monkeypatched wherever a
selection would measure."""
import dataclasses
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
    # B2 / B7 and B5 at the pool's six tile heights and both output dtypes
    assert sum(v["kernel"] == "gmm" for v in res.variants()) == 12
    assert sum(v["kernel"] == "gmm_bf16" for v in res.variants()) == 24


# the chosen design, by hand, per block_m: (B2 / B7 smem, B5 smem at a
# bf16 / f32 output, B5 threads, B5 CTAs an SM, rows of a piece, store
# descriptors).  block_m 8 and 16 run the decode instance (one 16-row A
# slot a stage, 8 stages; B5 one consumer warpgroup on a 16-row stage),
# 64 to 512 the tall one (two 64-row slots, 5 stages; B5 two warpgroups
# on a 128-row stage); a piece holds at most 128 rows, and the store pool
# heights 1 .. the piece's rows
_B2_SMALL = 1024 + 8 * (2048 + 16384) + 2 * 32768 + 16 * 8
_B2_TALL = 1024 + 5 * (2 * 8192 + 16384) + 2 * 32768 + 10 * 8
_B5_RING_SMALL, _B5_RING_TALL = 4 * (8192 + 16384), 4 * (2 * 8192 + 16384)
DESIGN = {
    8: (_B2_SMALL, 1024 + _B5_RING_SMALL + 16 * 256 + 64,
        1024 + _B5_RING_SMALL + 16 * 512 + 64, 160, 2, 8, 4),
    16: (_B2_SMALL, 1024 + _B5_RING_SMALL + 16 * 256 + 64,
         1024 + _B5_RING_SMALL + 16 * 512 + 64, 160, 2, 16, 5),
    64: (_B2_TALL, 1024 + _B5_RING_TALL + 128 * 256 + 64,
         1024 + _B5_RING_TALL + 128 * 512 + 64, 288, 1, 64, 7),
    128: (_B2_TALL, 1024 + _B5_RING_TALL + 128 * 256 + 64,
          1024 + _B5_RING_TALL + 128 * 512 + 64, 288, 1, 128, 8),
    256: (_B2_TALL, 1024 + _B5_RING_TALL + 128 * 256 + 64,
          1024 + _B5_RING_TALL + 128 * 512 + 64, 288, 1, 128, 8),
    512: (_B2_TALL, 1024 + _B5_RING_TALL + 128 * 256 + 64,
          1024 + _B5_RING_TALL + 128 * 512 + 64, 288, 1, 128, 8),
}


@pytest.mark.parametrize("block_m", sorted(DESIGN))
def test_variants_equal_the_designs_arithmetic(block_m):
    """``variants()``, variant for variant at one block_m: shared memory,
    threads, CTAs an SM, rows of a piece and store descriptors as the
    design's arithmetic gives them, each variant taking both block_n and
    its library's query arguments."""
    b2, b5_bf16, b5_f32, b5_threads, b5_ctas, rows, pool = DESIGN[block_m]
    vs = [v for v in res.variants()
          if v["kernel"].startswith("gmm") and v["args"][0] == block_m]
    assert len(vs) == 8
    for v in vs:
        f32 = v["args"][1]
        assert v["block_ns"] == (128, 256)
        assert (v["piece_rows"], v["store_descriptors"]) == (rows, pool)
        if v["kernel"] == "gmm_bf16":
            assert v["library"] == "gmm_bf16"
            assert (v["smem"], v["threads"], v["ctas_per_sm"]) == \
                (b5_f32 if f32 else b5_bf16, b5_threads, b5_ctas)
        else:
            assert v["library"] == "grouped_gemm"
            assert v["args"][2] == (v["kernel"] == "gmm_quant")
            assert (v["smem"], v["threads"], v["ctas_per_sm"]) == \
                (b2, 384, 1)
    # the pool covers every residue of the tile: a count of 1 .. rows
    # rows is a sum of distinct heights 1, 2, ..., rows
    heights = [1 << i for i in range(pool)]
    assert heights[-1] == rows and sum(heights) >= rows


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
    """Every entry of the pool is built: the grouped GEMMs' 10 (the 2
    decode entries and 4 block_m x 2 (block_n, block_k)), and for the
    wgrads the 6 span entries and the 4 at block_n 256 as well; a
    geometry outside the pool keeps its reason."""
    gemm_entries = [c for c in plan_mod.CONFIG_POOL
                    if (c.n_span, c.k_span) == (1, 1)]
    spans = [c for c in plan_mod.CONFIG_POOL
             if (c.n_span, c.k_span) != (1, 1)]
    wide = [c for c in gemm_entries if c.block_n == 256]
    assert len(gemm_entries) == 10 and len(spans) == 6 and len(wide) == 4
    for c in gemm_entries:
        for family in ("gemm", "gemm_quant", "wgrad"):
            assert res.missing_variant(family, c) is None
    for c in spans:
        assert res.missing_variant("wgrad", c) is None
    assert res.CUDA_BLOCK_MS == (8, 16, 64, 128, 256, 512)
    for bad in ({"block_m": 24}, {"block_m": 1024},
                {"block_m": 128, "block_n": 384},
                {"block_m": 128, "block_k": 256}):
        assert res.missing_variant("gemm", bad).startswith("no CUDA variant")
    # the wgrads read no block_m; outside the pool's (block_n, n_span,
    # k_span) they keep a reason
    assert res.missing_variant("wgrad", {"block_m": 512}) is None
    for bad in ({"n_span": 3, "k_span": 3}, {"n_span": 2, "k_span": 1},
                {"n_span": 8, "k_span": 8}, {"block_n": 384},
                {"block_n": 256, "n_span": 2, "k_span": 2},
                {"block_k": 256}):
        reason = res.missing_variant("wgrad", {"block_m": 128, **bad})
        assert reason.startswith("no CUDA variant: the wgrads are built "
                                 "for (block_n, n_span, k_span) in"), bad
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
    assert res.infeasible_reason(
        "wgrad", {"block_m": 128, "n_span": 2, "k_span": 2},
        smem_bytes=budget, **shape) is None
    assert res.infeasible_reason(
        "wgrad", {"block_m": 128, "n_span": 3, "k_span": 3},
        smem_bytes=budget, **shape).startswith("no CUDA variant")
    assert reason({"block_m": 128}, m=16).startswith("degenerate grid")
    over = res.infeasible_reason("gemm", {"block_m": 128}, smem_bytes=200000,
                                 **shape)
    assert "shared memory 230480 B" in over and "200000 B" in over


# ---------------------------------------------------------------------------
# KernelConfig.validate's budget check; the wgrad spans
# ---------------------------------------------------------------------------

def test_validate_raises_with_the_computed_bytes(monkeypatch):
    # block_m 256 runs on B2's tall instance: 5 stages of two 8 KB A
    # boxes and a 16 KB B tile, two 32 KB f16 tiles, 10 barriers and the
    # 1024 B of alignment, 230480 B; on a card of 220000 B a CTA it raises
    assert 1024 + 5 * (2 * 8192 + 16384) + 2 * 32768 + 10 * 8 == 230480
    small = dataclasses.replace(plan_mod.device_spec("cpu"),
                                smem_bytes=220000)
    monkeypatch.setattr(plan_mod, "device_spec", lambda kind=None: small)
    with pytest.raises(ValueError, match="230480 B of shared memory.*"
                                         "over the 220000 B budget"):
        KernelConfig(block_m=256).validate(16384, 4096, 4096)
    # the decode instance, 214144 B, fits it
    assert KernelConfig(block_m=8).validate(16, 4096, 4096).block_m == 8


def test_validate_passes_the_built_pool_entries():
    built = [c for c in plan_mod.CONFIG_POOL
             if res.missing_variant("gemm", c) is None]
    assert {c.block_m for c in built} == {8, 16, 64, 128, 256, 512}
    assert {c.block_n for c in built} == {128, 256}
    for cfg in built:
        assert cfg.validate(8192, 4096, 4096) is cfg
        assert cfg.validate(8192, 4096, 4096, family="gemm_quant") is cfg
    for prec in ("bf16", "fp8"):
        cfg = KernelConfig(wgrad_precision=prec)
        assert cfg.validate(8192, 4096, 4096, family="wgrad") is cfg
    with pytest.raises(ValueError, match="unknown family"):
        KernelConfig().validate(8, 128, 128, family="conv")


def test_wgrad_spans_plain_equals_span_one_and_cuda_refuses():
    """The plain wgrad computes span 1's dw at any span; the CUDA
    wrappers take the pool's geometries (on CPU tensors they get as far
    as the device check) and refuse any other with the resource model's
    reason before they look at the shapes or the device."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((40, 512), generator=g).bfloat16()
    dy = torch.randn((40, 512), generator=g).bfloat16()
    gs = torch.tensor([10, 0, 25], dtype=torch.int32)
    one = wk.gmm_wgrad(x, dy, gs)
    wide = wk.gmm_wgrad(x, dy, gs, n_span=4, k_span=2)
    assert torch.equal(one, wide)
    with pytest.raises(ValueError, match="k_span=8"):
        wk.gmm_wgrad(x, dy, gs, k_span=8)            # K=512 < 8 x 128
    (x8, sx), (d8, sd) = (quantize_tilewise_ref(t.float()) for t in (x, dy))
    for fp8, cuda in ((False, wk.gmm_wgrad_cuda),
                      (True, wk.gmm_wgrad_fp8_cuda)):
        args = (x8, sx, d8, sd, gs) if fp8 else (x, dy, gs)
        for bn, ns, ks in res.WGRAD_GEOMETRIES:
            with pytest.raises(ValueError, match="must be a CUDA tensor"):
                cuda(*args, block_n=bn, n_span=ns, k_span=ks)
        for bad in ({"n_span": 2}, {"k_span": 2}, {"n_span": 3, "k_span": 3},
                    {"block_n": 256, "n_span": 2, "k_span": 2}):
            with pytest.raises(ValueError, match="no CUDA variant"):
                cuda(*args, **bad)


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
    # every entry is built: only the tile twice M's rows is pruned
    assert set(reasons) == {512}
    assert reasons[512].startswith("degenerate grid")
    assert plan_mod.prune_stats()["gemm"] == 1
    assert rep["source"] == "cost_model" and not rep["skipped"]
    # an entry no kernel is built for is pruned with that reason
    plan_mod.autotune(256, 128, 128, 4, device="cpu", refresh=True,
                      pool=plan_mod.CONFIG_POOL + (KernelConfig(block_m=24),))
    reasons = {c["block_m"]: r for c, r in
               plan_mod.last_autotune_report()["pruned"]}
    assert set(reasons) == {24, 512}
    assert reasons[24].startswith("no CUDA variant")


def test_autotune_pruned_config_never_reaches_measurement(cache, tiled,
                                                          monkeypatch):
    measured = []

    def spy(config, *a, **kw):
        measured.append(config.block_m)
        return 1e-3 * config.block_m
    monkeypatch.setattr(plan_mod, "_measure_candidate", spy)
    cfg = plan_mod.autotune(256, 128, 128, 4, device="cpu")
    rep = plan_mod.last_autotune_report()
    ranked = [c["block_m"] for c, _, _ in rep["candidates"]]
    # the 4 best-ranked of the 5 kept; the pruned 512 is never measured
    assert measured == ranked[:4] and 512 not in measured
    assert sorted(ranked) == [8, 16, 64, 128, 256]
    assert cfg.block_m == min(measured)
    assert rep["source"] == "measured"


def test_autotune_measurement_failure_is_skipped_not_fatal(cache, tiled,
                                                          monkeypatch):
    def flaky(config, *a, **kw):
        if config.block_m == 128:
            raise RuntimeError("synthetic launch failure")
        return 1e-3 * config.block_m
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
    assert rep["source"] == "cost_model" and len(rep["skipped"]) == 4
    assert cfg == KernelConfig.from_dict(rep["candidates"][0][0])


def test_measurement_needs_a_card_and_a_tiled_op():
    with pytest.raises(ValueError, match="CUDA device"):
        plan_mod._measure_candidate(KernelConfig(), 64, 128, 128, 2,
                                    op="gemm", device=torch.device("cpu"))
    assert plan_mod.op_ignores_tiles("gemm", torch.device("cpu"))
    assert not plan_mod.op_ignores_tiles("gemm", torch.device("cuda"))
    for op in ("quantize", "act_quant"):
        assert plan_mod.op_ignores_tiles(op, torch.device("cuda"))
    # the wgrads read their geometry on the card (not block_m), and are
    # measured there; on the CPU every op is tile-free
    for op in ("wgrad", "wgrad_fp8"):
        assert not plan_mod.op_ignores_tiles(op, torch.device("cuda"))
        assert plan_mod.op_ignores_tiles(op, torch.device("cpu"))


@pytest.mark.parametrize("op", ["wgrad", "wgrad_fp8"])
def test_autotune_measures_each_wgrad_geometry_once(cache, tiled,
                                                    monkeypatch, op):
    """The wgrads read no block_m: at a shape where every wgrad geometry
    of the pool is legal (qwen2-moe's shared experts, K 2048, N 5632) the
    sweep measures one candidate per distinct (block_n, n_span, k_span),
    and each other candidate shares its kernel's measurement."""
    measured = []

    def fake(config, *a, **kw):
        measured.append((config.block_n, config.n_span, config.k_span))
        assert kw["op"] == op
        return {(128, 1, 1): 3e-3, (256, 1, 1): 2e-3, (128, 2, 2): 1e-3,
                (128, 4, 4): 4e-3}[measured[-1]]
    monkeypatch.setattr(plan_mod, "_measure_candidate", fake)
    every = len(plan_mod.CONFIG_POOL)
    cfg = plan_mod.autotune(4096, 2048, 5632, 1, op=op, device="cpu",
                            max_candidates=every)
    rep = plan_mod.last_autotune_report()
    assert sorted(measured) == sorted(res.WGRAD_GEOMETRIES)
    assert (cfg.block_n, cfg.n_span, cfg.k_span) == (128, 2, 2)
    cands = rep["candidates"]
    assert len(cands) == every - len(rep["pruned"])
    assert all(t is not None for _, _, t in cands)
    # every candidate not measured itself names the one whose kernel
    # (and time) it shares: the same geometry, another block_m
    assert len(rep["shared"]) == len(cands) - len(measured)
    times = {tuple(c[k] for k in ("block_m", "block_n", "n_span", "k_span")):
             t for c, _, t in cands}
    for c, first in rep["shared"]:
        geom = [(d["block_n"], d["n_span"], d["k_span"]) for d in (c, first)]
        assert geom[0] == geom[1] and c["block_m"] != first["block_m"]
        assert times[(c["block_m"], *geom[0])] == \
            times[(first["block_m"], *geom[0])]
    # max_candidates counts kernels, not entries
    measured.clear()
    plan_mod.autotune(4096, 2048, 5632, 1, op=op, device="cpu",
                      max_candidates=2, refresh=True)
    assert len(measured) == 2 == len(set(measured))


def test_decode_on_a_tiny_batch_keeps_a_built_tile(cache):
    """At M=4 the 16-row tile is degenerate (it fetches four times the
    rows there are) and the 8-row tile is built: decode takes 8, and the
    16-row tile is pruned with its reason."""
    cfg = plan_mod.autotune(4, 256, 128, 8, op="decode", device="cpu")
    assert cfg.block_m == 8
    (pruned,) = plan_mod.last_autotune_report()["pruned"]
    assert pruned[0]["block_m"] == 16
    assert pruned[1].startswith("degenerate grid: block_m=16")


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
