"""The port's contracts (``repro_torch.analysis`` layers 1 and 5) against
the JAX package's.

For each of the ten contracts that the JAX package checks by tracing, the
port runs the same path on the same numpy operands (the MoE contracts on
the JAX package's params, through ``convert.tree_from_numpy``) and must
count the same events: kinds, counts and the ``quantize_tilewise`` shape
multiset.  The JAX side runs in jaxpr mode only (it traces, it executes no
kernel).  Its executing engine contract is run by ``tests/test_analysis.py``
already; the port's engine contract is held to its own per-call count.
Each layer-1 rule fires, and only it, on a path made wrong by
construction, and passes once its expectation is removed.
"""
import types
from collections import Counter

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.analysis import contracts as jcontracts
from repro.analysis import events as jevents
from repro.analysis import retrace as jretrace
from repro_torch.analysis import contracts, events, retrace
from repro_torch.analysis.contracts import Contract, check_contract
from repro_torch.convert import tree_from_numpy
from repro_torch.core import grouped_gemm as gg
from repro_torch.core import quantization as q
from repro_torch.kernels import plan as plan_mod
from repro_torch.kernels.plan import KernelConfig
from repro_torch.serve import engine as tengine

# the layer-1 expectation fields, checked equal between the packages
FIELDS = ("quantize_count", "quantize_shapes", "plan_builds",
          "forbid_padding", "forbid_wide_shapes", "gemm_quant_calls",
          "decode_selects")
ENGINE = "engine.generate.decode_plan"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's ops while this file runs: beside
    the other test workers PyTorch's thread pool oversubscribes the cores.
    Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rules(fs):
    return [f.rule_id for f in fs]


def _summary(evs):
    """Event kinds and counts (the port's own ``kernel`` events aside) and
    the standalone quantizations' shape multiset."""
    kinds = Counter(e.kind for e in evs if e.kind != "kernel")
    shapes = sorted(tuple(e.data["shape"]) for e in evs
                    if e.kind == "quantize_tilewise")
    return kinds, shapes


# ---------------------------------------------------------------------------
# the registries: a counterpart for every contract of the JAX package
# ---------------------------------------------------------------------------

def test_every_reference_contract_has_a_counterpart():
    ours, theirs = contracts.load_registered(), jcontracts.load_registered()
    assert sorted(ours) == sorted(theirs)
    for name, c in theirs.items():
        mine = ours[name]
        assert mine.mode == {"jaxpr": "ops", "run": "run"}[c.mode], name
        assert mine.build is not None and mine.path.startswith(
            "src/repro_torch/"), name
        for field in FIELDS:
            if name == ENGINE and field == "plan_builds":
                continue      # counted per executed call, below
            want, got = getattr(c, field), getattr(mine, field)
            if field in ("quantize_shapes", "forbid_wide_shapes") \
                    and want is not None:
                want = tuple(tuple(s) for s in want)
            assert got == want, (name, field)


def test_every_reference_compile_contract_has_a_counterpart():
    ours, theirs = retrace.load_registered(), jretrace.load_registered()
    assert sorted(ours) == sorted(theirs)
    for name, c in theirs.items():
        assert ours[name].rule == c.rule, name
    # T03 counts what the reference counts: one build per bucket
    assert ours["padding_baseline.bucket.retrace"].expected == \
        {"plan_cache_build": 2}
    assert sum(theirs["padding_baseline.bucket.retrace"].expected
               .values()) == 2


def test_engine_contract_counts_per_executed_call():
    c = contracts.load_registered()[ENGINE]
    # 2 expert groups (routed, shared) x 2 MoE layers x 6 forwards
    assert c.plan_builds == 2 * 2 * 6
    assert jcontracts.load_registered()[ENGINE].plan_builds == 4
    scaled = tengine.decode_plan_contract(moe_layers=24, batch=4, new=16)
    assert (scaled.name, scaled.decode_selects, scaled.plan_builds) == \
        (ENGINE, 1, 2 * 24 * 16)
    assert scaled.build is None and scaled.mode == "run"


# ---------------------------------------------------------------------------
# the ten traced contracts against the JAX package's, on the same operands
# ---------------------------------------------------------------------------

def _reference(name):
    c = jcontracts.load_registered()[name]
    fn, args = c.build()
    with jevents.capture() as evs:
        fs = jcontracts.check_contract(fn, c, *args)
    return fs, evs, args


def _port(name, ref_args):
    c = contracts.load_registered()[name]
    fn, args = c.build(torch.device("cpu"))
    if name.startswith("moe_apply"):
        # the JAX package's params and tokens, not the port's draws
        params, xt = jax.tree.map(np.asarray, ref_args)
        args = (tree_from_numpy(params), torch.from_numpy(np.array(xt)))
    else:
        # the same numpy draws, built on each side
        for mine, theirs in zip(args, ref_args):
            np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
    with events.capture() as evs:
        fs = check_contract(fn, c, *args)
    return fs, evs


TRACED = sorted(n for n, c in jcontracts.load_registered().items()
                if c.mode == "jaxpr")


def test_ten_traced_contracts():
    assert len(TRACED) == 10


@pytest.mark.parametrize("name", TRACED)
def test_contract_events_equal_the_reference(name):
    ref_fs, ref_evs, ref_args = _reference(name)
    fs, evs = _port(name, ref_args)
    assert ref_fs == [] and fs == [], [f.format() for f in fs]
    assert _summary(evs) == _summary(ref_evs)
    # every kernel the path reaches ran opaque
    assert any(e.kind == "kernel" for e in evs)


# ---------------------------------------------------------------------------
# each layer-1 rule fires, and only it; removing the expectation passes
# ---------------------------------------------------------------------------

X = torch.from_numpy(np.random.default_rng(2).standard_normal(
    (64, 128)).astype(np.float32))
GS = torch.tensor([20, 0, 30], dtype=torch.int32)
W = torch.from_numpy(np.random.default_rng(3).standard_normal(
    (3, 128, 128)).astype(np.float32))


def _double_quantize(x):
    # WRONG by construction: quantizes the same buffer twice
    return q.quantize_activation(x), q.quantize_activation(x)


def _two_plans(x):
    # WRONG by construction: two plans for one routing decision
    for _ in range(2):
        plan_mod.make_tile_plan(GS, x.shape[0], block_m=128)


def _padded_linear(x):
    return gg.grouped_linear(x, W, GS, precision="fp8",
                             config=KernelConfig(backend="padded_baseline"))


def _wide_h(x):
    # WRONG by construction: h = silu(g) * u materialized in f32
    g = gg.grouped_linear(x, W, GS, precision="fp8")
    h = F.silu(g) * g
    return gg.grouped_linear(h, W, GS, precision="fp8")


def _one_producer(x):
    # the unary FFN has one producer GEMM, not two
    wu = W[:, :, :128]
    return gg.grouped_linear_ffn(x, None, wu, W, GS, act="gelu")


def _two_selections(x):
    # WRONG by construction: selects decode tiles twice
    for _ in range(2):
        plan_mod.decode_config(8, 128, 128, 3, device="cpu")


FIXTURES = {
    "REPRO-C01": (_double_quantize, dict(quantize_count=1)),
    "REPRO-C02": (_two_plans, dict(plan_builds=1)),
    "REPRO-C03": (_padded_linear, dict(forbid_padding=True)),
    "REPRO-C04": (_wide_h, dict(forbid_wide_shapes=((64, 128),))),
    "REPRO-C05": (_one_producer, dict(gemm_quant_calls=2)),
    "REPRO-C06": (_two_selections, dict(decode_selects=1)),
}


@pytest.mark.parametrize("rule", sorted(FIXTURES))
def test_rule_fires_alone_and_its_removal_passes(tmp_path, monkeypatch,
                                                 rule):
    # the decode selection's cache goes to a throwaway file
    monkeypatch.setenv(plan_mod.CACHE_ENV,
                       str(tmp_path / "tileplan_cache.json"))
    fn, expect = FIXTURES[rule]
    c = Contract(name=f"fixture.{rule}", **expect)
    fs = check_contract(fn, c, X)
    assert fs and set(_rules(fs)) == {rule}, [f.format() for f in fs]
    # the coverage property: without the expectation the path passes
    assert check_contract(fn, Contract(name="loose"), X) == []


def test_extra_checker_reports_under_c06():
    c = Contract(name="extra", mode="run",
                 extra=lambda result, evs: [f"got {result}"])
    fs = check_contract(lambda: 3, c)
    assert _rules(fs) == ["REPRO-C06"] and "got 3" in fs[0].message


def test_padded_baseline_fires_c03_under_the_registered_contract():
    c = contracts.load_registered()["grouped_linear.fp8.fwd"]
    fn, args = gg._build_linear_fwd(
        torch.device("cpu"), KernelConfig(backend="padded_baseline"))
    fs = [f for f in check_contract(fn, c, *args)
          if f.rule_id == "REPRO-C03"]
    # the e4m3 payload (as its bytes) and its scales, copied into the
    # padded buffers
    assert len(fs) == 2
    assert any("'index_copy_' materializes uint8[641, 128]" in f.message
               for f in fs)


def test_zero_width_and_backward_pads_are_not_padding():
    c = Contract(name="pads", forbid_padding=True)
    x = torch.randn(4, 8)
    assert check_contract(lambda x: F.pad(x, (0, 0, 0, 0)), c, x) == []
    # a growing pad fires; its backward (a negative-width pad) does not
    fs = check_contract(lambda x: torch.autograd.grad(
        F.pad(x, (0, 0, 0, 4)).sum(), x),
        c, x.clone().requires_grad_())
    assert [f.message.split("] ", 1)[1] for f in fs] == [
        "padding op 'constant_pad_nd' materializes float32[8, 8] from "
        "[4, 8] on the padding-free path"]


def test_kernels_are_opaque_and_restored():
    from repro_torch.kernels import epilogue_kernel as ek
    real = ek.act_quantize
    g = torch.randn(256, 256)
    with contracts.opaque_kernels():
        assert ek.act_quantize is not real
        _, ops = contracts.record_ops(lambda: q.fused_act_quantize(g, g))
    assert ek.act_quantize is real
    # the plain act_quantize materializes h in f32, unrecorded
    assert not any(shape == (256, 256) for rec in ops
                   for shape, _ in rec.outs)


# ---------------------------------------------------------------------------
# the executing contracts on the CPU
# ---------------------------------------------------------------------------

def test_engine_contract_runs_clean_on_the_cpu():
    c = contracts.load_registered()[ENGINE]
    with events.capture() as evs:
        assert contracts.run_contract(c, "cpu") == []
    builds = [e.data["block_m"] for e in evs if e.kind == "plan_build"]
    assert builds == [128] * 4 + [16] * 20


def test_engine_extra_catches_a_decode_build_off_the_decode_tile():
    engine = types.SimpleNamespace(decode_config=KernelConfig(block_m=16))
    res = types.SimpleNamespace(tokens=torch.zeros(2, 6))

    def builds(*block_ms):
        return [events.Event("plan_build", {"block_m": b}) for b in block_ms]
    check = contracts.load_registered()[ENGINE].extra
    assert check((engine, res), builds(*[128] * 4, *[16] * 20)) == []
    msgs = check((engine, res), builds(*[128] * 5, *[16] * 19))
    assert len(msgs) == 1 and "1 decode-phase plan build(s) used block_m " \
        "[128]" in msgs[0]


@pytest.mark.parametrize("name", sorted(retrace.load_registered()))
def test_compile_contracts_pass_on_the_cpu(name):
    c = retrace.load_registered()[name]
    assert retrace.check_compile_contract(c, "cpu") == []
