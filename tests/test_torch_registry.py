"""The port's operator registry (``repro_torch.kernels.dispatch``) and its
lint (``repro_torch.analysis.registry_lint``, REPRO-R01..R07).

The registry holds the JAX package's operators with the port's own
entries (``cuda``, ``plain``, ``padded_baseline``); ``resolve`` never
falls back from ``cuda`` to ``plain``, and every kernel module's public
function picks the entry ``resolve`` names for its tensor's device.  The
R05 and R06 findings on the pools equal the JAX package's, the pools being
its entry for entry; every R rule fires, and only it, on a table made
wrong by construction.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.analysis import registry_lint as jregistry_lint
from repro.kernels import dispatch as jdispatch
from repro.kernels import plan as jplan
from repro_torch.analysis import registry_lint
from repro_torch.kernels import dispatch, plan
from repro_torch.kernels import ref as kref
from repro_torch.kernels.plan import KernelConfig

KEYS = [(k.family, k.precision) for k in dispatch.op_keys()]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's ops while this file runs: beside
    the other test workers PyTorch's thread pool oversubscribes the cores.
    Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def no_card(monkeypatch):
    """A host without CUDA, whatever this one has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _rules(fs):
    return [f.rule_id for f in fs]


# ---------------------------------------------------------------------------
# the table
# ---------------------------------------------------------------------------

def test_op_keys_are_the_reference_keys():
    assert sorted(KEYS) == sorted((k.family, k.precision)
                                  for k in jdispatch.op_keys())
    assert dispatch.FAMILIES == jdispatch.FAMILIES
    assert dispatch.PRECISIONS == jdispatch.PRECISIONS
    assert sorted(dispatch.backend_matrix("all")) == \
        sorted(jdispatch.backend_matrix("all"))


def test_entries_are_the_kernels_and_their_plain_versions():
    for key in KEYS:
        table = dispatch._OPERATORS[dispatch.OpKey(*key)]
        assert table["cuda"].run.__name__.endswith("_cuda"), key
        assert table["plain"].run.__name__ == \
            table["cuda"].run.__name__[:-len("_cuda")] + "_plain", key
        expect = {"cuda", "plain"} | ({"padded_baseline"} if key in (
            ("gemm", "fp8"), ("gemm_quant", "fp8")) else set())
        assert set(table) == expect, key
    assert dispatch.registry_names() == ("cuda", "plain", "padded_baseline")


def test_registry_lint_clean_tree_zero_findings():
    assert registry_lint.run() == []


# ---------------------------------------------------------------------------
# resolve: by device, no fallback
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key", KEYS, ids=lambda k: "/".join(k))
def test_resolve_never_falls_back(no_card, key):
    assert dispatch.resolve(key, device="cpu") == "plain"
    assert dispatch.resolve(key, "plain") == "plain"
    for backend in (None, "auto", "cuda"):
        with pytest.raises(dispatch.BackendUnavailableError,
                           match="no CUDA device"):
            dispatch.resolve(key, backend, device="cuda")
    with pytest.raises(dispatch.BackendUnavailableError):
        dispatch.resolve(key)           # the card is the default device
    with pytest.raises(ValueError, match="unknown backend 'pallas'"):
        dispatch.resolve(key, "pallas")


def test_resolve_gemm_only_names_and_fp8_spellings(no_card):
    assert dispatch.resolve(("gemm", "fp8"), "padded_baseline") == \
        "padded_baseline"
    # a gemm-only name does not auto-resolve in another family
    with pytest.raises(ValueError):
        dispatch.resolve(("wgrad", "fp8"), "padded_baseline")
    assert dispatch.resolve(("wgrad", "fp8"), "plain_fp8") == "plain"
    with pytest.raises(dispatch.BackendUnavailableError):
        dispatch.resolve(("wgrad", "fp8"), "cuda_fp8")


class _FakeCuda(torch.Tensor):
    """A CPU tensor that says it lies on a card: enough for a public
    function to pick its CUDA route (the route itself is replaced)."""

    @property
    def is_cuda(self):
        return True


def _public_args(key):
    """Valid operands of each public function, as CPU tensors."""
    f32 = torch.zeros(4, 128)
    if key == ("quantize", "fp8"):
        return (f32,), {}
    if key == ("act_quant", "fp8"):
        return (f32, f32), {}
    gs = torch.tensor([4], dtype=torch.int32)
    if key in (("gemm", "bf16"), ("wgrad", "bf16")):
        return (f32, f32, gs), {}
    return (f32, f32, f32, f32, gs), {}


@pytest.mark.parametrize("key", KEYS, ids=lambda k: "/".join(k))
def test_public_function_picks_what_resolve_names(monkeypatch, key):
    """Every kernel module's public function takes the route ``resolve``
    names for its tensor's device: ``plain`` on the CPU, ``cuda`` on a
    card (``device_backend``)."""
    table = dispatch._OPERATORS[dispatch.OpKey(*key)]
    mod = __import__(table["cuda"].run.__module__, fromlist=["_"])
    public = getattr(mod, table["cuda"].run.__name__[:-len("_cuda")])
    called = []
    for route in ("cuda", "plain"):
        name = table[route].run.__name__
        monkeypatch.setattr(mod, name,
                            lambda *a, _r=route, **kw: called.append(_r))
    args, kw = _public_args(key)
    public(*args, **kw)
    public(*(a.as_subclass(_FakeCuda) if i == 0 else a
             for i, a in enumerate(args)), **kw)
    assert called == [dispatch.resolve(key, device="cpu"),
                      dispatch.device_backend("cuda")]


def test_padded_entries_compute_the_baseline():
    from repro_torch.core import padding_baseline as pb
    rng = np.random.default_rng(0)
    a8, sa = kref.quantize_tilewise_ref(torch.from_numpy(
        rng.standard_normal((96, 128)).astype(np.float32)))
    b8, sb = kref.quantize_blockwise_ref(torch.from_numpy(
        rng.standard_normal((3, 128, 256)).astype(np.float32)))
    gs = torch.tensor([30, 0, 50], dtype=torch.int32)
    gemm = dispatch._OPERATORS[dispatch.OpKey("gemm", "fp8")]
    want = pb.grouped_gemm_fp8_padded(a8, sa, b8, sb, gs)
    assert torch.equal(gemm["padded_baseline"].run(a8, sa, b8, sb, gs), want)
    quant = dispatch._OPERATORS[dispatch.OpKey("gemm_quant", "fp8")]
    q8, s = quant["padded_baseline"].run(a8, sa, b8, sb, gs)
    q_want, s_want = kref.quantize_tilewise_ref(want.float())
    assert torch.equal(q8.view(torch.uint8), q_want.view(torch.uint8))
    assert torch.equal(s, s_want)


# ---------------------------------------------------------------------------
# check_backend reads the registry's names and accepts what it did
# ---------------------------------------------------------------------------

def test_check_backend_accepts_none_and_the_baseline_only():
    plan.check_backend(None)
    plan.check_backend("padded_baseline")
    for name in ("cuda", "plain", "cuda_fp8", "nonsense"):
        with pytest.raises(ValueError, match="kernels/dispatch.py has"):
            plan.check_backend(name)
    for name in ("pallas", "pallas_interpret", "xla_ragged", "xla_exact",
                 "xla", "ref", "pallas_fp8"):
        with pytest.raises(NotImplementedError,
                           match=r"\('cuda', 'plain', 'padded_baseline'\)"):
            plan.check_backend(name)


# ---------------------------------------------------------------------------
# the lint: each R rule alone on a table made wrong by construction
# ---------------------------------------------------------------------------

def _with_table(monkeypatch, key, edit):
    """Replace one operator's table by ``edit(copy of it)``."""
    tables = {k: dict(v) for k, v in dispatch._OPERATORS.items()}
    op = dispatch.OpKey(*key)
    tables[op] = edit(tables[op])
    monkeypatch.setattr(dispatch, "_OPERATORS", tables)


def _available(spec, ok=True):
    return dataclasses.replace(spec, available=lambda: (ok, "" if ok
                                                        else "test"))


def _drop_plain(t):
    # WRONG: a kernel without its plain twin (the kernel available)
    return {"cuda": _available(t["cuda"])}


def _none_available(t):
    # WRONG: no entry can run here
    return {n: _available(s, False) for n, s in t.items()}


def _extra_wgrad_name(t):
    # WRONG: a bf16-only wgrad backend
    return {**t, "extra": t["plain"]}


def _plan_without_tiles(t):
    # WRONG: walks a plan, ignores tiles
    return {**t, "plain": dataclasses.replace(t["plain"], uses_tiles=False)}


R_TABLE_FIXTURES = {
    "REPRO-R01": (("gemm", "fp8"), _drop_plain),
    "REPRO-R02": (("gemm", "bf16"), _none_available),
    "REPRO-R03": (("wgrad", "bf16"), _extra_wgrad_name),
    "REPRO-R04": (("gemm_quant", "fp8"), _plan_without_tiles),
}


@pytest.mark.parametrize("rule", sorted(R_TABLE_FIXTURES))
def test_table_rule_fires_alone(monkeypatch, rule):
    key, edit = R_TABLE_FIXTURES[rule]
    _with_table(monkeypatch, key, edit)
    fs = registry_lint.run()
    assert fs and set(_rules(fs)) == {rule}, [f.format() for f in fs]


def test_r04_element_wise_entries_never_plan(monkeypatch):
    _with_table(monkeypatch, ("quantize", "fp8"), lambda t: {
        **t, "plain": dataclasses.replace(t["plain"], uses_plan=True,
                                          uses_tiles=True)})
    assert _rules(registry_lint.run()) == ["REPRO-R04"]


def test_r07_contract_facts(monkeypatch):
    facts = dispatch.op_contract_facts()
    key = dispatch.OpKey("gemm", "fp8")
    missing = {k: v for k, v in facts.items() if k != key}
    monkeypatch.setattr(dispatch, "_OP_CONTRACT_FACTS", missing)
    assert _rules(registry_lint.run()) == ["REPRO-R07"]
    wrong = {**facts, key: {**facts[key], "entry_point": "grouped_gemm_"
                            "kernel.no_such_gemm"}}
    monkeypatch.setattr(dispatch, "_OP_CONTRACT_FACTS", wrong)
    fs = registry_lint.run()
    assert _rules(fs) == ["REPRO-R07"] and "no_such_gemm" in fs[0].message
    assert all(dispatch.entry_point_exists(f["entry_point"])
               for f in facts.values())


def _pool_findings(lint, rules=("REPRO-R05", "REPRO-R06")):
    return [f.message for f in lint.run() if f.rule_id in rules]


def test_pool_findings_equal_the_reference(monkeypatch):
    assert _pool_findings(registry_lint) == \
        _pool_findings(jregistry_lint) == []
    # a 32-row decode entry in both packages' pools: the same R05 finding
    monkeypatch.setattr(plan, "DECODE_POOL",
                        plan.DECODE_POOL + (KernelConfig(block_m=32),))
    monkeypatch.setattr(jplan, "DECODE_POOL",
                        jplan.DECODE_POOL + (jplan.KernelConfig(block_m=32),))
    ours = _pool_findings(registry_lint)
    assert ours == _pool_findings(jregistry_lint)
    assert len(ours) == 1 and "DECODE_POOL[2]: block_m=32 > 16" in ours[0]
    assert _rules(registry_lint.run()) == ["REPRO-R05"]


def test_quant_block_drift_equals_the_reference(monkeypatch):
    from repro.kernels import ref as jref
    monkeypatch.setattr(kref, "QUANT_BLOCK", 64)
    monkeypatch.setattr(jref, "QUANT_BLOCK", 64)
    ours = _pool_findings(registry_lint)
    assert ours == _pool_findings(jregistry_lint)
    assert len(ours) == 1 and "'kernels.ref': 64" in ours[0]
    assert _rules(registry_lint.run()) == ["REPRO-R06"]
