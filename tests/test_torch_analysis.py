"""The port's kernel contract checker (``repro_torch.analysis``): the rule
table, findings and baseline against the JAX package's, the command line,
the AST lint, the resource lint and the prepare-once layer.

Every known-bad fixture is written into ``tmp_path`` here and fires its
own rule and no other; the clean tree gives no finding.
"""
import json
import os
import textwrap

import pytest
import torch

from repro.analysis import findings as jfindings
from repro_torch.analysis import ast_lint, findings, resource_lint, retrace
from repro_torch.analysis.__main__ import main as analysis_main
from repro_torch.analysis.findings import Finding, RULES


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


def _write(path, text):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(text))
    return str(path)


# ---------------------------------------------------------------------------
# findings: the rule table and the baseline, against the JAX package's
# ---------------------------------------------------------------------------

def test_rule_ids_are_the_reference_ids():
    assert list(RULES) == list(jfindings.RULES)
    for rid, (title, rationale) in RULES.items():
        assert title and rationale, rid


def test_describe_rules_lists_every_rule():
    text = findings.describe_rules()
    assert [ln.split()[0] for ln in text.splitlines()
            if ln.startswith("REPRO-")] == list(jfindings.RULES)


RECORDS = [("REPRO-C03", "src/x.py", 3, "pad", "h"),
           ("REPRO-C03", "src/x.py", 9, "pad", ""),
           ("REPRO-A01", "src/y.py", 1, "call", "h"),
           ("REPRO-V01", "src/z.py", 2, "smem", "")]


def test_finding_key_and_baseline_behave_as_the_reference():
    ours = [Finding(*r) for r in RECORDS]
    theirs = [jfindings.Finding(*r) for r in RECORDS]
    assert [f.key() for f in ours] == [f.key() for f in theirs]
    # the key ignores the line: two records one key
    assert ours[0].key() == ours[1].key()
    assert [f.format() for f in ours] == [f.format() for f in theirs]
    assert [f.to_dict() for f in ours] == [f.to_dict() for f in theirs]
    baseline = {ours[0].key(), ours[3].key()}
    kept = findings.filter_baselined(ours, baseline)
    kept_ref = jfindings.filter_baselined(theirs, baseline)
    assert [f.key() for f in kept] == [f.key() for f in kept_ref] == \
        [ours[2].key()]


def test_load_baseline_and_relpath(tmp_path):
    path = tmp_path / "baseline.json"
    path.write_text(json.dumps({"findings": ["a|b|c"]}))
    assert findings.load_baseline(str(path)) == \
        jfindings.load_baseline(str(path)) == {"a|b|c"}
    assert findings.load_baseline(None) == set()
    assert findings.load_baseline(str(tmp_path / "missing.json")) == set()
    here = os.path.abspath(__file__)
    assert findings.relpath(here) == os.path.join("tests",
                                                  os.path.basename(here))
    assert findings.repo_root() == jfindings.repo_root()


# ---------------------------------------------------------------------------
# layer 3: AST lint
# ---------------------------------------------------------------------------

def test_ast_clean_tree_zero_findings():
    assert ast_lint.scan_paths() == []
    root = ast_lint.default_scan_root()
    assert root.endswith(os.path.join("src", "repro_torch"))


def test_internal_calls_are_the_launch_wrappers_and_their_twins():
    assert "gmm_cuda" in ast_lint.KERNEL_INTERNAL_CALLS
    assert "quantize_tilewise_plain" in ast_lint.KERNEL_INTERNAL_CALLS
    assert "flash_attention_cuda" in ast_lint.KERNEL_INTERNAL_CALLS
    assert len(ast_lint.KERNEL_INTERNAL_CALLS) == 16
    # the public device-picking functions stay allowed everywhere
    for public in ("gmm", "gmm_quant", "act_quantize", "quantize_tilewise"):
        assert public not in ast_lint.KERNEL_INTERNAL_CALLS


AST_FIXTURES = {
    "REPRO-A01": ("core/bad_direct_kernel_call.py", """
        from repro_torch.kernels import grouped_gemm_kernel as gk

        def f(a, sa, b, sb, gs):
            return gk.gmm_cuda(a, sa, b, sb, gs)
        """),
    "REPRO-A02": ("kernels/bad_bare_assert.py", """
        def check(x):
            assert x.dim() == 2
            return x
        """),
    "REPRO-A03": ("core/bad_block_literal.py", """
        from repro_torch.kernels.plan import KernelConfig

        CFG = KernelConfig(block_n=96)
        """),
    "REPRO-A00": ("core/bad_syntax.py", """
        def f(:
            pass
        """),
}


@pytest.mark.parametrize("rule", sorted(AST_FIXTURES))
def test_ast_fixture_fires_exactly_its_rule(tmp_path, rule):
    rel, src = AST_FIXTURES[rule]
    fs = ast_lint.scan_file(_write(tmp_path / rel, src))
    assert _rules(fs) == [rule]
    assert fs[0].path.endswith(os.path.basename(rel))
    if rule == "REPRO-A03":
        assert "block_n=96" in fs[0].message
        assert "not a multiple of 128" in fs[0].message


def test_kernel_internal_calls_allowed_inside_kernels():
    src = "def f(x):\n    return quantize_tilewise_cuda(x)\n"
    assert ast_lint.scan_source(src, "src/repro_torch/kernels/x.py") == []
    assert _rules(ast_lint.scan_source(
        src, "src/repro_torch/core/x.py")) == ["REPRO-A01"]


# ---------------------------------------------------------------------------
# layer 4: resource lint
# ---------------------------------------------------------------------------

def test_resource_lint_clean_pool_and_pruned_entries_counted():
    pruned = []
    assert resource_lint.run(pruned=pruned) == []
    assert len(pruned) == 118
    # "no CUDA variant" entries are pruned with their reason, never findings
    assert all(r.startswith("no CUDA variant") for _, r in pruned)
    assert any("block_m=8," in t for t, _ in pruned)
    assert not any("block_m=16,block_n=128,block_k=128" in t
                   and t.startswith("gemm/fp8") for t, _ in pruned)


def test_launch_bound_registers_match_ptxas():
    # the build's ptxas notes: B2 / B7 (384 threads, 1 CTA) 168, B6 (512) 128
    assert resource_lint.launch_bound_registers(384, 1) == 168
    assert resource_lint.launch_bound_registers(512, 1) == 128


GEMM = {"m": 8192, "k": 4096, "n": 4096}
RESOURCE_FIXTURES = {
    "REPRO-V01": {"family": "gemm", "config": {"block_m": 128},
                  "shape": GEMM, "smem_bytes": 100000},
    "REPRO-V02": {"family": "gemm", "config": {"block_m": 12},
                  "shape": GEMM},
    "REPRO-V03": {"family": "gemm", "config": {"block_m": 128,
                                               "block_n": 192},
                  "shape": GEMM},
    "REPRO-V04": {"family": "gemm", "config": {"block_m": 128,
                                               "block_k": 192},
                  "shape": GEMM},
    "REPRO-V05": {"family": "gemm", "config": {"block_m": 128},
                  "shape": {"m": 16, "k": 4096, "n": 4096}},
    "REPRO-V06": {"family": "gemm", "config": {"block_m": 128},
                  "shape": {"m": 256, "k": 4096, "n": 4096},
                  "decode": True},
    "REPRO-V07": {"family": "gemm", "config": {"block_m": 128},
                  "shape": GEMM, "registers": 255},
}


@pytest.mark.parametrize("rule", sorted(RESOURCE_FIXTURES))
def test_resource_fixture_fires_exactly_its_rule(tmp_path, rule):
    path = tmp_path / f"bad_{rule[-3:].lower()}.json"
    path.write_text(json.dumps(RESOURCE_FIXTURES[rule]))
    fs = resource_lint.run([str(path)])
    assert _rules(fs) == [rule]
    assert fs[0].path.endswith(path.name)
    # the same entry at a sound geometry / shape / budget passes
    good = {k: v for k, v in RESOURCE_FIXTURES[rule].items()
            if k not in ("smem_bytes", "registers", "decode")}
    good.update(config={"block_m": 128}, shape=GEMM)
    assert resource_lint.check_entry(good["family"], good["config"],
                                     good["shape"]) == []


def test_tma_row_alignment_is_v03():
    fs = resource_lint.check_entry("gemm", {"block_m": 128},
                                   {"m": 8192, "k": 4104, "n": 4096})
    assert _rules(fs) == ["REPRO-V03"]
    assert "16-byte" in fs[0].message


def test_missing_variant_is_pruned_not_a_finding():
    pruned = []
    fs = resource_lint.check_entry("gemm", {"block_m": 64}, GEMM,
                                   pruned=pruned)
    assert fs == [] and len(pruned) == 1
    assert pruned[0][1].startswith("no CUDA variant")


# ---------------------------------------------------------------------------
# layer 5: prepare-once fixtures
# ---------------------------------------------------------------------------

SHAPE_VARYING = """
    import torch

    from repro_torch.kernels import plan

    NAME = "shape_varying_plan_cache"
    EXPECTED_PREPARES = {"plan_cache_build": 1}


    def run():
        # WRONG by construction: a new static shape every call, so the
        # plan cache builds every time
        plan.PLAN_CACHE.clear()
        gs = torch.tensor([3, 5], dtype=torch.int32)
        for m in (64, 96, 128):
            plan.shared_plan(gs, m, block_m=16)
    """


def test_retrace_fixture_fires_exactly_t01(tmp_path):
    path = _write(tmp_path / "bad_retrace_loop.py", SHAPE_VARYING)
    fs = retrace.check_fixture(path)
    assert _rules(fs) == ["REPRO-T01"]
    assert "'plan_cache_build' occurred 3 time(s)" in fs[0].message
    # removing the expectation lets the fixture pass
    loose = _write(tmp_path / "loose.py", SHAPE_VARYING.replace(
        '{"plan_cache_build": 1}', "{}"))
    assert retrace.check_fixture(loose) == []


def test_compile_contract_rules_t02_t03(tmp_path):
    from repro_torch.kernels import plan
    cache = str(tmp_path / "tileplan_cache.json")

    def reselect(device):
        # WRONG by construction: a fresh decode selection every call
        return (lambda: plan.decode_config(8, 128, 128, 4, device=device,
                                           cache_path=cache),
                [(), (), ()])
    bad = retrace.CompileContract("reselect", build=reselect,
                                  expected={"decode_select": 0}, warmup=1,
                                  rule="REPRO-T02")
    fs = retrace.check_compile_contract(bad, "cpu")
    assert _rules(fs) == ["REPRO-T02"]
    assert retrace.check_compile_contract(
        retrace.CompileContract("reselect", build=reselect), "cpu") == []

    baseline = retrace.load_registered()["padding_baseline.bucket.retrace"]

    def off_bucket(device):
        fn, calls = baseline.build(device)
        # three buckets where the contract promises two
        return fn, [(*c[:3], b) for c, b in zip(calls, (640, 768, 896))]
    fs = retrace.check_compile_contract(
        retrace.CompileContract("off", build=off_bucket,
                                expected=baseline.expected,
                                rule=baseline.rule), "cpu")
    assert _rules(fs) == ["REPRO-T03"]


def test_prepare_events_are_tallied_by_name():
    from repro_torch.analysis import events as ev
    evs = [ev.Event("plan_build", {"shared": True}),
           ev.Event("plan_build", {}),
           ev.Event("kernel_load", {"name": "quant"}),
           ev.Event("decode_select", {}),
           ev.Event("quantize_tilewise", {"shape": (4, 128)})]
    assert dict(retrace.tally(evs)) == {"plan_cache_build": 1,
                                        "kernel_load": 1,
                                        "decode_select": 1}


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

def test_cli_list_rules_prints_exactly_the_reference_ids(capsys):
    assert analysis_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    assert [ln.split()[0] for ln in out.splitlines()
            if ln.startswith("REPRO-")] == list(jfindings.RULES)


def test_cli_clean_tree_exits_zero_on_the_cpu(capsys):
    assert analysis_main(["--all", "--device", "cpu", "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["findings"] == [] and out["suppressed"] == 0
    assert set(out["layers"]) == {"ast", "registry", "resources",
                                  "contracts", "retrace"}
    assert all(n == 0 for n in out["layers"].values())
    assert out["resources_pruned"] > 0


def test_cli_fixture_fails_and_baseline_suppresses(tmp_path, capsys):
    rel, src = AST_FIXTURES["REPRO-A03"]
    bad = _write(tmp_path / rel, src)
    assert analysis_main(["--ast", "--paths", bad]) == 1
    out = capsys.readouterr().out
    assert "REPRO-A03" in out and "1 finding(s)" in out
    key = ast_lint.scan_file(bad)[0].key()
    baseline = tmp_path / "baseline.json"
    baseline.write_text(json.dumps({"findings": [key]}))
    assert analysis_main(["--ast", "--paths", bad,
                          "--baseline", str(baseline)]) == 0
    assert "(1 baselined)" in capsys.readouterr().out


def test_cli_no_run_contracts_skips_the_executing_layers(capsys):
    assert analysis_main(["--contracts", "--retrace", "--no-run-contracts",
                          "--device", "cpu", "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["layers"] == {"contracts": 0}
