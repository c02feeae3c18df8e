"""Findings, the rule table and the baseline of accepted findings.

Every checker layer (contracts, registry lint, AST lint, resource lint,
prepare-once contracts) reports :class:`Finding` records carrying a rule
ID, ``file:line``, a message and a fix hint.  The command line fails on
any finding whose :meth:`Finding.key` is not in the baseline passed with
``--baseline`` (a JSON ``{"findings": [key, ...]}``; none on a clean
tree): a rule can be tightened before every old violation is fixed,
without turning the checker off.

The rule IDs are the JAX package's.  Where the hardware differs the
rationale says what the port checks on Hopper: shared memory a CTA, TMA
rows and the 128-byte swizzle instead of VMEM sublanes and lanes, and
what the eager port prepares once instead of jit traces.

Stdlib-only: imported by the AST linter and the command line before
torch loads.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Iterable, List, Optional


@dataclasses.dataclass(frozen=True)
class Finding:
    rule_id: str
    path: str        # repo-relative where possible
    line: int        # 1-based; 1 when the rule is module/table-level
    message: str
    hint: str = ""

    def key(self) -> str:
        """Baseline identity: line numbers drift under unrelated edits, so
        the key is (rule, file, message), stable across reformatting."""
        return f"{self.rule_id}|{self.path}|{self.message}"

    def format(self) -> str:
        s = f"{self.rule_id} {self.path}:{self.line} {self.message}"
        if self.hint:
            s += f"\n    hint: {self.hint}"
        return s

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


# rule ID -> (title, rationale).  README.md's port section mirrors this
# table; ``--list-rules`` prints it.
RULES: "dict[str, tuple[str, str]]" = {
    # ---- layer 1: contracts over captured aten ops (REPRO-C*) ----------
    "REPRO-C01": (
        "standalone-quantize count",
        "each fp8 path performs an exact number of standalone "
        "quantize_tilewise calls (quantize-once: fwd=1 for x, fwd+bwd="
        "{x, dy, dg, du}; never g/u/h — the fused epilogues own those)"),
    "REPRO-C02": (
        "one TilePlan build per routing decision",
        "plan-once/run-many: one make_group_metadata schedule build "
        "serves every GEMM sharing one routing's group_sizes, forward "
        "and backward (the paper's configure-once descriptor pool); "
        "counted per executed call, as the port runs eagerly"),
    "REPRO-C03": (
        "padding op on the padding-free path",
        "no aten op may copy a rank>=2 float or e4m3-byte buffer into a "
        "larger one on the fp8 hot path (a growing constant_pad_nd, a "
        "slice_scatter, an index_copy_/index_put_ into more rows than "
        "the source) — eliminating that padding is the paper's core "
        "claim"),
    "REPRO-C04": (
        "wide intermediate on a fused path",
        "fused forwards must never materialize the activation "
        "intermediates (h, and for the producer-fused FFN g/u) wider "
        "than fp8 — the fused epilogue emits payload+scales directly"),
    "REPRO-C05": (
        "producer-GEMM routing",
        "a producer-fused path must dispatch its gate/up GEMMs through "
        "the quantizing grouped GEMM exactly as many times as it has "
        "producers"),
    "REPRO-C06": (
        "decode plan discipline",
        "an Engine resolves its decode config exactly once, the decode "
        "pool entry stays block_m<=16, and every forward of a generate "
        "builds plan metadata once per expert group, the decode "
        "forwards on the decode config's block_m"),
    # ---- layer 2: registry / alignment lint (REPRO-R*) ----------------
    "REPRO-R01": (
        "CUDA operator without a plain entry",
        "every operator with a 'cuda' entry (a hand-written kernel) "
        "needs its 'plain' PyTorch twin — the CPU proves the kernel's "
        "numerics through it"),
    "REPRO-R02": (
        "operator without an always-available entry",
        "every operator needs at least one entry whose availability "
        "probe passes on this host, so the CPU can run it"),
    "REPRO-R03": (
        "wgrad precision-twin gap",
        "the wgrad family's bf16/fp8 tables must expose the same backend "
        "names and the <name>_fp8 spellings must normalize onto the fp8 "
        "table"),
    "REPRO-R04": (
        "uses_plan/uses_tiles flag inconsistency",
        "a plan-walking backend necessarily honours tile shapes; the "
        "GEMM-family 'cuda' and 'plain' entries consume TilePlans; "
        "quantize/act_quant entries never do"),
    "REPRO-R05": (
        "tile pool misalignment",
        "every CONFIG_POOL/DECODE_POOL/_DEVICE_DEFAULTS entry follows "
        "the paper's alignment rules: block_m%8, block_n%128, "
        "block_k%128 (=> fp8 payload rows are 16-byte aligned), decode "
        "entries block_m<=16"),
    "REPRO-R06": (
        "scale-layout constant drift",
        "the 1x128 / 128x128 quantization granularity (QUANT_BLOCK=128) "
        "must agree across plan, ref, quantization and resources — a "
        "drifted copy silently mis-shapes every scale buffer"),
    "REPRO-R07": (
        "operator without contract facts",
        "every registered OpKey declares its contract facts "
        "(entry point, padding-free claim, standalone-quantize budget) "
        "via register_operator_contract, and the entry point exists"),
    # ---- layer 3: AST lint (REPRO-A*) ----------------------------------
    "REPRO-A01": (
        "direct kernel call outside kernels/",
        "the *_cuda launch wrappers and their *_plain twins are "
        "kernel-internal; all other code calls the public functions "
        "(gmm, act_quantize, ...), which pick by the tensor's device "
        "as the dispatch registry's resolve() does"),
    "REPRO-A02": (
        "bare assert in a kernel file",
        "python -O strips asserts; kernel-entry shape checks must raise "
        "ValueError with a shape message"),
    "REPRO-A03": (
        "hardcoded block-shape literal outside kernels/",
        "tile geometry lives in kernels/plan.py (pool + KernelConfig "
        "defaults) and kernel signatures only; literals elsewhere dodge "
        "the alignment validation and the autotuner"),
    # ---- layer 4: kernel-resource lint (REPRO-V*) ----------------------
    "REPRO-V01": (
        "shared memory over the CTA budget",
        "the shared memory one CTA of the kernel asks for (its rings, "
        "staging tiles and barriers) exceeds what a CTA may use "
        "(232448 B on the H100) — the launch cannot start"),
    "REPRO-V02": (
        "block_m not a whole MMA row group",
        "block_m must be a multiple of 8 (the row group of an MMA "
        "fragment; a wgmma pass is 64 = 8 x 8 rows)"),
    "REPRO-V03": (
        "box row off the 128-byte swizzle or a TMA row",
        "block_n must be a multiple of 128 (a 128-byte swizzled shared "
        "box row of e4m3), and a TMA tensor map's global rows must be "
        "16-byte aligned"),
    "REPRO-V04": (
        "block_k scale-granularity misalignment",
        "block_k must be a multiple of QUANT_BLOCK=128 so each K tile "
        "covers a whole number of 1x128 scale columns"),
    "REPRO-V05": (
        "degenerate grid at reference shape",
        "a tile wider than the operand it walks (block_n>N, block_k>K) "
        "gives the grid zero full steps, and block_m>=2*M wastes >=50% "
        "of every A fetch — the half-size tile does the same work"),
    "REPRO-V06": (
        "decode tile taller than a decode step",
        "decode-pool entries serve <=16 token-rows per step; a taller "
        "block_m fetches A rows no decode step can ever fill"),
    "REPRO-V07": (
        "launch does not fit one SM",
        "the kernel's CTAs an SM (its __launch_bounds__) do not fit one "
        "SM's shared memory (228 KB, 1 KB reserved a CTA) or registers "
        "(65536) — the launch would run fewer CTAs an SM than it was "
        "built for"),
    # ---- layer 5: prepare-once contracts (REPRO-T*) ---------------------
    "REPRO-T01": (
        "shape-stable call prepares again",
        "the port runs eagerly and compiles nothing at run time; what it "
        "prepares once (a kernel library's build or load, a PLAN_CACHE "
        "shape, an autotune measurement, a decode selection) must not "
        "recur: grouped_linear / grouped_linear_ffn fwd+bwd prepare "
        "nothing after the first call across routing changes of the "
        "same shape"),
    "REPRO-T02": (
        "engine generate prepares again",
        "a second same-shape Engine.generate prepares nothing (no "
        "selection, no plan-cache shape, no build or load) — the "
        "serving analogue of the paper's configure-once pool"),
    "REPRO-T03": (
        "padded baseline plans off-bucket",
        "the padded baseline builds one PLAN_CACHE shape per padded_m "
        "bucket; a bucket-stable call sequence that builds again "
        "reintroduces the per-call cost padding was supposed to "
        "amortize"),
}


def describe_rules() -> str:
    lines = []
    for rid, (title, rationale) in RULES.items():
        lines.append(f"{rid}  {title}\n    {rationale}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Baseline
# ---------------------------------------------------------------------------

def load_baseline(path: Optional[str]) -> "set[str]":
    if path is None or not os.path.exists(path):
        return set()
    with open(path) as f:
        data = json.load(f)
    return set(data.get("findings", []))


def filter_baselined(findings: Iterable[Finding],
                     baseline: "set[str]") -> "List[Finding]":
    return [f for f in findings if f.key() not in baseline]


def relpath(path: str, root: Optional[str] = None) -> str:
    """Repo-relative spelling when the path is under the repo root."""
    if root is None:
        root = repo_root()
    try:
        rel = os.path.relpath(os.path.abspath(path), root)
    except ValueError:          # different drive (windows)
        return path
    return path if rel.startswith("..") else rel


def repo_root() -> str:
    """The directory holding src/, derived from this file's location."""
    here = os.path.abspath(os.path.dirname(__file__))
    return os.path.dirname(os.path.dirname(os.path.dirname(here)))
