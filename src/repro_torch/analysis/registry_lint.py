"""Layer 2: static validation of the operator registry and the tile pools.

Walks ``kernels.dispatch._OPERATORS`` (the one table every (family,
precision) operator lives in) and ``kernels.plan``'s pool and default
constants against the paper's structural rules: no kernel runs.  Rules
REPRO-R01..R07; see ``findings.RULES``.
"""
from __future__ import annotations

from typing import List

from repro_torch.analysis.findings import Finding, relpath

# GEMM-shaped families whose kernels walk TilePlans; the element-wise
# families never do
PLAN_FAMILIES = ("gemm", "gemm_quant", "wgrad")
ELEMENTWISE_FAMILIES = ("quantize", "act_quant")

# fp8 payload is 1 byte/element: a block_k-wide payload row is 16-byte
# aligned (a TMA tensor map's row stride) iff block_k % 16 == 0;
# 128-multiples imply it, but the lint states the load-bearing bound
# separately so a future relaxation of the 128s cannot silently drop it
FP8_STRIDE_ALIGN = 16


def _loc(mod) -> str:
    return relpath(getattr(mod, "__file__", mod.__name__) or mod.__name__)


def run() -> "List[Finding]":
    from repro_torch.kernels import dispatch, plan

    findings: "List[Finding]" = []
    dloc = _loc(dispatch)
    ploc = _loc(plan)

    # ---- R01/R02/R04: per-operator table shape -------------------------
    for key in dispatch.op_keys():
        table = dispatch._OPERATORS[key]
        names = set(table)
        if dispatch.CUDA in names and dispatch.PLAIN not in names:
            findings.append(Finding(
                "REPRO-R01", dloc, 1,
                f"({key.family}, {key.precision}) has a 'cuda' entry but "
                f"no 'plain' twin",
                "register the kernel's PyTorch version so the CPU can "
                "prove its numerics"))
        if not any(spec.available()[0] for spec in table.values()):
            findings.append(Finding(
                "REPRO-R02", dloc, 1,
                f"({key.family}, {key.precision}) has no available "
                f"backend on this host (entries: {sorted(names)})",
                "register at least one entry with an always-true "
                "availability probe (the plain version)"))
        for spec in table.values():
            if spec.uses_plan and not spec.uses_tiles:
                findings.append(Finding(
                    "REPRO-R04", dloc, 1,
                    f"({key.family}, {key.precision}) '{spec.name}': "
                    f"uses_plan=True but uses_tiles=False — a "
                    f"plan-walking backend necessarily honours tile "
                    f"shapes",
                    "set uses_tiles=True (the TilePlan schedule is built "
                    "from block_m)"))
            if key.family in PLAN_FAMILIES \
                    and spec.name in (dispatch.CUDA, dispatch.PLAIN) \
                    and not spec.uses_plan:
                findings.append(Finding(
                    "REPRO-R04", dloc, 1,
                    f"({key.family}, {key.precision}) '{spec.name}': "
                    f"GEMM-family kernel entries must consume TilePlans "
                    f"(uses_plan=True)",
                    "plan-once/run-many is the point — wire the plan "
                    "kwarg through to the kernel"))
            if key.family in ELEMENTWISE_FAMILIES and spec.uses_plan:
                findings.append(Finding(
                    "REPRO-R04", dloc, 1,
                    f"({key.family}, {key.precision}) '{spec.name}': "
                    f"element-wise operators have no visitation schedule "
                    f"to plan (uses_plan must be False)",
                    "drop uses_plan; tile height still rides uses_tiles"))

    # ---- R03: wgrad precision twins ------------------------------------
    wg_bf16 = dispatch._OPERATORS.get(dispatch.OpKey("wgrad", "bf16"), {})
    wg_fp8 = dispatch._OPERATORS.get(dispatch.OpKey("wgrad", "fp8"), {})
    for missing in sorted(set(wg_bf16) ^ set(wg_fp8)):
        side = "fp8" if missing in wg_bf16 else "bf16"
        findings.append(Finding(
            "REPRO-R03", dloc, 1,
            f"wgrad backend '{missing}' has no {side} precision twin",
            "register the same backend name in both (wgrad, bf16) and "
            "(wgrad, fp8) so wgrad_precision can flip per KernelConfig"))
    for name in sorted(wg_fp8):
        spelled = dispatch._canonical(dispatch.OpKey("wgrad", "fp8"),
                                      name + "_fp8")
        if spelled != name:
            findings.append(Finding(
                "REPRO-R03", dloc, 1,
                f"the spelling '{name}_fp8' does not normalize onto the "
                f"(wgrad, fp8) entry '{name}'",
                "keep _canonical()'s _fp8-suffix stripping in sync with "
                "the registered names"))

    # ---- R05: pool / default alignment ---------------------------------
    # the messages are the JAX package's, word for word: the port's pools
    # are its pools, entry for entry
    def check_cfg(cfg, where, spans_allowed=True):
        out = []
        ns = getattr(cfg, "n_span", 1)
        ks = getattr(cfg, "k_span", 1)
        for axis, v in (("n_span", ns), ("k_span", ks)):
            if not isinstance(v, int) or isinstance(v, bool) or v < 1:
                out.append((f"{where}: {axis}={v!r} is not an int >= 1",
                            "spans are whole super-tile multiples of the "
                            "base tile"))
        if not spans_allowed and (ns != 1 or ks != 1):
            out.append((f"{where}: spans ns{ns}xks{ks} on a non-wgrad "
                        f"pool entry — only the wgrad family's multi-tile "
                        f"schedule consumes them",
                        "keep n_span=k_span=1 outside CONFIG_POOL's wgrad "
                        "span entries"))
        if cfg.block_m % 8:
            out.append((f"{where}: block_m={cfg.block_m} not a multiple "
                        f"of 8 (sublane)", "align block_m to 8"))
        if cfg.block_n % 128:
            out.append((f"{where}: block_n={cfg.block_n} not a multiple "
                        f"of 128 (lane width / 128x128 weight blocks)",
                        "align block_n to 128"))
        if cfg.block_k % plan.QUANT_BLOCK:
            out.append((f"{where}: block_k={cfg.block_k} not a multiple "
                        f"of QUANT_BLOCK={plan.QUANT_BLOCK}",
                        "align block_k to the 1x128 scale granularity"))
        if cfg.block_k % FP8_STRIDE_ALIGN or cfg.block_n % FP8_STRIDE_ALIGN:
            out.append((f"{where}: fp8 payload stride "
                        f"({cfg.block_k}x{cfg.block_n}) not "
                        f"{FP8_STRIDE_ALIGN}-byte aligned",
                        "fp8 is 1 byte/element; keep both tile dims "
                        f"multiples of {FP8_STRIDE_ALIGN}"))
        return out

    for i, cfg in enumerate(plan.CONFIG_POOL):
        for msg, hint in check_cfg(cfg, f"CONFIG_POOL[{i}]"):
            findings.append(Finding("REPRO-R05", ploc, 1, msg, hint))
    for i, cfg in enumerate(plan.DECODE_POOL):
        for msg, hint in check_cfg(cfg, f"DECODE_POOL[{i}]",
                                   spans_allowed=False):
            findings.append(Finding("REPRO-R05", ploc, 1, msg, hint))
        if cfg.block_m > 16:
            findings.append(Finding(
                "REPRO-R05", ploc, 1,
                f"DECODE_POOL[{i}]: block_m={cfg.block_m} > 16 — decode "
                f"M is batch*top_k rows total; a tall tile wastes the "
                f"fetch",
                "keep decode entries at block_m<=16 (DECODE_BLOCK_MS)"))
    for prefix, kw in plan._DEVICE_DEFAULTS:
        try:
            cfg = plan.KernelConfig(**kw)
        except (TypeError, ValueError) as e:
            findings.append(Finding(
                "REPRO-R05", ploc, 1,
                f"_DEVICE_DEFAULTS[{prefix!r}] does not construct: {e}",
                "device defaults must be valid KernelConfig kwargs"))
            continue
        for msg, hint in check_cfg(cfg, f"_DEVICE_DEFAULTS[{prefix!r}]",
                                   spans_allowed=False):
            findings.append(Finding("REPRO-R05", ploc, 1, msg, hint))

    # ---- R06: scale-layout constant agreement --------------------------
    from repro_torch.core import quantization as qz
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import resources as kres
    blocks = {"kernels.plan": plan.QUANT_BLOCK,
              "kernels.ref": kref.QUANT_BLOCK,
              "core.quantization": qz.QUANT_BLOCK,
              "kernels.resources": kres.QUANT_BLOCK}
    if len(set(blocks.values())) != 1 or plan.QUANT_BLOCK != 128:
        findings.append(Finding(
            "REPRO-R06", ploc, 1,
            f"QUANT_BLOCK drift: {blocks} (paper's granularity is 128)",
            "all modules must read one constant; scales are 1x128 "
            "(activations) / 128x128 (weights)"))

    # ---- R07: contract facts cover the registry ------------------------
    facts = dispatch.op_contract_facts()
    for key in dispatch.op_keys():
        f = facts.get(key)
        if f is None:
            findings.append(Finding(
                "REPRO-R07", dloc, 1,
                f"({key.family}, {key.precision}) has no registered "
                f"contract facts",
                "call register_operator_contract next to the operator's "
                "register_operator block"))
            continue
        entry = f.get("entry_point")
        if not dispatch.entry_point_exists(entry):
            findings.append(Finding(
                "REPRO-R07", dloc, 1,
                f"({key.family}, {key.precision}) contract facts name a "
                f"missing entry point {entry!r}",
                "entry_point must be 'module.function' of a public "
                "function in repro_torch.kernels"))
    return findings
