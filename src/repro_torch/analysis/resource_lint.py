"""Layer 4: static kernel-resource lint (REPRO-V01..V07).

Proves, without launching a kernel, that every tile config the plan
machinery can hand to a kernel fits the card it targets: the registered
operators of ``kernels.dispatch`` are crossed with every ``CONFIG_POOL``
/ ``DECODE_POOL`` / ``_DEVICE_DEFAULTS`` entry and every
``plan.DEVICE_SPECS`` device, and each ``(operator, config, device)``
triple is checked against :mod:`repro_torch.kernels.resources`, the
Hopper model of what one CTA of each kernel holds.  This is the paper's
static TMA-descriptor validation: 16-byte global rows, 128-byte swizzled
shared boxes, whole 1x128 scale blocks and the shared-memory budget.

Rules:

* **REPRO-V01**: the shared memory one CTA asks for exceeds the CTA
  budget (232448 B on the H100): the launch cannot start.
* **REPRO-V02**: ``block_m`` not a multiple of 8 (an MMA fragment's row
  group).
* **REPRO-V03**: ``block_n`` not a multiple of 128 (a 128-byte swizzled
  box row of e4m3), or K / N rows of the reference shape not 16-byte
  aligned for a TMA tensor map.
* **REPRO-V04**: ``block_k`` not a multiple of ``QUANT_BLOCK``.
* **REPRO-V05**: grid degeneracy at the family's reference shape.
* **REPRO-V06**: a decode entry taller than ``DECODE_MAX_BLOCK_M`` rows.
* **REPRO-V07**: the kernel's CTAs an SM (its ``__launch_bounds__``) do
  not fit one SM's shared memory and registers
  (:func:`~repro_torch.kernels.resources.fits_sm`).

An entry the card's kernels were not built for ("no CUDA variant",
:func:`~repro_torch.kernels.resources.missing_variant`) is pruned with its
reason, as ``plan.autotune`` prunes it: it is no finding; a caller's
``pruned`` list collects it.

``run()`` reads the registry and the pools (it imports the kernel
modules, so torch); ``check_entry`` and ``scan_file`` (JSON fixture
entries) are pure arithmetic.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

from repro_torch.analysis.findings import Finding, relpath
from repro_torch.kernels import resources as res

#: reference shapes the pool is proved against, per family: a large
#: training shape for the GEMM-shaped families, the FFN hidden size for the
#: element-wise kernels (the reference's table)
REF_SHAPES: "Dict[str, Dict[str, int]]" = {
    "gemm": {"m": 8192, "k": 4096, "n": 4096},
    "gemm_quant": {"m": 8192, "k": 4096, "n": 4096},
    "wgrad": {"m": 8192, "k": 4096, "n": 4096},
    "quantize": {"m": 8192, "k": 2048, "n": 2048},
    "act_quant": {"m": 8192, "k": 2048, "n": 2048},
}

#: reference decode step: a full serving batch of 16 token-rows
DECODE_REF_M = 16
#: the tallest tile a decode step can fill
DECODE_MAX_BLOCK_M = 16

_ALIGN_RULES = {"mma_rows": "REPRO-V02", "swizzle": "REPRO-V03",
                "tma_row": "REPRO-V03", "quant": "REPRO-V04"}

def launch_bound_registers(threads: int, ctas: int, *,
                           device: str = "nvidia h100") -> int:
    """Registers a thread that ``__launch_bounds__(threads, ctas)`` lets
    ptxas assign: the SM's registers over the CTAs' threads, rounded down
    to the 8-register allocation unit (the build's ptxas notes: 168 for
    B2 / B7's 384 threads, 128 for B6's 512)."""
    b = res.budgets(device)
    warps = -(-threads // 32)
    regs = b["regs_per_sm"] // (ctas * warps * 32) // 8 * 8
    return min(regs, b["max_regs_per_thread"])


def check_entry(family: str, config: Any, shape: "Dict[str, int]", *,
                device: str = "nvidia h100", decode: bool = False,
                where: str = "", path: str = "", line: int = 1,
                smem_bytes: Optional[int] = None,
                wgrad_precision: Optional[str] = None,
                gemm_precision: Optional[str] = None,
                registers: Optional[int] = None,
                pruned: "Optional[list]" = None) -> "List[Finding]":
    """Check one ``(family, config, device)`` triple at ``shape``.

    Checks short-circuit in severity order, as ``plan.autotune``'s
    pruning does: a misaligned entry gets only its alignment rule, an
    entry with no CUDA variant is pruned (appended to ``pruned`` with its
    reason, no finding), a degenerate grid gets only V05, and only a
    structurally sound entry is budget-checked (V01, then V07 at
    ``registers`` a thread, by default what its launch bounds allow).
    """
    m, k, n = shape["m"], shape["k"], shape.get("n", shape["k"])
    budget = res.smem_budget(device) if smem_bytes is None else smem_bytes
    bm, bn, bk = res.config_blocks(config)
    prec = gemm_precision or wgrad_precision
    op = f"{family}/{prec}" if prec else family
    triple = (f"{op} x {where or f'block_m={bm},block_n={bn},block_k={bk}'}"
              f" x {device}")
    out: "List[Finding]" = []

    # e4m3 rows, the strictest the kernels take
    align = res.alignment_issues(config, k=k, n=n)
    if align:
        for code, msg in align:
            out.append(Finding(rule_id=_ALIGN_RULES[code], path=path,
                               line=line, message=f"{triple}: {msg}"))
        return out

    reason = res.missing_variant(family, config)
    if reason is not None:
        if pruned is not None:
            pruned.append((triple, reason))
        return out

    elementwise = family in ("quantize", "act_quant")
    ns, ks = res.config_spans(config) if family == "wgrad" else (1, 1)
    degen = res.degeneracy_issues(config, m=m, k=k, n=n,
                                  elementwise=elementwise, n_span=ns,
                                  k_span=ks)
    if degen:
        for msg in degen:
            out.append(Finding(rule_id="REPRO-V05", path=path, line=line,
                               message=f"{triple}: {msg}"))
        return out

    if decode and not elementwise and bm > DECODE_MAX_BLOCK_M:
        out.append(Finding(
            rule_id="REPRO-V06", path=path, line=line,
            message=f"{triple}: decode entry block_m={bm} exceeds the "
                    f"largest decode step ({DECODE_MAX_BLOCK_M} "
                    f"token-rows) — fetched A rows can never be filled"))
        return out

    fp = res.footprint(family, config, m=m, k=k, n=n,
                       wgrad_precision=wgrad_precision,
                       gemm_precision=gemm_precision)
    if fp["total"] > budget:
        out.append(Finding(
            rule_id="REPRO-V01", path=path, line=line,
            message=f"{triple}: {fp['kernel']} asks {fp['total']} B of "
                    f"shared memory a CTA, over the {budget} B budget"))
        return out
    ctas = fp["ctas_per_sm"]
    if ctas:
        regs = registers if registers is not None else \
            launch_bound_registers(fp["threads"], ctas, device=device)
        fit = res.fits_sm(regs, fp["threads"], ctas, fp["total"],
                          device_kind=device)
        if not fit["fits"]:
            out.append(Finding(
                rule_id="REPRO-V07", path=path, line=line,
                message=f"{triple}: {ctas} CTA(s) of {fp['kernel']} "
                        f"({fp['threads']} threads, {regs} registers, "
                        f"{fp['total']} B) need {fit['smem_used']} / "
                        f"{fit['smem_budget']} B of shared memory and "
                        f"{fit['registers_used']} / "
                        f"{fit['registers_budget']} registers of one SM"))
    return out


def _registry_ops() -> "List[tuple]":
    """``(family, precision)`` of every registered operator, in the
    resource model's family order."""
    from repro_torch.kernels import dispatch
    keys = dispatch.op_keys()
    return [(k.family, k.precision) for f in res.FAMILIES
            for k in keys if k.family == f]


def _precisions(family: str, precision: str) -> dict:
    return {"gemm_precision": precision if family == "gemm" else None,
            "wgrad_precision": precision if family == "wgrad" else None}


def run(paths: "Optional[List[str]]" = None, *,
        pruned: "Optional[list]" = None) -> "List[Finding]":
    """Prove the whole tuning surface: registered operators x
    (CONFIG_POOL + DECODE_POOL + _DEVICE_DEFAULTS) x DEVICE_SPECS; the
    entries with no CUDA variant go to ``pruned`` as ``(triple,
    reason)`` pairs.

    With ``paths``, instead scan JSON fixture files (torch-free).
    """
    out: "List[Finding]" = []
    if paths:
        for p in paths:
            out.extend(scan_file(p, pruned=pruned))
        return out

    from repro_torch.kernels import plan
    plan_path = relpath(plan.__file__)
    ops = _registry_ops()
    for family, prec in ops:
        ref = REF_SHAPES.get(family, REF_SHAPES["gemm"])
        kw = _precisions(family, prec)
        for device in sorted(plan.DEVICE_SPECS):
            for cfg in plan.CONFIG_POOL:
                where = (f"CONFIG_POOL[block_m={cfg.block_m},"
                         f"block_n={cfg.block_n},block_k={cfg.block_k},"
                         f"ns={cfg.n_span},ks={cfg.k_span}]")
                out.extend(check_entry(family, cfg, ref, device=device,
                                       where=where, path=plan_path,
                                       pruned=pruned, **kw))
            if family in ("gemm", "gemm_quant"):
                dref = dict(ref, m=DECODE_REF_M)
                for cfg in plan.DECODE_POOL:
                    where = (f"DECODE_POOL[block_m={cfg.block_m},"
                             f"block_n={cfg.block_n},block_k={cfg.block_k}]")
                    out.extend(check_entry(family, cfg, dref, device=device,
                                           decode=True, where=where,
                                           path=plan_path, pruned=pruned,
                                           **kw))

    # device defaults are checked against their OWN device's budget
    for dev_key, kw_cfg in plan._DEVICE_DEFAULTS:
        try:
            cfg = plan.KernelConfig(**kw_cfg)
        except (TypeError, ValueError) as exc:  # pragma: no cover - lint net
            out.append(Finding(
                rule_id="REPRO-V02", path=plan_path, line=1,
                message=f"_DEVICE_DEFAULTS[{dev_key!r}] does not construct "
                        f"a KernelConfig: {exc}"))
            continue
        for family, prec in ops:
            ref = REF_SHAPES.get(family, REF_SHAPES["gemm"])
            out.extend(check_entry(
                family, cfg, ref, device=dev_key,
                where=f"_DEVICE_DEFAULTS[{dev_key!r}]", path=plan_path,
                pruned=pruned, **_precisions(family, prec)))
    return out


def scan_file(path: str, pruned: "Optional[list]" = None
              ) -> "List[Finding]":
    """Check fixture entries from a JSON file: one entry object or a list
    of ``{"family", "config", "shape", "device"?, "decode"?, "where"?,
    "wgrad_precision"?, "gemm_precision"?, "smem_bytes"?, "registers"?}``
    objects (``smem_bytes`` overrides the device's CTA budget).
    Pure arithmetic: no torch import."""
    with open(path) as f:
        data = json.load(f)
    entries = data if isinstance(data, list) else [data]
    rel = relpath(os.path.abspath(path))
    out: "List[Finding]" = []
    for entry in entries:
        out.extend(check_entry(
            entry["family"], entry["config"], entry["shape"],
            device=entry.get("device", "nvidia h100"),
            decode=bool(entry.get("decode", False)),
            where=entry.get("where", ""), path=rel,
            wgrad_precision=entry.get("wgrad_precision"),
            gemm_precision=entry.get("gemm_precision"),
            smem_bytes=entry.get("smem_bytes"),
            registers=entry.get("registers"), pruned=pruned))
    return out
