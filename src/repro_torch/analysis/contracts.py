"""Layer 1: contracts over the public fp8 entry points, checked on the aten
ops a call dispatches.

A :class:`Contract` declares, for one path (``grouped_linear`` forward,
``moe_apply`` fwd+bwd, an Engine generate, ...), the structural
invariants the paper's recipe promises:

* exact standalone-quantize counts (REPRO-C01) and shape multisets,
* one TilePlan build per routing decision (REPRO-C02),
* zero padding copies on the padding-free path (REPRO-C03),
* zero wide (non-fp8) materialization of fused intermediates (REPRO-C04),
* producer-GEMM dispatch counts (REPRO-C05),
* decode plan discipline (REPRO-C06).

Counts come from the :mod:`repro_torch.analysis.events` bus (product
modules emit one event per plan build / standalone quantize /
producer dispatch / decode selection).  The port runs eagerly, so there
is no trace to walk: a ``mode="ops"`` contract runs ``fn(*args)`` on the
caller's device under a ``TorchDispatchMode`` that records each aten op's
name and its tensors' shapes and dtypes, forward and backward, and the
padding and wide-intermediate rules walk that record.  Kernel bodies stay
opaque, as ``pallas_call`` bodies are to the JAX package's walk: for the
window, the kernel modules' eight public functions are swapped for
wrappers that suspend the recording and emit one ``kernel`` event (the
plain versions run aten ops on the CPU that the kernels run in
registers).  A ``mode="run"`` contract (the Engine) runs with events
only, no recording, and hands its result to the contract's ``extra``
checker.  Counts are per executed call: a decode loop's every step
counts.

Product modules register their contracts at import time
(:func:`register_contract` at the bottom of ``core/grouped_gemm.py``,
``core/moe.py``, ``serve/engine.py``); :func:`load_registered` imports
them.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import math
import sys
from typing import Any, Callable, List, Optional, Sequence, Tuple

from repro_torch.analysis import events as ev
from repro_torch.analysis.findings import Finding, relpath

# aten ops that copy a buffer into a larger one, the port's counterparts of
# the JAX package's pad / dynamic_update_slice, with the positions of
# (destination buffer, source) among their arguments (constant_pad_nd's
# destination is its output).  A copy of a rank>=2 float or e4m3-byte
# buffer into more elements than it holds is padding; rank-1 and integer
# copies (the routing's slot bookkeeping) are not
PADDING_OPS = {"constant_pad_nd": (None, 0), "slice_scatter": (0, 1),
               "index_copy": (0, 3), "index_copy_": (0, 3),
               "index_put": (0, 2), "index_put_": (0, 2),
               "_index_put_impl_": (0, 2)}

# ops that relabel an existing wide value (no new activation): a cast or
# copy of an INPUT is not the fused path recomputing the activation wide;
# every view op (``OpOverload.is_view``) is skipped too
TRANSPARENT_OPS = frozenset({"_to_copy", "clone", "copy_", "detach", "alias",
                             "lift_fresh", "expand", "view", "_unsafe_view",
                             "reshape", "squeeze", "unsqueeze", "transpose",
                             "t", "permute"})

# modules whose import registers the port's contracts
CONTRACT_MODULES = ("repro_torch.core.grouped_gemm", "repro_torch.core.moe",
                    "repro_torch.serve.engine")

# (kernel module, public function): every kernel the paths reach
OPAQUE_KERNELS = (
    ("repro_torch.kernels.quant_kernel", "quantize_tilewise"),
    ("repro_torch.kernels.epilogue_kernel", "act_quantize"),
    ("repro_torch.kernels.grouped_gemm_kernel", "gmm"),
    ("repro_torch.kernels.grouped_gemm_kernel", "gmm_quant"),
    ("repro_torch.kernels.grouped_gemm_kernel", "gmm_bf16"),
    ("repro_torch.kernels.wgrad_kernel", "gmm_wgrad"),
    ("repro_torch.kernels.wgrad_kernel", "gmm_wgrad_fp8"),
    ("repro_torch.kernels.flash_attention_kernel", "flash_attention"),
)


@dataclasses.dataclass(frozen=True)
class Contract:
    """Declarative invariants for one path.  ``None`` expectation fields
    are unchecked: removing an expectation demonstrably lets the matching
    violation through (the coverage property the tests pin)."""
    name: str
    description: str = ""
    # (device) -> (fn, args); deferred so registration stays import-cheap.
    # None when the contract is only used via check_contract(fn, c, *args).
    build: "Optional[Callable[[Any], Tuple[Callable, tuple]]]" = None
    mode: str = "ops"                   # "ops" | "run"
    quantize_count: Optional[int] = None        # REPRO-C01
    quantize_shapes: "Optional[tuple]" = None   # sorted multiset, C01
    plan_builds: Optional[int] = None           # REPRO-C02
    forbid_padding: bool = False                # REPRO-C03
    forbid_wide_shapes: "tuple" = ()            # REPRO-C04
    gemm_quant_calls: Optional[int] = None      # REPRO-C05
    decode_selects: Optional[int] = None        # REPRO-C06
    # (result, events) -> [messages]; reported under REPRO-C06
    extra: "Optional[Callable[[Any, list], List[str]]]" = None
    path: str = ""                      # registration site, for findings
    line: int = 1


CONTRACTS: "dict[str, Contract]" = {}
_loaded = False


def register_contract(name: str, **kw) -> Contract:
    """Register a named contract (product modules call this at import).
    The registration site becomes the finding location."""
    frame = sys._getframe(1)
    kw.setdefault("path", relpath(frame.f_code.co_filename))
    kw.setdefault("line", frame.f_lineno)
    c = Contract(name=name, **kw)
    CONTRACTS[name] = c
    return c


def load_registered() -> "dict[str, Contract]":
    """Import the contract-carrying product modules, then return the
    registry."""
    global _loaded
    if not _loaded:
        for mod in CONTRACT_MODULES:
            importlib.import_module(mod)
        _loaded = True
    return CONTRACTS


# ---------------------------------------------------------------------------
# Recording the aten ops of a call
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class OpRecord:
    """One dispatched aten op: its name (``"index_copy_"``), whether it is
    a view, and ``(shape, dtype)`` of each positional tensor argument
    (None for other arguments) and of each output tensor."""
    op: str
    is_view: bool
    args: tuple
    outs: tuple


# > 0 while a kernel wrapper runs: its body's ops are not recorded
_suspended = [0]


def _meta(x):
    import torch
    return (tuple(x.shape), x.dtype) if isinstance(x, torch.Tensor) else None


def _recorder():
    """A ``TorchDispatchMode`` appending one :class:`OpRecord` an op to its
    ``ops`` list (built here: torch is imported only when a contract
    runs)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class Recorder(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops: "List[OpRecord]" = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not _suspended[0]:
                outs = tuple(m for m in map(_meta, tree_leaves(out))
                             if m is not None)
                self.ops.append(OpRecord(
                    func.overloadpacket.__name__, bool(func.is_view),
                    tuple(_meta(a) for a in args), outs))
            return out

    return Recorder()


@contextlib.contextmanager
def opaque_kernels():
    """Swap the kernel modules' public functions for wrappers that emit
    one ``kernel`` event and run the kernel (or its plain version)
    unrecorded; restored on exit."""
    saved = []

    def wrap(real, name):
        def kernel(*args, **kwargs):
            ev.emit("kernel", name=name)
            _suspended[0] += 1
            try:
                return real(*args, **kwargs)
            finally:
                _suspended[0] -= 1
        return kernel

    for modname, name in OPAQUE_KERNELS:
        mod = importlib.import_module(modname)
        real = getattr(mod, name)
        saved.append((mod, name, real))
        setattr(mod, name, wrap(real, name))
    try:
        yield
    finally:
        for mod, name, real in saved:
            setattr(mod, name, real)


def record_ops(fn: Callable, *args) -> "Tuple[Any, List[OpRecord]]":
    """``fn(*args)`` with its kernels opaque and its aten ops recorded."""
    with opaque_kernels(), _recorder() as rec:
        result = fn(*args)
    return result, rec.ops


# ---------------------------------------------------------------------------
# Rules over the recorded ops
# ---------------------------------------------------------------------------

def _payload(dtype) -> bool:
    """A float buffer, or e4m3 moved as its raw bytes."""
    import torch
    return dtype.is_floating_point or dtype == torch.uint8


def _padding_findings(ops, c: Contract) -> "List[Finding]":
    findings = []
    for rec in ops:
        if rec.op not in PADDING_OPS:
            continue
        dst_i, src_i = PADDING_OPS[rec.op]
        dst = rec.outs[0] if dst_i is None else rec.args[dst_i]
        src = rec.args[src_i] if src_i < len(rec.args) else None
        if dst is None or src is None:
            continue
        (shape, dtype), (src_shape, src_dtype) = dst, src
        # a zero-width pad adds nothing, and a negative-width pad (a
        # pad's backward) narrows: neither is padding
        if math.prod(shape) <= math.prod(src_shape):
            continue
        if len(shape) >= 2 and len(src_shape) >= 2 and _payload(dtype) \
                and _payload(src_dtype):
            name = str(dtype).removeprefix("torch.")
            findings.append(Finding(
                "REPRO-C03", c.path, c.line,
                f"[{c.name}] padding op '{rec.op}' materializes "
                f"{name}{list(shape)} from {list(src_shape)} on the "
                f"padding-free path",
                "the ragged grouped GEMM must consume the unpadded "
                "buffer; use the TilePlan schedule, not an aligned copy"))
    return findings


def _wide_findings(ops, c: Contract) -> "List[Finding]":
    shapes = {tuple(s) for s in c.forbid_wide_shapes}
    findings = []
    for rec in ops:
        if rec.is_view or rec.op in TRANSPARENT_OPS:
            continue
        for shape, dtype in rec.outs:
            if shape in shapes and dtype.is_floating_point \
                    and dtype.itemsize > 1:
                name = str(dtype).removeprefix("torch.")
                findings.append(Finding(
                    "REPRO-C04", c.path, c.line,
                    f"[{c.name}] '{rec.op}' materializes a wide "
                    f"{name}{list(shape)} intermediate on a fused path",
                    "the fused epilogue must emit fp8 payload + 1x128 "
                    "scales directly (act_quantize / gmm_quant)"))
    return findings


def _count_findings(captured, c: Contract) -> "List[Finding]":
    findings = []
    quants = ev.of_kind(captured, "quantize_tilewise")
    if c.quantize_count is not None and len(quants) != c.quantize_count:
        shapes = [e.data.get("shape") for e in quants]
        findings.append(Finding(
            "REPRO-C01", c.path, c.line,
            f"[{c.name}] expected exactly {c.quantize_count} standalone "
            f"quantize_tilewise call(s), ran {len(quants)} "
            f"(shapes: {shapes})",
            "share one QuantizedActivation per buffer (quantize-once) "
            "and let the fused epilogues own g/u/h"))
    if c.quantize_shapes is not None:
        got = sorted(tuple(e.data.get("shape", ())) for e in quants)
        want = sorted(tuple(s) for s in c.quantize_shapes)
        if got != want:
            findings.append(Finding(
                "REPRO-C01", c.path, c.line,
                f"[{c.name}] standalone-quantize shape multiset "
                f"{got} != expected {want}",
                "a shape drift here usually means an activation "
                "intermediate (g/u/h) is being re-quantized"))
    builds = ev.count(captured, "plan_build")
    if c.plan_builds is not None and builds != c.plan_builds:
        findings.append(Finding(
            "REPRO-C02", c.path, c.line,
            f"[{c.name}] expected {c.plan_builds} TilePlan build(s), "
            f"ran {builds}",
            "build the plan once (make_tile_plan) and pass it to every "
            "GEMM sharing the routing's group_sizes"))
    gq = ev.count(captured, "gemm_quant")
    if c.gemm_quant_calls is not None and gq != c.gemm_quant_calls:
        findings.append(Finding(
            "REPRO-C05", c.path, c.line,
            f"[{c.name}] expected {c.gemm_quant_calls} quantizing grouped "
            f"GEMM dispatch(es), ran {gq}",
            "the producer-fused path's gate/up GEMMs must route through "
            "the (gemm_quant, fp8) operator"))
    sel = ev.count(captured, "decode_select")
    if c.decode_selects is not None and sel != c.decode_selects:
        findings.append(Finding(
            "REPRO-C06", c.path, c.line,
            f"[{c.name}] expected {c.decode_selects} decode-config "
            f"selection(s), observed {sel}",
            "the Engine resolves its decode pool entry exactly once at "
            "construction"))
    return findings


# ---------------------------------------------------------------------------
# Checking
# ---------------------------------------------------------------------------

def check_contract(fn: Callable, contract: Contract, *args) -> "List[Finding]":
    """Check ``fn(*args)`` against ``contract``.

    ``mode="ops"``: runs with the kernels opaque and every aten op
    recorded, then walks the record for the padding and wide-intermediate
    rules.  ``mode="run"``: runs with events only and passes the result to
    the contract's ``extra`` checker.  Either way the event counts are
    checked.  A caller's open :func:`~repro_torch.analysis.events.capture`
    sees the same events.
    """
    c = contract
    findings: "List[Finding]" = []
    with ev.capture() as captured:
        if c.mode == "run":
            result, ops = fn(*args), None
        else:
            result, ops = record_ops(fn, *args)
    findings.extend(_count_findings(captured, c))
    if ops is not None:
        op_findings = []
        if c.forbid_padding:
            op_findings.extend(_padding_findings(ops, c))
        if c.forbid_wide_shapes:
            op_findings.extend(_wide_findings(ops, c))
        # a violating op typically recurs once per weight/GEMM of the
        # same path: one finding per distinct message is the signal
        seen = set()
        for f in op_findings:
            if f.message not in seen:
                seen.add(f.message)
                findings.append(f)
    if c.extra is not None:
        for msg in c.extra(result, captured):
            findings.append(Finding("REPRO-C06", c.path, c.line,
                                    f"[{c.name}] {msg}",
                                    "see the contract's description"))
    return findings


def run_contract(contract: Contract, device=None) -> "List[Finding]":
    """Build ``contract``'s call on ``device`` (default: the card) and
    check it."""
    from repro_torch.device import resolve_device
    if contract.build is None:
        raise ValueError(f"contract {contract.name!r} has no build(); use "
                         "check_contract(fn, contract, *args) directly")
    fn, args = contract.build(resolve_device(device))
    return check_contract(fn, contract, *args)


def run_registered(names: "Optional[Sequence[str]]" = None,
                   include_run_mode: bool = True,
                   device=None) -> "List[Finding]":
    """Run every registered contract (or the named subset) on ``device``.
    ``include_run_mode=False`` skips the Engine generate."""
    registry = load_registered()
    if names is None:
        names = sorted(registry)
    findings: "List[Finding]" = []
    for name in names:
        c = registry[name]
        if not include_run_mode and c.mode == "run":
            continue
        findings.extend(run_contract(c, device))
    return findings
