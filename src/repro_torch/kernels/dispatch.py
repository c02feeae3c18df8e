"""The port's operator registry: which backend runs each grouped-GEMM-shaped
operator, and on what evidence.

One table keyed by :class:`OpKey` ``(family, precision)``, as in the JAX
package:

  =============  ===========  ==============================================
  family         precision    operation (public function of the port)
  =============  ===========  ==============================================
  ``gemm``       ``fp8``      padding-free fp8 grouped GEMM (B2,
                              ``grouped_gemm_kernel.gmm``)
  ``gemm``       ``bf16``     bf16 grouped GEMM (B5, ``gmm_bf16``)
  ``gemm_quant`` ``fp8``      the same product with a quantizing store (B7,
                              ``gmm_quant``)
  ``wgrad``      ``bf16``     ``dw[g] = x_g^T dy_g`` (B4,
                              ``wgrad_kernel.gmm_wgrad``)
  ``wgrad``      ``fp8``      the same from e4m3 + 1x128 scales (B6,
                              ``gmm_wgrad_fp8``)
  ``quantize``   ``fp8``      1x128 tilewise quantization (B1,
                              ``quant_kernel.quantize_tilewise``)
  ``act_quant``  ``fp8``      fused activation -> quantization (B3,
                              ``epilogue_kernel.act_quantize``)
  =============  ===========  ==============================================

Each operator has the entries ``cuda`` (the hand-written kernel's launch
wrapper, available where a card and ``nvcc`` are) and ``plain`` (its
PyTorch version, always available); ``(gemm, fp8)`` and ``(gemm_quant,
fp8)`` also ``padded_baseline`` (the paper's baseline: pad, the same B2
launch, unpad; then, for the quantizing GEMM, the tilewise quantizer).

:func:`resolve` never falls back.  With no backend given it names ``cuda``
for a CUDA device and ``plain`` for the CPU, the rule every kernel
module's public function applies to its tensor's device; ``cuda`` on a
host where it is unavailable raises :class:`BackendUnavailableError`.
The hot path calls the kernel modules' public functions, not this table
(serving is host-bound, and a lookup a call is host time); a test holds
each public function's choice equal to :func:`resolve`'s.

The table also carries each operator's contract facts
(:func:`register_operator_contract`), which the registry lint (REPRO-R07)
checks, and the ``uses_plan`` / ``uses_tiles`` flags it checks (R04).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable, Optional

import torch

from repro_torch.kernels import epilogue_kernel, grouped_gemm_kernel, \
    quant_kernel, wgrad_kernel

FAMILIES = ("gemm", "gemm_quant", "wgrad", "quantize", "act_quant")
PRECISIONS = ("bf16", "fp8")

CUDA, PLAIN, PADDED_BASELINE = "cuda", "plain", "padded_baseline"

# suffix of the wgrad family's fp8-twin spellings ("cuda_fp8"); resolution
# strips it: the OpKey's precision, not the name, selects the arithmetic
_FP8_SUFFIX = "_fp8"


@dataclasses.dataclass(frozen=True)
class OpKey:
    """One operator of the registry: an operation family at an operand
    precision.  Hashable; accepted anywhere as a plain ``(family,
    precision)`` tuple."""
    family: str
    precision: str

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown op family {self.family!r}; "
                             f"choose from {FAMILIES}")
        if self.precision not in PRECISIONS:
            raise ValueError(f"unknown operand precision "
                             f"{self.precision!r}; choose from {PRECISIONS}")


def _op_key(op_key) -> OpKey:
    return op_key if isinstance(op_key, OpKey) else OpKey(*op_key)


class BackendUnavailableError(RuntimeError):
    """Requested backend cannot run here; ``.reason`` says why."""

    def __init__(self, name: str, reason: str):
        super().__init__(f"backend {name!r} unavailable: {reason}")
        self.backend = name
        self.reason = reason


@dataclasses.dataclass(frozen=True)
class BackendSpec:
    name: str
    description: str
    available: Callable[[], "tuple[bool, str]"]   # (ok, reason-if-not)
    run: Callable[..., Any]
    uses_plan: bool = False     # walks the TilePlan visitation schedule
    uses_tiles: bool = False    # honours KernelConfig tile shapes at all


# every (family, precision) operator's backend table
_OPERATORS: "dict[OpKey, dict[str, BackendSpec]]" = {}


def register_operator(op_key, name: str, *, description: str,
                      available: Callable[[], "tuple[bool, str]"],
                      run: Callable[..., Any], uses_plan: bool = False,
                      uses_tiles: bool = False) -> None:
    """Register a backend for one ``(family, precision)`` operator: the
    only write path into the registry."""
    _OPERATORS.setdefault(_op_key(op_key), {})[name] = BackendSpec(
        name, description, available, run, uses_plan=uses_plan,
        uses_tiles=uses_tiles)


def op_keys() -> "tuple[OpKey, ...]":
    return tuple(_OPERATORS)


def registry_names() -> "tuple[str, ...]":
    """Every backend name of the table, in registration order."""
    names: "dict[str, None]" = {}
    for table in _OPERATORS.values():
        names.update(dict.fromkeys(table))
    return tuple(names)


def _table(op_key) -> "dict[str, BackendSpec]":
    key = _op_key(op_key)
    if key not in _OPERATORS:
        raise ValueError(f"no operator registered for {key}; "
                         f"registered: {op_keys()}")
    return _OPERATORS[key]


def _canonical(op_key: OpKey, name: str) -> str:
    """Public spelling -> registry name: in the wgrad family the
    ``<name>_fp8`` twin suffix is stripped."""
    if op_key.family == "wgrad" and name.endswith(_FP8_SUFFIX):
        name = name[: -len(_FP8_SUFFIX)]
    return name


def device_backend(device) -> str:
    """The backend a tensor on ``device`` gets when none is named: ``cuda``
    on a CUDA device, ``plain`` on the CPU."""
    return CUDA if torch.device(device).type == "cuda" else PLAIN


def resolve(op_key, backend: Optional[str] = None, *, device=None) -> str:
    """The entry of ``op_key``'s table that runs: ``backend`` when named
    (``"auto"`` is the same as None), else :func:`device_backend` of
    ``device`` (default: CUDA).  An unavailable entry raises
    :class:`BackendUnavailableError` with its probe's reason, a name the
    table lacks ``ValueError``.  Nothing falls back: a card without its
    kernels never runs the plain versions."""
    key = _op_key(op_key)
    table = _table(key)
    if backend in (None, "auto"):
        name = device_backend("cuda" if device is None else device)
    else:
        name = _canonical(key, backend)
    if name not in table:
        raise ValueError(f"unknown backend {backend!r}; "
                         f"{key.family}/{key.precision} has {tuple(table)}")
    ok, reason = table[name].available()
    if not ok:
        raise BackendUnavailableError(name, reason)
    return name


def backend_matrix(op_key=None) -> "dict[str, Any]":
    """Availability and description rows.  ``op_key=None``: the ``(gemm,
    fp8)`` table; ``"all"``: every operator as ``{"family/precision":
    {name: row}}``; an OpKey or tuple: that operator's rows."""
    if op_key == "all":
        return {f"{k.family}/{k.precision}": backend_matrix(k)
                for k in sorted(_OPERATORS,
                                key=lambda k: (FAMILIES.index(k.family),
                                               k.precision))}
    key = _op_key(op_key) if op_key is not None else OpKey("gemm", "fp8")
    out = {}
    for name, spec in _table(key).items():
        ok, reason = spec.available()
        out[name] = {"available": ok, "reason": reason,
                     "description": spec.description,
                     "uses_plan": spec.uses_plan,
                     "uses_tiles": spec.uses_tiles}
    return out


# ---------------------------------------------------------------------------
# Built-in registrations
# ---------------------------------------------------------------------------

def _avail_always():
    return True, ""


def _avail_cuda():
    """A card, and an ``nvcc`` to build the kernels with."""
    if not torch.cuda.is_available():
        return False, "no CUDA device (torch.cuda.is_available() is False)"
    from repro_torch.kernels import build
    try:
        build.nvcc_path()
    except RuntimeError as exc:
        return False, str(exc)
    return True, ""


def _run_padded(a8, sa, b8, sb, gs, *, config=None, out_dtype=None):
    # deferred: the baseline's module imports the kernel modules
    from repro_torch.core import padding_baseline
    return padding_baseline.grouped_gemm_fp8_padded(
        a8, sa, b8, sb, gs, config=config, out_dtype=out_dtype)


def _run_padded_quant(a8, sa, b8, sb, gs, *, config=None, out_dtype=None):
    """The baseline's quantizing GEMM: the padded GEMM rounded through
    ``out_dtype``, then the tilewise quantizer (bitwise B7's store)."""
    y = _run_padded(a8, sa, b8, sb, gs, config=config, out_dtype=out_dtype)
    return quant_kernel.quantize_tilewise(y.float())


_KERNELS = (
    # (op key, kernel module, public function, plan, tiles, what it is)
    (("gemm", "fp8"), grouped_gemm_kernel, "gmm", True, True,
     "padding-free fp8 grouped GEMM (B2, csrc/grouped_gemm.cu)"),
    (("gemm", "bf16"), grouped_gemm_kernel, "gmm_bf16", True, True,
     "bf16 grouped GEMM (B5, csrc/gmm_bf16.cu)"),
    (("gemm_quant", "fp8"), grouped_gemm_kernel, "gmm_quant", True, True,
     "fp8 grouped GEMM with a quantizing store (B7, csrc/grouped_gemm.cu)"),
    (("wgrad", "bf16"), wgrad_kernel, "gmm_wgrad", True, True,
     "ragged-M weight gradient on bf16 operands (B4, csrc/wgrad_bf16.cu)"),
    (("wgrad", "fp8"), wgrad_kernel, "gmm_wgrad_fp8", True, True,
     "ragged-M weight gradient on e4m3 + 1x128 scales (B6, csrc/wgrad.cu)"),
    (("quantize", "fp8"), quant_kernel, "quantize_tilewise", False, False,
     "1x128 tilewise e4m3 quantization (B1, csrc/quant.cu)"),
    (("act_quant", "fp8"), epilogue_kernel, "act_quantize", False, False,
     "fused silu*mul / gelu -> 1x128 quantization (B3, csrc/act_quant.cu)"),
)


def _register_kernels() -> None:
    for key, mod, fn, plan, tiles, what in _KERNELS:
        register_operator(
            key, CUDA, description=f"hand-written CUDA kernel: {what}",
            available=_avail_cuda, run=getattr(mod, f"{fn}_cuda"),
            uses_plan=plan, uses_tiles=tiles)
        register_operator(
            key, PLAIN, description=f"its PyTorch version ({fn}_plain), "
            "what the CPU runs", available=_avail_always,
            run=getattr(mod, f"{fn}_plain"), uses_plan=plan,
            uses_tiles=tiles)


_register_kernels()

register_operator(
    ("gemm", "fp8"), PADDED_BASELINE,
    description="the paper's baseline: pad groups to block_m, the same "
                "grouped GEMM over the padded buffer, unpad",
    available=_avail_always, run=_run_padded,
    uses_tiles=True)       # block_m drives the padding; no plan consumed
register_operator(
    ("gemm_quant", "fp8"), PADDED_BASELINE,
    description="the padded baseline's GEMM, then the tilewise quantizer",
    available=_avail_always, run=_run_padded_quant, uses_tiles=True)


# ---------------------------------------------------------------------------
# Operator contract facts (registry lint, rule REPRO-R07)
# ---------------------------------------------------------------------------

# OpKey -> declarative facts the contract checker validates: which public
# function of ``repro_torch.kernels`` fronts the operator (``module.name``),
# whether its hot path is padding-free, and how many STANDALONE tilewise
# quantizations the operator itself performs (fused epilogues: zero)
_OP_CONTRACT_FACTS: "dict[OpKey, dict]" = {}


def register_operator_contract(op_key, *, entry_point: str,
                               padding_free: bool,
                               standalone_quantizes: int = 0) -> None:
    """Declare contract facts for one operator, next to its registration,
    so a new family cannot land without naming its invariants."""
    _OP_CONTRACT_FACTS[_op_key(op_key)] = {
        "entry_point": entry_point,
        "padding_free": padding_free,
        "standalone_quantizes": standalone_quantizes,
    }


def op_contract_facts() -> "dict[OpKey, dict]":
    return dict(_OP_CONTRACT_FACTS)


def entry_point_exists(entry_point: Optional[str]) -> bool:
    """Whether ``"module.function"`` names a callable of a
    ``repro_torch.kernels`` module."""
    if not entry_point or entry_point.count(".") != 1:
        return False
    mod_name, fn = entry_point.split(".")
    try:
        mod = importlib.import_module(f"repro_torch.kernels.{mod_name}")
    except ImportError:
        return False
    return callable(getattr(mod, fn, None))



def _register_kernel_contracts() -> None:
    for key, mod, fn, *_ in _KERNELS:
        register_operator_contract(
            key, entry_point=f"{mod.__name__.rsplit('.', 1)[1]}.{fn}",
            padding_free=True,
            standalone_quantizes=1 if key[0] == "quantize" else 0)


_register_kernel_contracts()
