"""Kernel contract checker of the port: static analysis for the
padding-free / quantize-once / alignment / resource invariants.

Five layers (``python -m repro_torch.analysis --all`` runs them all):

1. **contracts** (:mod:`repro_torch.analysis.contracts`, REPRO-C*): run
   the public fp8 entry points, count their events and walk the aten ops
   they dispatch: exact standalone-quantize counts, one TilePlan build
   per routing decision, zero padding copies, zero wide fused
   intermediates.
2. **registry/alignment lint** (:mod:`repro_torch.analysis.registry_lint`,
   REPRO-R*): the ``kernels.dispatch`` table and the
   ``CONFIG_POOL``/``DECODE_POOL``/``KernelConfig`` constants.
3. **AST lint** (:mod:`repro_torch.analysis.ast_lint`, REPRO-A*): no
   direct kernel-internal calls outside kernels/, no bare asserts in
   kernel files, no block-shape literals outside kernels/.
4. **resource lint** (:mod:`repro_torch.analysis.resource_lint`,
   REPRO-V*): every pool entry against the Hopper resource model.
5. **prepare-once contracts** (:mod:`repro_torch.analysis.retrace`,
   REPRO-T*): shape-stable repeat calls build, load, cache, measure and
   select nothing again.

This ``__init__`` is import-cheap on purpose: hot-path modules import
:mod:`repro_torch.analysis.events` through the package, so nothing here
may pull in torch or the product modules at import time.
"""
from __future__ import annotations

_LAZY = {
    "events": ("repro_torch.analysis.events", None),
    "Finding": ("repro_torch.analysis.findings", "Finding"),
    "RULES": ("repro_torch.analysis.findings", "RULES"),
    "Contract": ("repro_torch.analysis.contracts", "Contract"),
    "check_contract": ("repro_torch.analysis.contracts", "check_contract"),
    "register_contract": ("repro_torch.analysis.contracts",
                          "register_contract"),
    "run_registered": ("repro_torch.analysis.contracts", "run_registered"),
    "load_registered": ("repro_torch.analysis.contracts", "load_registered"),
    "run_registry_lint": ("repro_torch.analysis.registry_lint", "run"),
    "run_ast_lint": ("repro_torch.analysis.ast_lint", "scan_paths"),
    "run_resource_lint": ("repro_torch.analysis.resource_lint", "run"),
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    import importlib
    try:
        modname, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(f"module 'repro_torch.analysis' has no "
                             f"attribute {name!r}") from None
    mod = importlib.import_module(modname)
    return mod if attr is None else getattr(mod, attr)
