"""TilePlan subsystem: plan-once/run-many grouped GEMM configuration.

The paper's core mechanism is a *preconfigured descriptor pool* with cheap
runtime selection (log2(block_M) TMA descriptors, Eq. 2): configure
expensive launch state once, select per launch.  This module is the
port's analogue, in four pieces:

``KernelConfig``
    One frozen record of the tile-shape decisions (``block_m/n/k`` and
    the wgrad's ``n_span/k_span``), the grouped GEMM's backend, the
    output dtype of a grouped GEMM, the operand precision of the training
    step's wgrad and whether the fp8 FFN's gate/up GEMMs quantize in
    their store (``fuse_producer``).  Static alignment constraints are
    checked at construction, the shape-dependent ones (and the card's
    shared-memory budget, from :mod:`repro_torch.kernels.resources`) by
    :meth:`KernelConfig.validate`.  ``config=None`` call sites resolve to
    :func:`get_default_config`: an installed default
    (:func:`set_default_config`, or the trainer's :func:`default_config`
    scope) or the device's (:meth:`KernelConfig.default`).

``TilePlan``
    The visitation schedule (``group_offsets/group_ids/m_tile_ids``) the
    padding-free kernel walks.  It depends only on ``(group_sizes, m,
    block_m)``, so one MoE layer application builds it once per routing
    decision and reuses it for every GEMM that shares those group sizes.
    The schedule is built with tensor ops on the device of
    ``group_sizes``: building it never waits for the device.

``PlanCache``
    Serves every static plan shape once: per ``(m, block_m, num_groups,
    dtype, device)`` key it keeps that shape's static device tensors, so
    a call site that plans per call (the padded baseline) replays only
    the data-dependent ops.

Pool autotuner
    ``CONFIG_POOL`` (the descriptor-pool analogue) is ranked by a roofline
    cost model of the H100 (:class:`DeviceSpec`), pruned by the static
    resource model (each pruned entry with its reason), and the top
    entries are measured on the card with CUDA events.  Selections
    persist to the port's own JSON cache keyed by ``(device kind,
    backend, M-bucket, K, N, G, op)``, so the measurement runs once per
    shape class per machine.  Where the card's kernel takes no tile
    parameter, and on the CPU, where the plain versions run, an op is
    tile-free: the cost model ranks it and nothing is measured.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import logging
import os
import statistics
from typing import Any, Iterable, Optional

import torch

from repro_torch.analysis import events as _events
from repro_torch.device import resolve_device
from repro_torch.kernels import resources as _resources

logger = logging.getLogger("repro_torch.plan")

QUANT_BLOCK = 128  # the paper's 1x128 / 128x128 quantization granularity

#: the backend of the paper's baseline: pad every group to ``block_m``,
#: run the same grouped GEMM over the padded buffer, unpad
#: (:mod:`repro_torch.core.padding_baseline`)
PADDED_BASELINE = "padded_baseline"
#: the JAX package's other registry names (and the ``xla`` alias): the
#: port's registry (``kernels/dispatch.py``) has its own, so these raise
UNPORTED_BACKENDS = ("pallas", "pallas_interpret", "xla_ragged", "xla_exact",
                     "xla", "ref")


def check_backend(backend: Optional[str]) -> None:
    """Pass the backends a config takes: ``None`` (the kernels on the card,
    their plain versions on the CPU, by the tensor's device) and
    ``"padded_baseline"``.  A registry name of the JAX package (also
    spelled with ``_fp8``) raises ``NotImplementedError`` naming the
    port's registry, any other name ``ValueError``."""
    if backend is None or backend == PADDED_BASELINE:
        return
    # deferred: the registry imports the kernel modules, which import this
    from repro_torch.kernels import dispatch
    names = dispatch.registry_names()
    base = backend[:-len("_fp8")] if backend.endswith("_fp8") else backend
    if base in UNPORTED_BACKENDS:
        raise NotImplementedError(
            f"backend {backend!r} is a JAX-package registry name; the "
            f"port's registry (kernels/dispatch.py) has {names}, and a "
            f"KernelConfig takes None (cuda or plain by the tensor's "
            f"device) or {PADDED_BASELINE!r}")
    raise ValueError(f"unknown backend {backend!r}; a KernelConfig takes "
                     f"None (cuda or plain by the tensor's device: "
                     f"kernels/dispatch.py has {names}) or "
                     f"{PADDED_BASELINE!r}")


def _dtype_name(dtype: Optional[torch.dtype]) -> Optional[str]:
    """A torch dtype as torch spells its attribute (``"bfloat16"``)."""
    return None if dtype is None else str(dtype).removeprefix("torch.")


def _dtype_of(name: Optional[str]) -> Optional[torch.dtype]:
    if name is None:
        return None
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"{name!r} is not a torch dtype")
    return dtype


# ---------------------------------------------------------------------------
# KernelConfig
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """Frozen tile-shape + out-dtype descriptor for one grouped GEMM,
    with the recipe switches the layers read (``wgrad_precision``,
    ``fuse_producer``)."""

    block_m: int = 128
    block_n: int = 128
    block_k: int = 128
    # None: the padding-free kernels (their plain versions on the CPU);
    # "padded_baseline": the paper's baseline (pad, the same GEMM, unpad)
    # for every fp8 grouped and dense GEMM, forward and dgrad
    backend: Optional[str] = None
    # None = the call site decides (grouped_linear uses x.dtype); pin a
    # dtype to override every consumer
    out_dtype: Optional[torch.dtype] = None
    # operand precision of the training step's wgrad GEMM: "bf16" (the
    # DeepSeek recipe: the wgrad contracts the highest-precision operands)
    # or "fp8" (arXiv 2505.20524: x and dy arrive as fp8 with their 1x128
    # tile scales, the forward's and the dgrad's, and are dequantized in
    # the kernel)
    wgrad_precision: str = "bf16"
    # route the fp8 FFN's gate/up GEMMs through the quantizing-epilogue
    # producer (``op="gemm_quant"``): the GEMMs emit fp8 + 1x128 scales
    # directly and the activation epilogue dequantizes on load, so the
    # bf16 g/u intermediates never exist.  Off by default — the fused
    # recipe quantizes g/u once more than the bf16-residual recipe, an
    # e4m3-relative-error tolerance delta (see core.grouped_gemm)
    fuse_producer: bool = False
    # multi-tile wgrad spans: one output super-tile of (k_span*block_k,
    # n_span*block_n) a walk step.  Only the wgrad family reads them; the
    # plain wgrads compute the same dw for any span, the CUDA wgrads have
    # none and raise on a span > 1 (resources.missing_variant)
    n_span: int = 1
    k_span: int = 1

    def __post_init__(self):
        if self.block_m % 8 != 0:
            raise ValueError(
                f"block_m must be a multiple of 8, got {self.block_m}")
        if self.block_n % 128 != 0:
            raise ValueError(
                f"block_n must be a multiple of 128, got {self.block_n}")
        if self.block_k % QUANT_BLOCK != 0:
            raise ValueError(
                f"block_k must be a multiple of {QUANT_BLOCK}, got {self.block_k}")
        if self.out_dtype is not None and not isinstance(self.out_dtype,
                                                         torch.dtype):
            raise TypeError(f"out_dtype must be a torch.dtype, got "
                            f"{self.out_dtype!r}")
        if self.wgrad_precision not in ("bf16", "fp8"):
            raise ValueError(f"wgrad_precision must be 'bf16' or 'fp8', "
                             f"got {self.wgrad_precision!r}")
        for axis in ("n_span", "k_span"):
            v = getattr(self, axis)
            if not isinstance(v, int) or isinstance(v, bool) or v < 1:
                raise ValueError(f"{axis} must be an int >= 1, got {v!r}")
        check_backend(self.backend)

    def validate(self, m: int, k: int, n: int, *,
                 family: str = "gemm") -> "KernelConfig":
        """Shape-dependent constraints.  M is deliberately unconstrained:
        handling arbitrary (ragged) M without padding is the point of the
        paper.  ``family="wgrad"``: K and N are the output's [K, N] tile
        axes, multiples of the (span-widened) tiles and of 128 (the 1x128
        scales of the fp8 operands run along them).

        The static resource model then budget-checks the shared memory
        one CTA of ``family``'s kernel needs under this geometry against
        the device, so an infeasible config raises here with the computed
        bytes instead of failing at launch."""
        if family not in _resources.FAMILIES:
            raise ValueError(f"unknown family {family!r}; use one of "
                             f"{_resources.FAMILIES}")
        eff_k, eff_n = self.effective_blocks(family)
        if k % eff_k != 0:
            raise ValueError(
                f"K={k} must be a multiple of block_k={self.block_k}"
                + (f" * k_span={self.k_span}" if eff_k != self.block_k else ""))
        if n % eff_n != 0:
            raise ValueError(
                f"N={n} must be a multiple of block_n={self.block_n}"
                + (f" * n_span={self.n_span}" if eff_n != self.block_n else ""))
        if family == "wgrad" and (k % QUANT_BLOCK or n % QUANT_BLOCK):
            raise ValueError(f"wgrad needs K={k} and N={n} to be multiples "
                             f"of {QUANT_BLOCK}")
        budget = device_spec().smem_bytes
        fp = _footprint(family, self.block_m, self.wgrad_precision)
        if fp["total"] > budget:
            raise ValueError(
                f"{family} config (block_m={self.block_m}, block_n="
                f"{self.block_n}, block_k={self.block_k}) needs "
                f"{fp['total']} B of shared memory a CTA of {fp['kernel']} "
                f"at M={m}, K={k}, N={n}: over the {budget} B budget "
                f"(buffers: {fp['buffers']})")
        return self

    def effective_blocks(self, family: str = "gemm") -> "tuple[int, int]":
        """(K, N) divisibility units for ``family``: the wgrad walks whole
        (k_span*block_k, n_span*block_n) super-tiles; every other family
        ignores the spans."""
        if family == "wgrad":
            return self.block_k * self.k_span, self.block_n * self.n_span
        return self.block_k, self.block_n

    def compatible(self, k: int, n: int, family: str = "gemm") -> bool:
        eff_k, eff_n = self.effective_blocks(family)
        return k % eff_k == 0 and n % eff_n == 0

    def with_(self, **kw) -> "KernelConfig":
        return dataclasses.replace(self, **kw)

    # ---- (de)serialization for the autotune cache ----------------------
    def to_dict(self) -> dict:
        return {"block_m": self.block_m, "block_n": self.block_n,
                "block_k": self.block_k, "backend": self.backend,
                "out_dtype": _dtype_name(self.out_dtype),
                "wgrad_precision": self.wgrad_precision,
                "fuse_producer": self.fuse_producer,
                "n_span": self.n_span, "k_span": self.k_span}

    @classmethod
    def from_dict(cls, d: dict) -> "KernelConfig":
        return cls(block_m=int(d["block_m"]), block_n=int(d["block_n"]),
                   block_k=int(d["block_k"]), backend=d.get("backend"),
                   out_dtype=_dtype_of(d.get("out_dtype")),
                   wgrad_precision=d.get("wgrad_precision", "bf16"),
                   fuse_producer=bool(d.get("fuse_producer", False)),
                   n_span=int(d.get("n_span", 1)),
                   k_span=int(d.get("k_span", 1)))

    @classmethod
    def default(cls, device_kind: Optional[str] = None) -> "KernelConfig":
        """Per-device default tile shape (the untuned seed of the pool)."""
        kind = (device_kind or _device_kind()).lower()
        for prefix, cfg_kw in _DEVICE_DEFAULTS:
            if kind.startswith(prefix):
                return cls(**cfg_kw)
        return cls()


@functools.lru_cache(maxsize=None)
def _footprint(family: str, block_m: int, wgrad_precision: str) -> dict:
    """The resource model's footprint of ``family`` at ``block_m``: it
    reads no other field and no shape, and every GEMM call validates, so
    it is computed once a geometry (callers must not mutate it)."""
    return _resources.footprint(family, {"block_m": block_m}, m=0, k=0, n=0,
                                wgrad_precision=wgrad_precision)


# per-device default block shapes, first prefix match wins: the H100's
# grouped GEMMs are built for 16- and 128-row tiles, and 128 serves every
# shape that is not a decode step
_DEVICE_DEFAULTS = (
    ("nvidia h100", dict(block_m=128)),
    ("cpu", dict(block_m=128)),
)


def device_kind(device=None) -> str:
    """The kind of ``device`` as the defaults and the cache keys read it:
    the card's name (``torch.cuda.get_device_name``, e.g. ``"NVIDIA H100
    80GB HBM3"``) for a CUDA device, ``"cpu"`` for the CPU."""
    dev = torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


@functools.lru_cache(maxsize=None)
def _device_kind() -> str:
    """The kind of the device the entry points default to: the first card
    where there is one, else the CPU."""
    return device_kind("cuda:0" if torch.cuda.is_available() else "cpu")


# ---------------------------------------------------------------------------
# Default-config seam (serve/train thread a tuned config through here)
# ---------------------------------------------------------------------------

# the config ``config=None`` call sites resolve to, when installed
_default_config: Optional[KernelConfig] = None


def set_default_config(config: Optional[KernelConfig]) -> None:
    """Install the config that ``config=None`` call sites resolve to (None
    uninstalls it).  Read at each call: the layers keep the config they
    read in their forward for their backward."""
    global _default_config
    _default_config = config


def get_default_config() -> KernelConfig:
    return _default_config if _default_config is not None \
        else KernelConfig.default()


def pinned_default() -> Optional[KernelConfig]:
    """The explicitly installed default, or None when unset: callers that
    would otherwise tune check this to honour a pin."""
    return _default_config


@contextlib.contextmanager
def default_config(config: Optional[KernelConfig]):
    """Scope the config of every ``config=None`` call site (the trainer
    wraps its loss in one, to pin tile shapes and ``wgrad_precision``).
    The grouped linear layers read it in their forward and keep it for
    their backward, which runs outside the scope."""
    global _default_config
    prev = _default_config
    _default_config = config
    try:
        yield
    finally:
        _default_config = prev


def resolve_config(config: Optional[KernelConfig] = None, *,
                   backend: Optional[str] = None,
                   out_dtype: Optional[torch.dtype] = None,
                   wgrad_precision: Optional[str] = None) -> KernelConfig:
    """Effective config for a call site: the explicit ``config`` or the
    default one, with per-call ``backend``, ``out_dtype`` and
    ``wgrad_precision`` overrides on top.  ``backend="auto"`` sets the
    config's backend back to None."""
    cfg = config if config is not None else get_default_config()
    if backend is not None:
        cfg = cfg.with_(backend=None if backend == "auto" else backend)
    if out_dtype is not None:
        cfg = cfg.with_(out_dtype=out_dtype)
    if wgrad_precision is not None:
        cfg = cfg.with_(wgrad_precision=wgrad_precision)
    return cfg


# ---------------------------------------------------------------------------
# Group metadata (descriptor selection, Eq. 2) and TilePlan
# ---------------------------------------------------------------------------

def _static_tensors(m: int, block_m: int, num_groups: int, device):
    """The schedule's tensors that depend on the static shape alone: the
    visit index ``t`` [T] and a zero head for the cumulative sums."""
    num_tiles = (m + block_m - 1) // block_m
    max_visits = max(num_tiles + num_groups - 1, 1)
    return (torch.arange(max_visits, dtype=torch.int64, device=device),
            torch.zeros(1, dtype=torch.int64, device=device))


def _schedule(group_sizes: torch.Tensor, m: int, block_m: int,
              num_groups: int, t: torch.Tensor, zero: torch.Tensor):
    """The data-dependent part of :func:`make_group_metadata`, over the
    static tensors of :func:`_static_tensors`.  Every output is a new
    tensor: none aliases ``t`` or ``zero``."""
    sizes = group_sizes.to(torch.int64)
    group_offsets = torch.cat([zero, torch.cumsum(sizes, 0)])
    starts = group_offsets[:-1]
    ends = group_offsets[1:]
    first_tile = torch.div(starts, block_m, rounding_mode="floor")
    last_tile_excl = torch.div(ends + block_m - 1, block_m,
                               rounding_mode="floor")
    tiles_per = torch.clamp(last_tile_excl - first_tile, min=0)
    # zero-size groups get zero visits (even when their offset is unaligned)
    tiles_per = torch.where(sizes == 0, torch.zeros_like(tiles_per), tiles_per)

    num_tiles = (m + block_m - 1) // block_m
    visit_ends = torch.cumsum(tiles_per, 0)                      # [G]
    num_real = visit_ends[-1]
    t_clamped = torch.clamp(torch.minimum(t, num_real - 1), min=0)
    group_ids = torch.searchsorted(visit_ends, t_clamped, right=True)
    group_ids = torch.clamp(group_ids, max=num_groups - 1)
    visits_before = torch.cat([zero, visit_ends[:-1]])
    m_tile_ids = first_tile[group_ids] + (t_clamped - visits_before[group_ids])
    m_tile_ids = torch.clamp(m_tile_ids, 0, max(num_tiles - 1, 0))
    # padding visits sweep the tail tiles; with no tail they clamp to the
    # last real tile and repeat its visit
    total = ends[-1]
    last_real_tile = torch.div(total + block_m - 1, block_m,
                               rounding_mode="floor") - 1
    pad_tile = torch.clamp(last_real_tile + 1 + (t - num_real),
                           max=max(num_tiles - 1, 0))
    m_tile_ids = torch.where(t >= num_real, torch.clamp(pad_tile, min=0),
                             m_tile_ids)
    group_ids = torch.where(num_real == 0, torch.zeros_like(group_ids),
                            group_ids)
    return (group_offsets.to(torch.int32), group_ids.to(torch.int32),
            m_tile_ids.to(torch.int32))


def make_group_metadata(group_sizes: torch.Tensor, m: int, block_m: int,
                        num_groups: int):
    """Visitation schedule of the padding-free grouped GEMM.

    Returns ``(group_offsets[G+1], group_ids[T], m_tile_ids[T])``, all
    int32, where ``T = ceil(m/block_m) + num_groups - 1`` is the static
    worst-case visit count: every tile is visited once, plus one extra
    visit per group boundary that splits a tile.

    Padding visits (``t >= num_real``) sweep the tail tiles, the output
    tiles entirely beyond ``sum(group_sizes)``, so the kernel zero-fills
    every unowned row.  With no tail they repeat the last real (group,
    tile) visit; a consumer recognises such a duplicate by
    ``(group_ids[t], m_tile_ids[t]) == (group_ids[t-1], m_tile_ids[t-1])``.
    When every group is empty, every visit is a padding visit pinned to
    group 0 and the sweep covers all tiles.
    """
    _events.emit("plan_build", m=m, block_m=block_m, num_groups=num_groups)
    t, zero = _static_tensors(m, block_m, num_groups, group_sizes.device)
    return _schedule(group_sizes, m, block_m, num_groups, t, zero)


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """Precomputed grouped-GEMM schedule, reusable across every GEMM that
    shares the same ``group_sizes``.

    CONTRACT: a plan is only valid for the exact ``group_sizes`` it was
    built from.  The static fields are checked at use; the index tensors
    are trusted.  Never cache plans across routing decisions.
    """
    group_offsets: torch.Tensor   # [G+1] int32 row offsets (cumsum of sizes)
    group_ids: torch.Tensor       # [T]   int32 visit -> group
    m_tile_ids: torch.Tensor      # [T]   int32 visit -> output M tile
    m: int
    block_m: int
    num_groups: int

    @property
    def num_tiles(self) -> int:
        return (self.m + self.block_m - 1) // self.block_m

    @property
    def max_visits(self) -> int:
        return max(self.num_tiles + self.num_groups - 1, 1)

    def total_rows(self) -> torch.Tensor:
        """Sum of group sizes (rows the kernel actually owns), on device."""
        return self.group_offsets[-1]

    def check_against(self, m: int, block_m: int, num_groups: int) -> None:
        if (self.m, self.block_m, self.num_groups) != (m, block_m, num_groups):
            raise ValueError(
                f"TilePlan built for (m={self.m}, block_m={self.block_m}, "
                f"num_groups={self.num_groups}) used with (m={m}, "
                f"block_m={block_m}, num_groups={num_groups}); rebuild the "
                f"plan or pass a matching KernelConfig")


def make_tile_plan(group_sizes: torch.Tensor, m: int, *,
                   config: Optional[KernelConfig] = None,
                   block_m: Optional[int] = None,
                   num_groups: Optional[int] = None) -> TilePlan:
    """Build the visitation schedule once per routing decision."""
    if block_m is None:
        block_m = (config or get_default_config()).block_m
    num_groups = num_groups if num_groups is not None else group_sizes.shape[0]
    offsets, group_ids, m_tile_ids = make_group_metadata(
        group_sizes, m, block_m, num_groups)
    return TilePlan(offsets, group_ids, m_tile_ids, m=int(m),
                    block_m=int(block_m), num_groups=int(num_groups))


# ---------------------------------------------------------------------------
# PlanCache: serve every static plan shape once
# ---------------------------------------------------------------------------

class PlanCache:
    """Serves every *static* plan shape exactly once.

    A :class:`TilePlan`'s tensors depend on the ``group_sizes`` data, so
    the plan itself cannot be cached across calls, but its static part
    can: for one static key ``(m, block_m, num_groups, group_sizes dtype,
    device)`` the shape's static device tensors (the visit index, the
    zero heads) are made once, and every later call with that key
    replays only the data-dependent ops.  A replay's plan
    shares no tensor a later replay writes, so a plan kept for a backward
    survives the planning of later layers.  Plans are bitwise
    :func:`make_tile_plan`'s.

    ``builds`` counts the keys built (the regression surface for "two
    calls with the same static shape build exactly one plan"); each build
    emits one ``plan_build`` event, a replay none.
    """

    def __init__(self):
        self._static: "dict[tuple, tuple]" = {}
        self.builds = 0

    def clear(self) -> None:
        self._static.clear()
        self.builds = 0

    def get(self, group_sizes: torch.Tensor, m: int, *,
            block_m: Optional[int] = None,
            num_groups: Optional[int] = None) -> TilePlan:
        if block_m is None:
            block_m = get_default_config().block_m
        if num_groups is None:
            num_groups = group_sizes.shape[0]
        m, block_m, num_groups = int(m), int(block_m), int(num_groups)
        key = (m, block_m, num_groups, _dtype_name(group_sizes.dtype),
               str(group_sizes.device))
        static = self._static.get(key)
        if static is None:
            self.builds += 1
            # ``shared`` tells a cached shape's build (what the
            # prepare-once contracts count) from a per-call one
            _events.emit("plan_build", m=m, block_m=block_m,
                         num_groups=num_groups, shared=True)
            static = _static_tensors(m, block_m, num_groups,
                                     group_sizes.device)
            self._static[key] = static
        offsets, group_ids, m_tile_ids = _schedule(
            group_sizes, m, block_m, num_groups, *static)
        return TilePlan(offsets, group_ids, m_tile_ids, m=m,
                        block_m=block_m, num_groups=num_groups)


#: process-wide instance: cached plan shapes sit beside the autotune
#: entries as the other per-shape-class artifact
PLAN_CACHE = PlanCache()


def shared_plan(group_sizes: torch.Tensor, m: int, *,
                block_m: Optional[int] = None,
                num_groups: Optional[int] = None) -> TilePlan:
    """Build (or replay) a :class:`TilePlan` through the process-wide
    :data:`PLAN_CACHE`."""
    return PLAN_CACHE.get(group_sizes, m, block_m=block_m,
                          num_groups=num_groups)


# ---------------------------------------------------------------------------
# Block-shape pool (the descriptor-pool analogue)
# ---------------------------------------------------------------------------

# block_m sweeps the paper's log2 descriptor axis; the (block_n, block_k)
# cross stays small: one 128-wide output tile or a double-wide variant.
# ONE pool serves every autotune op (the keys of ``_AUTOTUNE_OPS``): each
# op ranks the same candidates by its own roofline terms and caches the
# winner under its own key.  The pool is the JAX package's, entry for
# entry; the resource model prunes what the card's kernels lack (block_m
# 8, 64, 256, 512, block_n 256 and the wgrad spans: no CUDA variant),
# each with its reason.
#
# The decode entries (block_m 8 / 16) extend the descriptor axis down to
# serving's tiny-M regime: a decode step's grouped GEMM has M =
# batch*top_k rows in all, so a 128-row tile wastes most of its fetched A
# rows.  The MMA-occupancy term of the cost model (``_eff_rows``) keeps
# them from ranking at training shapes.
DECODE_BLOCK_MS = (8, 16)
DECODE_POOL: "tuple[KernelConfig, ...]" = tuple(
    KernelConfig(block_m=bm) for bm in DECODE_BLOCK_MS)
# multi-tile wgrad span axis: same 128x128 base tile, one output
# super-tile of (k_span*128, n_span*128) a walk step
WGRAD_SPANS = (2, 4)
CONFIG_POOL: "tuple[KernelConfig, ...]" = DECODE_POOL + tuple(
    KernelConfig(block_m=bm, block_n=bn, block_k=bk)
    for bm in (64, 128, 256, 512)
    for bn, bk in ((128, 128), (256, 128))
) + tuple(
    KernelConfig(block_m=bm, n_span=s, k_span=s)
    for bm in (128, 256, 512)
    for s in WGRAD_SPANS
)


def candidate_pool(k: int, n: int,
                   pool: Optional[Iterable[KernelConfig]] = None,
                   require_transposable: bool = True,
                   family: str = "gemm"
                   ) -> "tuple[KernelConfig, ...]":
    """Pool entries legal for this (K, N): never empty for 128-aligned
    shapes; falls back to the per-device default otherwise.

    ``require_transposable`` (default) additionally demands legality for
    the transposed (N, K) orientation: the fp8 backward runs the dgrad
    through the same config against ``w^T``.  ``family="wgrad"`` demands
    divisibility by the whole (k_span*block_k, n_span*block_n) super-tile.
    """
    def legal(c):
        return c.compatible(k, n, family) and (
            not require_transposable or c.compatible(n, k, family))

    cands = tuple(c for c in (tuple(pool) if pool is not None else CONFIG_POOL)
                  if legal(c))
    if not cands:
        d = KernelConfig.default()
        cands = (d,) if legal(d) else ()
    return cands


# ---------------------------------------------------------------------------
# Roofline cost model of the card
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    name: str
    peak_flops: float      # dense bf16 tensor-core FLOP/s
    hbm_bw: float          # bytes/s
    hbm_bytes: float       # device memory
    # rows one MMA pass computes whatever a tile holds: 64 for Hopper's
    # wgmma (one warpgroup), 128 for a TPU-shaped spec (the MXU)
    mma_m: int
    # shared memory a CTA may use (resources.BUDGETS)
    smem_bytes: int = _resources.smem_budget("nvidia h100")


_H100 = dict(peak_flops=989e12, hbm_bw=3.35e12, hbm_bytes=80e9, mma_m=64,
             smem_bytes=_resources.smem_budget("nvidia h100"))
DEVICE_SPECS = {
    # NVIDIA's data sheet, H100 SXM: dense bf16, HBM3
    "nvidia h100": DeviceSpec("nvidia h100", **_H100),
    # the CPU runs the plain versions; it carries the H100's numbers so
    # selections ranked there transfer to the card
    "cpu": DeviceSpec("cpu", **_H100),
}


def device_spec(device_kind: Optional[str] = None) -> DeviceSpec:
    kind = (device_kind or _device_kind()).lower()
    for prefix in ("nvidia h100", "cpu"):
        if kind.startswith(prefix):
            return DEVICE_SPECS[prefix]
    return DEVICE_SPECS["cpu"]


def _eff_rows(block_m: int, mma_m: int) -> int:
    """Rows a tile of ``block_m`` costs on the MMA unit: a partial pass
    costs a whole one, so compute time per visit is flat below ``mma_m``
    (the term that confines the decode entries to tiny M, where their
    memory-traffic savings are real)."""
    return -(-block_m // mma_m) * mma_m


def estimate_cost_s(m: int, k: int, n: int, g: int, config: KernelConfig,
                    spec: Optional[DeviceSpec] = None,
                    quant_output: bool = False,
                    precision: str = "fp8") -> float:
    """Roofline estimate of one grouped GEMM under ``config``: max of the
    compute and memory terms, with the visit inflation the plan implies
    (worst case: every group boundary splits a tile, +G-1 visits).
    Compute charges MMA occupancy (``_eff_rows``); memory charges the
    bytes actually moved.  ``quant_output`` models the quantizing store
    (``op="gemm_quant"``): fp8 payload + f32 1x128 scale rows instead of
    the bf16 C.  ``precision="bf16"`` models the bf16 kernel: 2-byte
    operands, no scales."""
    spec = spec or device_spec()
    bm, bn = config.block_m, config.block_n
    num_tiles = -(-m // bm)
    visits = num_tiles + max(g - 1, 0)
    n_steps = -(-n // bn)
    kb = -(-k // QUANT_BLOCK)
    nb = -(-n // QUANT_BLOCK)
    # every visit computes a full (bm, k) x (k, n) tile row
    flops = 2.0 * visits * _eff_rows(bm, spec.mma_m) * k * n
    if precision == "bf16":
        a_bytes = visits * n_steps * bm * k * 2        # bf16 A, no scales
        b_bytes = visits * k * n * 2                   # bf16 B per visit
    else:
        a_bytes = visits * n_steps * bm * (k + 4 * kb)  # fp8 A + f32 S_A
        b_bytes = visits * k * n                        # fp8 B per visit
    if quant_output:
        c_bytes = num_tiles * bm * (n + 4 * nb)        # fp8 C + f32 scales
    else:
        c_bytes = num_tiles * bm * n * 2               # bf16 C flush
    return max(flops / spec.peak_flops,
               (a_bytes + b_bytes + c_bytes) / spec.hbm_bw)


def wgrad_operand_bytes(m: int, k: int, n: int, g: int,
                        config: KernelConfig,
                        precision: str = "bf16") -> int:
    """Modeled operand bytes of one wgrad pass (x + dy fetches; the dw
    flush is schedule-independent and excluded).  Single-tile, each visit
    walks every (k, n) cell, fetching x on every N step and dy on every K
    step; a ``(k_span, n_span)`` super-tile keeps each operand tile across
    its span, so at full span each operand tile is fetched once a visit.
    With ``precision="fp8"`` the payloads are 1-byte and each walk step
    also fetches the f32 1x128 scale rows of its tiles."""
    bm = config.block_m
    visits = -(-m // bm) + max(g - 1, 0)
    k_steps = -(-k // config.block_k)
    n_steps = -(-n // config.block_n)
    k_groups = -(-k_steps // config.k_span)
    n_groups = -(-n_steps // config.n_span)
    if precision == "fp8":
        kb = -(-k // QUANT_BLOCK)
        nb = -(-n // QUANT_BLOCK)
        x_bytes = visits * n_groups * bm * k              # fp8 payload
        dy_bytes = visits * k_groups * bm * n
        scale_bytes = visits * k_groups * n_groups * bm * 4 * (kb + nb)
        return int(x_bytes + dy_bytes + scale_bytes)
    x_bytes = visits * n_groups * bm * k * 2              # bf16 payload
    dy_bytes = visits * k_groups * bm * n * 2
    return int(x_bytes + dy_bytes)


def estimate_cost_s_wgrad(m: int, k: int, n: int, g: int,
                          config: KernelConfig,
                          spec: Optional[DeviceSpec] = None,
                          precision: str = "bf16") -> float:
    """Roofline estimate of the ragged-contraction (wgrad) grouped GEMM
    ``dw[g] = x_g^T @ dy_g`` under ``config``: the forward's visit
    inflation, :func:`wgrad_operand_bytes` of operand traffic and one f32
    ``[G, K, N]`` dw flush."""
    spec = spec or device_spec()
    bm = config.block_m
    visits = -(-m // bm) + max(g - 1, 0)
    flops = 2.0 * visits * _eff_rows(bm, spec.mma_m) * k * n
    operand_bytes = wgrad_operand_bytes(m, k, n, g, config,
                                        precision=precision)
    dw_bytes = g * k * n * 4                             # f32 dw flush
    return max(flops / spec.peak_flops,
               (operand_bytes + dw_bytes) / spec.hbm_bw)


def estimate_cost_s_quantize(m: int, k: int, config: KernelConfig,
                             spec: Optional[DeviceSpec] = None) -> float:
    """Roofline estimate of one 1x128 tilewise quantization pass (tile
    height ``block_m``): memory-bound, read the f32 payload, write fp8 +
    f32 scale rows; the grid term models per-tile dispatch overhead."""
    spec = spec or device_spec()
    tiles = -(-m // config.block_m)
    kb = -(-k // QUANT_BLOCK)
    bytes_moved = m * k * 4 + m * k * 1 + m * kb * 4
    return bytes_moved / spec.hbm_bw + tiles * 1e-6


def estimate_cost_s_act_quant(m: int, k: int, config: KernelConfig,
                              spec: Optional[DeviceSpec] = None) -> float:
    """Roofline estimate of one fused activation->quantize pass
    (``op="act_quant"``): reads the gate and up outputs (bf16), writes
    fp8 payload + f32 scale rows; the grid term as in
    :func:`estimate_cost_s_quantize`."""
    spec = spec or device_spec()
    tiles = -(-m // config.block_m)
    kb = -(-k // QUANT_BLOCK)
    bytes_moved = 2 * m * k * 2 + m * k * 1 + m * kb * 4
    return bytes_moved / spec.hbm_bw + tiles * 1e-6


# ---------------------------------------------------------------------------
# Persistent autotune cache (the port's own file)
# ---------------------------------------------------------------------------

_CACHE_VERSION = 1
_cache_mem: "dict[str, dict[str, dict]]" = {}   # path -> entries

#: environment variable naming the cache file
CACHE_ENV = "REPRO_TORCH_TILEPLAN_CACHE"


def default_cache_path() -> str:
    return os.environ.get(
        CACHE_ENV, os.path.join(os.path.expanduser("~"), ".cache",
                                "repro_torch", "tileplan_cache.json"))


def _m_bucket(m: int) -> int:
    """Paper-flavoured log2 bucketing: shapes in the same power-of-two M
    band share a tuned config."""
    b = 1
    while b < max(m, 1):
        b *= 2
    return b


def cache_key(device_kind: str, backend: str, m: int, k: int, n: int,
              g: int, op: str = "gemm") -> str:
    """Cache key for one (device, backend, shape-class, op) selection;
    ops other than ``"gemm"`` append ``|<op>``.  Every key is namespaced
    by the resource model's version (``|rm<N>``): selections made under
    an older model are re-tuned, and entries of an old format never match
    (and survive a save)."""
    suffix = "" if op == "gemm" else f"|{op}"
    return (f"{device_kind}|{backend}|M{_m_bucket(m)}|K{k}|N{n}|G{g}{suffix}"
            f"|rm{_resources.RESOURCE_MODEL_VERSION}")


def _read_cache_file(path: str) -> "dict[str, dict]":
    """The entries of the cache file at ``path``; none where it is
    missing, unreadable, not JSON or of another format version."""
    try:
        with open(path) as f:
            text = f.read()
    except OSError:
        return {}
    try:
        raw = json.loads(text)
    except ValueError:
        return {}
    if isinstance(raw, dict) and raw.get("version") == _CACHE_VERSION:
        return dict(raw.get("entries", {}))
    return {}


def load_cache(path: Optional[str] = None) -> "dict[str, dict]":
    path = path or default_cache_path()
    if path not in _cache_mem:
        _cache_mem[path] = _read_cache_file(path)
    return _cache_mem[path]


def save_cache(entries: "dict[str, dict]",
               path: Optional[str] = None) -> None:
    path = path or default_cache_path()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    # merge with whatever is on disk now: processes tuning different
    # shapes must not drop each other's entries; ours win on collisions
    merged = {**_read_cache_file(path), **entries}
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump({"version": _CACHE_VERSION, "entries": merged}, f,
                  indent=1, sort_keys=True)
    os.replace(tmp, path)
    _cache_mem[path] = merged


def clear_cache_memo() -> None:
    """Drop the in-process cache view (tests; does not touch the file)."""
    _cache_mem.clear()


# ---------------------------------------------------------------------------
# Autotuner: measured pool selection on the card
# ---------------------------------------------------------------------------

# autotune op -> (resource-model family, operand precision).  THE op list:
# cache-key suffixes, candidate legality, pruning and the cost-model
# switch in autotune() all derive from these keys
_AUTOTUNE_OPS = {
    "gemm": ("gemm", "fp8"),
    "gemm_bf16": ("gemm", "bf16"),
    "decode": ("gemm", "fp8"),        # tiny-M serving shapes, decode pool
    "gemm_quant": ("gemm_quant", "fp8"),
    "wgrad": ("wgrad", "bf16"),
    "wgrad_fp8": ("wgrad", "fp8"),
    "quantize": ("quantize", "fp8"),
    "act_quant": ("act_quant", "fp8"),
}
#: ops whose CUDA kernel takes no tile parameter: B1 and B3 have none,
#: and the wgrads' walk (csrc/wgrad_tile.cuh) takes 64 contracted rows a
#: stage whatever block_m is
TILE_FREE_OPS = ("quantize", "act_quant", "wgrad", "wgrad_fp8")
#: the ops the padded baseline runs (its fp8 GEMMs)
_PADDED_OPS = ("gemm", "decode", "gemm_quant")

# how many pool entries static pruning eliminated this process, per op
_PRUNE_STATS: "dict[str, int]" = {}
# full report of the most recent autotune() call
_LAST_REPORT: "dict[str, Any]" = {}


def prune_stats() -> "dict[str, int]":
    """Per-op count of statically pruned pool entries this process."""
    return dict(_PRUNE_STATS)


def reset_prune_stats() -> None:
    _PRUNE_STATS.clear()


def last_autotune_report() -> "dict[str, Any]":
    """The most recent autotune() call's report: op, cache key,
    cache_hit, pruned [(config dict, reason)], skipped [(config dict,
    reason)] from the measurement loop, candidates [(config dict,
    predicted seconds, measured seconds or None)] in rank order, and the
    winning source."""
    return dict(_LAST_REPORT)


def op_ignores_tiles(op: str, device: torch.device) -> bool:
    """Whether ``op``'s timing cannot depend on the tile shape on
    ``device``: on the CPU the plain versions run; on the card the ops of
    :data:`TILE_FREE_OPS`.  Tile-free ops are ranked by the cost model
    and never measured."""
    return device.type != "cuda" or op in TILE_FREE_OPS


def backend_name(op: str, backend: Optional[str],
                 device: torch.device) -> str:
    """The backend part of the cache key: ``"padded_baseline"`` for the
    baseline's GEMMs, else ``"cuda"`` (the kernels) or ``"plain"`` (their
    PyTorch versions, on the CPU); the fp8 wgrad appends ``_fp8``."""
    if backend == PADDED_BASELINE and op in _PADDED_OPS:
        name = PADDED_BASELINE
    else:
        name = "cuda" if device.type == "cuda" else "plain"
    return name + ("_fp8" if op == "wgrad_fp8" else "")


def _prune_infeasible(cands, op: str, m: int, k: int, n: int,
                      spec: DeviceSpec):
    """Drop statically infeasible candidates before ranking and measuring.
    Returns ``(kept, pruned)`` with ``pruned`` as (config, reason) pairs.
    Where every candidate is pruned, those pruned only for a degenerate
    grid stand (a tiny M makes every built tile degenerate); where none
    is, the original pool stands (selection must not dead-end)."""
    family, prec = _AUTOTUNE_OPS[op]
    kept, pruned = [], []
    for c in cands:
        reason = _resources.infeasible_reason(
            family, c, m, k, n, smem_bytes=spec.smem_bytes,
            wgrad_precision=prec if family == "wgrad" else None,
            gemm_precision=prec if family == "gemm" else None)
        if reason is None:
            kept.append(c)
        else:
            pruned.append((c, reason))
    if not kept:
        kept = [c for c, r in pruned if r.startswith("degenerate")]
        pruned = [(c, r) for c, r in pruned if not r.startswith("degenerate")]
    if not kept:
        return tuple(cands), []
    return tuple(kept), pruned


def _measure_candidate(config: KernelConfig, m: int, k: int, n: int, g: int,
                       *, op: str, device: torch.device, seed: int = 0,
                       iters: int = 5, reps: int = 10,
                       warmup: int = 3) -> float:
    """Median seconds of one application of ``op`` under ``config`` on
    seeded operands on the card: ``iters`` windows of ``reps`` back-to-back
    calls, each timed by CUDA events, after ``warmup`` calls.  The grouped
    GEMMs (``"gemm"``, ``"decode"``, ``"gemm_quant"``, ``"gemm_bf16"``)
    run their CUDA entry points on a plan built beforehand (a layer plans
    once for all its GEMMs); under the padded baseline, its whole
    pipeline (which plans per call).  Tile-free ops are never measured."""
    import numpy as np
    from repro_torch.core import padding_baseline
    from repro_torch.kernels import grouped_gemm_kernel as gk
    from repro_torch.kernels import quant_kernel, ref

    if device.type != "cuda":
        raise ValueError(f"measurement needs a CUDA device, got {device}")
    if op in TILE_FREE_OPS:
        raise ValueError(f"op {op!r} is tile-free: ranked by the cost "
                         "model, never measured")
    rng = np.random.default_rng(seed)
    sizes = rng.multinomial(m, np.full(g, 1.0 / g)).astype(np.int32)
    gs = torch.from_numpy(sizes).to(device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    tiles = dict(num_groups=g, block_m=config.block_m,
                 block_n=config.block_n, block_k=config.block_k)
    padded = config.backend == PADDED_BASELINE and op in _PADDED_OPS
    plan = None if padded else make_tile_plan(gs, m, block_m=config.block_m,
                                              num_groups=g)
    if op == "gemm_bf16":
        x = randn(m, k).bfloat16()
        w = (randn(g, k, n) * k ** -0.5).bfloat16()

        def run():
            return gk.gmm_bf16(x, w, gs, plan=plan, **tiles)
    else:
        a8, sa = ref.quantize_tilewise_ref(randn(m, k))
        b8, sb = ref.quantize_blockwise_ref(randn(g, k, n) * k ** -0.5)
        if padded:
            def run():
                y = padding_baseline.grouped_gemm_fp8_padded(
                    a8, sa, b8, sb, gs, config=config)
                if op == "gemm_quant":
                    return quant_kernel.quantize_tilewise(y.float())
                return y
        elif op == "gemm_quant":
            def run():
                return gk.gmm_quant(a8, sa, b8, sb, gs, plan=plan, **tiles)
        else:
            def run():
                return gk.gmm(a8, sa, b8, sb, gs, plan=plan, **tiles)

    with torch.cuda.device(device):
        for _ in range(warmup):
            run()
        torch.cuda.synchronize(device)
        times = []
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                run()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / reps / 1e3)
    return statistics.median(times)


def _cost_fn(op: str):
    """The roofline estimate ``cost(m, k, n, g, config, spec)`` of ``op``."""
    if op in ("gemm", "decode"):
        return estimate_cost_s
    if op == "gemm_bf16":
        return lambda m, k, n, g, c, s: estimate_cost_s(
            m, k, n, g, c, s, precision="bf16")
    if op == "gemm_quant":
        return lambda m, k, n, g, c, s: estimate_cost_s(
            m, k, n, g, c, s, quant_output=True)
    if op == "quantize":
        return lambda m, k, n, g, c, s: estimate_cost_s_quantize(m, k, c, s)
    if op == "act_quant":
        return lambda m, k, n, g, c, s: estimate_cost_s_act_quant(m, k, c, s)
    prec = "fp8" if op == "wgrad_fp8" else "bf16"
    return lambda *a: estimate_cost_s_wgrad(*a, precision=prec)


def autotune(m: int, k: int, n: int, g: int, *,
             backend: Optional[str] = None,
             pool: Optional[Iterable[KernelConfig]] = None,
             cache_path: Optional[str] = None,
             measure: bool = True,
             max_candidates: int = 4,
             refresh: bool = False,
             seed: int = 0,
             op: str = "gemm",
             device=None) -> KernelConfig:
    """Select a ``KernelConfig`` for the shape class of (M, K, N, G).

    ``op`` is a key of :data:`_AUTOTUNE_OPS`: ``"gemm"`` (B2, the
    forward/dgrad orientation), ``"gemm_bf16"`` (B5), ``"decode"`` (B2 at
    serving's tiny constant M, the decode pool), ``"gemm_quant"`` (B7),
    ``"wgrad"`` / ``"wgrad_fp8"`` (B4 / B6), ``"quantize"`` (B1) and
    ``"act_quant"`` (B3; both K-only, pass N = G = 0).  Each ranks by its
    own roofline terms and caches under its own key.

    Pool candidates are pruned by the resource model, ranked by the cost
    model, the top ``max_candidates`` are measured on ``device`` (the
    card unless a CPU device is passed; skipped with ``measure=False``
    and for tile-free ops), and the winner is persisted to the JSON cache
    so later calls and processes reuse it without measuring.  A
    candidate whose measurement raises is skipped with its reason; if
    all do, the cost model's first stands.  ``backend`` is the config's:
    None (the kernels) or ``"padded_baseline"``.
    """
    if op not in _AUTOTUNE_OPS:
        raise ValueError(f"unknown autotune op {op!r}; use one of "
                         f"{tuple(_AUTOTUNE_OPS)}")
    check_backend(backend)
    dev = resolve_device(device)
    family = _AUTOTUNE_OPS[op][0]
    tile_free = op_ignores_tiles(op, dev)
    kind = device_kind(dev)
    key = cache_key(kind, backend_name(op, backend, dev), m, k, n, g, op=op)
    entries = load_cache(cache_path)
    if not refresh and key in entries:
        entry = entries[key]
        # a cost-model-only entry does not satisfy a measured request:
        # upgrade it (tile-free ops never measure, so theirs stand)
        if entry.get("source") == "measured" or not (measure
                                                     and not tile_free):
            _LAST_REPORT.clear()
            _LAST_REPORT.update(op=op, key=key, cache_hit=True, pruned=[],
                                skipped=[], candidates=[],
                                source=entry.get("source"))
            return KernelConfig.from_dict(entry["config"])

    if pool is None and op == "decode":
        pool = DECODE_POOL
    # the forward orientations also run transposed (the dgrad, under the
    # same config); the wgrad only its own; the quantizers have no (K, N)
    # output tile
    cands = candidate_pool(
        k, n, pool,
        require_transposable=op in ("gemm", "gemm_bf16", "decode",
                                    "gemm_quant"),
        family=family)
    if op not in ("wgrad", "wgrad_fp8"):
        # the spans exist for the wgrad only: every span>1 entry repeats
        # its span-1 base for the other ops
        cands = tuple(c for c in cands if c.n_span == 1 and c.k_span == 1)
    if op in ("quantize", "act_quant"):
        # one entry per tile height: (block_n, block_k) mean nothing here
        seen, uniq = set(), []
        for c in cands:
            if c.block_m not in seen:
                seen.add(c.block_m)
                uniq.append(c)
        cands = tuple(uniq)
    if not cands:
        raise ValueError(f"no pool candidate is legal for K={k}, N={n}")
    spec = device_spec(kind)
    cands, pruned = _prune_infeasible(cands, op, m, k, n, spec)
    if pruned:
        _PRUNE_STATS[op] = _PRUNE_STATS.get(op, 0) + len(pruned)
        for c, reason in pruned:
            logger.info("autotune[%s] statically pruned block_m=%d,"
                        "block_n=%d,block_k=%d: %s", op, c.block_m,
                        c.block_n, c.block_k, reason)
    cost = _cost_fn(op)
    if op in ("wgrad", "wgrad_fp8"):
        # secondary key: modeled operand bytes (the roofline max() ties
        # across span widths on compute-bound shapes)
        prec = _AUTOTUNE_OPS[op][1]
        ranked = sorted(cands, key=lambda c: (
            cost(m, k, n, g, c, spec),
            wgrad_operand_bytes(m, k, n, g, c, precision=prec)))
    else:
        ranked = sorted(cands, key=lambda c: cost(m, k, n, g, c, spec))
    overrides = {"backend": backend}
    if op == "wgrad_fp8":
        overrides["wgrad_precision"] = "fp8"
    ranked = [c.with_(**overrides) for c in ranked]
    predicted = {c: cost(m, k, n, g, c, spec) for c in ranked}

    skipped: "list[tuple[KernelConfig, str]]" = []
    measured: "dict[KernelConfig, float]" = {}
    if measure and not tile_free:
        _events.emit("autotune_measure", op=op, key=key)
        # a candidate that fails to launch or measure is recorded and
        # skipped; it must not abort the sweep
        for c in ranked[:max_candidates]:
            try:
                measured[c] = _measure_candidate(c, m, k, n, g, seed=seed,
                                                 op=op, device=dev)
            except Exception as exc:  # noqa: BLE001 - the sweep must survive
                reason = f"{type(exc).__name__}: {exc}"
                skipped.append((c, reason))
                logger.warning("autotune[%s] measurement of block_m=%d,"
                               "block_n=%d,block_k=%d failed, skipping: %s",
                               op, c.block_m, c.block_n, c.block_k, reason)
    if measured:
        best = min(measured, key=measured.get)
        best_s, source = measured[best], "measured"
    else:
        # tile-free, measure=False, or every measurement failed: the
        # cost-model order is the selection
        best = ranked[0]
        best_s, source = predicted[best], "cost_model"

    entries[key] = {"config": best.to_dict(), "seconds": best_s,
                    "source": source, "pool_size": len(cands), "op": op,
                    "pruned": len(pruned),
                    "skipped": [{"config": c.to_dict(), "reason": r}
                                for c, r in skipped]}
    _LAST_REPORT.clear()
    _LAST_REPORT.update(
        op=op, key=key, cache_hit=False,
        pruned=[(c.to_dict(), r) for c, r in pruned],
        skipped=[(c.to_dict(), r) for c, r in skipped],
        candidates=[(c.to_dict(), predicted[c], measured.get(c))
                    for c in ranked],
        source=source)
    save_cache(entries, cache_path)
    return best


def decode_config(m: int, k: int, n: int, g: int, *,
                  backend: Optional[str] = None,
                  cache_path: Optional[str] = None,
                  measure: bool = False,
                  device=None,
                  **kw) -> KernelConfig:
    """Decode pool selection (``op="decode"``): the serving engine's
    per-step grouped GEMM has tiny, *constant* M (batch x top_k rows in
    all), so selection runs once at engine construction and the returned
    ``block_m<=16`` config rides every decode step.  Cost-model selection
    by default (``measure=False``): engine construction does not wait on
    kernel timing; pass ``measure=True`` to tune on the card.  Emits one
    ``decode_select`` event."""
    _events.emit("decode_select", m=m, k=k, n=n, g=g)
    return autotune(m, k, n, g, backend=backend, cache_path=cache_path,
                    measure=measure, op="decode", device=device, **kw)
