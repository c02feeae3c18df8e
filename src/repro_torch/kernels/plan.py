"""TilePlan subsystem: the grouped GEMM's tile shapes and visit schedule.

``KernelConfig``
    One frozen record of the tile-shape decisions (``block_m/n/k``), the
    grouped GEMM's backend, the output dtype of a grouped GEMM, the
    operand precision of the training step's wgrad and whether the fp8
    FFN's gate/up GEMMs quantize in their store (``fuse_producer``).
    Static alignment constraints are checked at construction, the
    shape-dependent ones by :meth:`KernelConfig.validate`.
    ``config=None`` call sites resolve to :func:`get_default_config`,
    which the trainer scopes with :func:`default_config`.

``TilePlan``
    The visitation schedule (``group_offsets/group_ids/m_tile_ids``) the
    padding-free kernel walks.  It depends only on ``(group_sizes, m,
    block_m)``, so one MoE layer application builds it once per routing
    decision and reuses it for every GEMM that shares those group sizes.

The schedule is built with tensor ops on the device of ``group_sizes``:
building it never waits for the device.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch

from repro_torch.analysis import events as _events

QUANT_BLOCK = 128  # the paper's 1x128 / 128x128 quantization granularity

#: the backend of the paper's baseline: pad every group to ``block_m``,
#: run the same grouped GEMM over the padded buffer, unpad
#: (:mod:`repro_torch.core.padding_baseline`)
PADDED_BASELINE = "padded_baseline"
#: the JAX package's other registry names (and the ``xla`` alias); the
#: port has no operator registry yet, so these raise
UNPORTED_BACKENDS = ("pallas", "pallas_interpret", "xla_ragged", "xla_exact",
                     "xla", "ref")


def check_backend(backend: Optional[str]) -> None:
    """Pass the backends the port runs: ``None`` (its own kernels on the
    card, their plain versions on the CPU) and ``"padded_baseline"``.  A
    registry name of the JAX package (also spelled with ``_fp8``) raises
    ``NotImplementedError``, any other name ``ValueError``."""
    if backend is None or backend == PADDED_BASELINE:
        return
    base = backend[:-len("_fp8")] if backend.endswith("_fp8") else backend
    if base in UNPORTED_BACKENDS:
        raise NotImplementedError(
            f"backend {backend!r}: the operator registry "
            "(kernels/dispatch.py) is not ported to repro_torch yet "
            f"(ROADMAP A12/A13); the port runs None and {PADDED_BASELINE!r}")
    raise ValueError(f"unknown backend {backend!r}; the port runs None and "
                     f"{PADDED_BASELINE!r}")


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
        check_backend(self.backend)

    def validate(self, m: int, k: int, n: int, *,
                 family: str = "gemm") -> "KernelConfig":
        """Shape-dependent constraints.  M is deliberately unconstrained:
        handling arbitrary (ragged) M without padding is the point of the
        paper.  ``family="wgrad"``: K and N are the output's [K, N] tile
        axes, and must be multiples of 128 (the 1x128 scales of the fp8
        operands run along them)."""
        if family not in ("gemm", "wgrad"):
            raise ValueError(f"unknown family {family!r}")
        if k % self.block_k != 0:
            raise ValueError(f"K={k} must be a multiple of block_k={self.block_k}")
        if n % self.block_n != 0:
            raise ValueError(f"N={n} must be a multiple of block_n={self.block_n}")
        if family == "wgrad" and (k % QUANT_BLOCK or n % QUANT_BLOCK):
            raise ValueError(f"wgrad needs K={k} and N={n} to be multiples "
                             f"of {QUANT_BLOCK}")
        return self

    def with_(self, **kw) -> "KernelConfig":
        return dataclasses.replace(self, **kw)


# the config ``config=None`` call sites resolve to, while a
# :func:`default_config` scope is open
_default_config: Optional[KernelConfig] = None


def get_default_config() -> KernelConfig:
    return _default_config if _default_config is not None else KernelConfig()


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
                   out_dtype: Optional[torch.dtype] = None) -> KernelConfig:
    """Effective config for a call site: the explicit ``config`` or the
    default one, with per-call ``backend`` and ``out_dtype`` overrides on
    top.  ``backend="auto"`` sets the config's backend back to None."""
    cfg = config if config is not None else get_default_config()
    if backend is not None:
        cfg = cfg.with_(backend=None if backend == "auto" else backend)
    if out_dtype is not None:
        cfg = cfg.with_(out_dtype=out_dtype)
    return cfg


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
    dev = group_sizes.device
    sizes = group_sizes.to(torch.int64)
    group_offsets = torch.cat(
        [torch.zeros(1, dtype=torch.int64, device=dev), torch.cumsum(sizes, 0)])
    starts = group_offsets[:-1]
    ends = group_offsets[1:]
    first_tile = torch.div(starts, block_m, rounding_mode="floor")
    last_tile_excl = torch.div(ends + block_m - 1, block_m,
                               rounding_mode="floor")
    tiles_per = torch.clamp(last_tile_excl - first_tile, min=0)
    # zero-size groups get zero visits (even when their offset is unaligned)
    tiles_per = torch.where(sizes == 0, torch.zeros_like(tiles_per), tiles_per)

    num_tiles = (m + block_m - 1) // block_m
    max_visits = max(num_tiles + num_groups - 1, 1)

    visit_ends = torch.cumsum(tiles_per, 0)                      # [G]
    t = torch.arange(max_visits, dtype=torch.int64, device=dev)
    num_real = visit_ends[-1]
    t_clamped = torch.clamp(torch.minimum(t, num_real - 1), min=0)
    group_ids = torch.searchsorted(visit_ends, t_clamped, right=True)
    group_ids = torch.clamp(group_ids, max=num_groups - 1)
    visits_before = torch.cat(
        [torch.zeros(1, dtype=torch.int64, device=dev), visit_ends[:-1]])
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
        block_m = (config or KernelConfig()).block_m
    num_groups = num_groups if num_groups is not None else group_sizes.shape[0]
    offsets, group_ids, m_tile_ids = make_group_metadata(
        group_sizes, m, block_m, num_groups)
    return TilePlan(offsets, group_ids, m_tile_ids, m=int(m),
                    block_m=int(block_m), num_groups=int(num_groups))
