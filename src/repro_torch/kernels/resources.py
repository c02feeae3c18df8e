"""Static kernel-resource model of the port's CUDA kernels on Hopper.

The paper's second pillar is *static* TMA-alignment-aware management:
every descriptor's tile geometry is decided before launch, against known
alignment (16-byte global rows, 128-byte shared boxes) and shared-memory
budgets.  This module is that model for the port's hand-written kernels
on an NVIDIA H100: pure arithmetic over what one CTA of each kernel
holds, mirroring the constants of its source.

* shared memory a CTA (dynamic, what the launch asks for):
  - B2 / B7 (``csrc/grouped_gemm.cu``, ``Shape<BM>::kSmem``): a ring of
    e4m3 stages (the A boxes of 64 or 16 rows and a 128x128 B tile), two
    f16 B tiles that also stage the output, the barriers;
  - B5 (``csrc/gmm_bf16.cu``, ``smem_bytes<BM, NC, OutT>``): a 4-stage
    ring of bf16 A slabs and B tiles, the staged output piece;
  - B4 (``csrc/wgrad_bf16.cu``) and B6 (``csrc/wgrad.cu``): their rings,
    B6's widened buffers, the staged 128x128 dw tile;
  - B8 (``csrc/flash_attention.cu``, ``Cfg<D>::kSmem``): q and o tiles,
    the k and v rings;
  - B1 (``csrc/quant.cu``) and B3 (``csrc/act_quant.cu``): none;
* threads a CTA (``kThreads`` or ``__launch_bounds__``) and the CTAs an
  SM is meant to hold (the bounds' second argument);
* the budgets (:data:`BUDGETS`): 232448 B of shared memory a CTA, 228 KB
  an SM (1 KB of it reserved a CTA), 65536 registers an SM;
* which tile shapes were built: B2, B5 and B7 take ``block_m`` 8, 16,
  64, 128, 256 and 512 and ``block_n`` 128 or 256 (``block_k`` 128) as
  runtime arguments of two instances each (``csrc/tile_geom.cuh``): the
  decode instance (block_m 8 and 16, pieces of ``block_m`` rows) and the
  tall instance (block_m 64 to 512, pieces of at most 128 rows); a
  visit's tile is walked as ``block_m / rows`` sub-tiles by ``block_n /
  128`` halves, and its store pool holds ``log2(rows) + 1`` descriptors
  (heights 1 .. rows: 4 at block_m 8, 5 at 16, 7 at 64, 8 from 128 on,
  since a store is no taller than the staged piece).  The wgrads (B4,
  B6) sum 128x128 sub-tiles, walk the contracted rows 64 at a time
  whatever ``block_m`` is, and take the pool's four wgrad geometries
  (:data:`WGRAD_GEOMETRIES`): span 1 at ``block_n`` 128 (one CTA a
  tile) and 256, and ``n_span = k_span`` 2 and 4 at ``block_n`` 128,
  each super-tile on a thread-block cluster of CTAs that share operand
  stages by TMA multicast (:func:`wgrad_cluster`; span 4 as one 16-CTA
  cluster, a non-portable size the H100 holds 7 of at once).  Any other
  geometry gets a "no CUDA variant" reason.

A geometry that was not built is still costed by its kernel's template
arithmetic, so :meth:`~repro_torch.kernels.plan.KernelConfig.validate`
can say how many bytes it would need.  Consumers:
``plan.autotune`` prunes candidates with :func:`infeasible_reason`
(each with its reason, nothing dropped silently), ``KernelConfig.validate``
budget-checks with :func:`footprint`, and ``chip_smoke.py`` holds
:func:`variants` against each kernel library's own ``kernel_resources``
query on the card.

Stdlib-only: no torch import, so the budget math runs anywhere.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

#: bump when the formulas, budgets or built geometries change: the
#: autotune JSON cache namespaces its keys by this (``|rm<N>``), so
#: selections made under an older model are ignored rather than trusted
RESOURCE_MODEL_VERSION = 3

QUANT_BLOCK = 128   # 1x128 / 128x128 scale granularity
SWIZZLE_BYTES = 128  # a shared box row in the 128-byte swizzle
TMA_ROW_ALIGN = 16   # a TMA tensor map's global row stride, in bytes
MMA_ROWS = 8         # rows of an MMA fragment group (wgmma: 64 = 8 x 8)

#: per-device budgets, by device-kind prefix.  The "cpu" entry carries
#: the H100's, so selections ranked on the CPU transfer to the card.
BUDGETS: "Dict[str, Dict[str, int]]" = {
    "nvidia h100": {"smem_per_cta": 232448, "smem_per_sm": 233472,
                    "smem_reserved_per_cta": 1024, "regs_per_sm": 65536,
                    "max_regs_per_thread": 255, "sms": 132},
    "cpu": {"smem_per_cta": 232448, "smem_per_sm": 233472,
            "smem_reserved_per_cta": 1024, "regs_per_sm": 65536,
            "max_regs_per_thread": 255, "sms": 132},
}

#: footprint-modelled operator families (the autotuner's ``_AUTOTUNE_OPS``
#: map onto these)
FAMILIES = ("gemm", "gemm_quant", "wgrad", "quantize", "act_quant")

#: tile heights the CUDA grouped GEMMs (B2, B5, B7) take: the JAX
#: package's pool
CUDA_BLOCK_MS = (8, 16, 64, 128, 256, 512)
#: their output tile widths
CUDA_BLOCK_NS = (128, 256)
#: the K tile of every CUDA GEMM, and the K and N tile of the wgrads
CUDA_TILE_NK = 128
#: the wgrads' geometries, ``(block_n, n_span, k_span)``: the JAX
#: package's pool (its span entries are at block_n 128)
WGRAD_GEOMETRIES = ((128, 1, 1), (256, 1, 1), (128, 2, 2), (128, 4, 4))
#: the most rows of one piece: the decode instance's (block_m <= 16) and
#: the tall instance's (``csrc/tile_geom.cuh``)
SMALL_PIECE_ROWS = 16
PIECE_ROWS = 128


def budgets(device_kind: str) -> "Dict[str, int]":
    """The budgets of a device kind, longest-prefix matched (an unknown
    kind gets the "cpu" entry, the H100's numbers)."""
    kind = device_kind.lower()
    best = None
    for prefix, b in BUDGETS.items():
        if kind.startswith(prefix) and (best is None or len(prefix) > best[0]):
            best = (len(prefix), b)
    return dict(best[1] if best is not None else BUDGETS["cpu"])


def smem_budget(device_kind: str) -> int:
    """Shared memory one CTA may use on ``device_kind``."""
    return budgets(device_kind)["smem_per_cta"]


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def config_blocks(config: Any) -> "Tuple[int, int, int]":
    """``(block_m, block_n, block_k)`` from a KernelConfig-like object or
    a plain dict (a misaligned geometry cannot construct a KernelConfig)."""
    if isinstance(config, dict):
        return (int(config["block_m"]), int(config.get("block_n", 128)),
                int(config.get("block_k", 128)))
    return (int(config.block_m), int(config.block_n), int(config.block_k))


def config_spans(config: Any) -> "Tuple[int, int]":
    """``(n_span, k_span)`` from a KernelConfig-like object or a dict;
    absent fields mean the single-tile schedule."""
    if isinstance(config, dict):
        return (int(config.get("n_span", 1)), int(config.get("k_span", 1)))
    return (int(getattr(config, "n_span", 1)),
            int(getattr(config, "k_span", 1)))


# ---------------------------------------------------------------------------
# Per-kernel shared memory, threads and CTAs an SM (each kernel's source)
# ---------------------------------------------------------------------------

def _barriers(n: int) -> int:
    return 8 * n


def instance_rows(block_m: int) -> int:
    """The instance a grouped GEMM at ``block_m`` runs on, by the most
    rows of one piece: 16 (block_m 8 and 16) or 128."""
    return SMALL_PIECE_ROWS if block_m <= SMALL_PIECE_ROWS else PIECE_ROWS


def piece_rows(block_m: int) -> int:
    """Rows of one piece of a ``block_m`` tile: the tile's, at most 128."""
    return min(block_m, PIECE_ROWS)


def store_descriptors(block_m: int) -> int:
    """The store pool of a ``block_m`` launch: box heights 1, 2, ..., the
    piece's rows, ``log2(rows) + 1`` descriptors."""
    return piece_rows(block_m).bit_length()


def grouped_gemm_smem(block_m: int) -> "Dict[str, int]":
    """B2 / B7, ``Shape<BM>`` of ``csrc/grouped_gemm.cu`` for the instance
    ``block_m`` runs on: 128-K stages of ``NS`` A box slots (two of 64
    rows, or one of 16) and a 128x128 e4m3 B tile; two f16 128x128 B
    tiles (also the output stage); full and empty barriers; 1024 B to
    align the ring for the 128-byte swizzle."""
    tall = instance_rows(block_m) == PIECE_ROWS
    ns, a_rows, stages = (2, 64, 5) if tall else (1, SMALL_PIECE_ROWS, 8)
    stage = ns * a_rows * 128 + 128 * 128
    return {"align": 1024, "ring": stages * stage, "wide_b": 2 * 128 * 128 * 2,
            "barriers": _barriers(2 * stages)}


def gmm_bf16_smem(block_m: int, out_itemsize: int) -> "Dict[str, int]":
    """B5, ``smem_bytes<BM, NC, OutT>`` of ``csrc/gmm_bf16.cu`` for the
    instance ``block_m`` runs on: 4 stages of ``NC`` bf16 A slabs (64 rows
    x 64 K) and a 64 K x 128 N B tile, the staged output piece (16 or 128
    rows x 128), the barriers."""
    nc = _gmm_bf16_consumers(block_m)
    return {"align": 1024, "ring": 4 * (nc * 64 * 64 * 2 + 64 * 128 * 2),
            "out_stage": instance_rows(block_m) * 128 * out_itemsize,
            "barriers": _barriers(2 * 4)}


def _gmm_bf16_consumers(block_m: int) -> int:
    """B5's consumer warpgroups: one a 64-row slab of the instance's
    piece."""
    return _ceil_div(instance_rows(block_m), 64)


def wgrad_bf16_smem(out_itemsize: int) -> "Dict[str, int]":
    """B4, ``csrc/wgrad_bf16.cu``: 4 stages of x and dy (two 64-row x 64
    bf16 boxes each), the staged 128x128 dw tile, the barriers."""
    return {"align": 1024, "ring": 4 * 4 * 64 * 128,
            "out_stage": 128 * 128 * out_itemsize,
            "barriers": _barriers(2 * 4)}


def wgrad_fp8_smem(out_itemsize: int) -> "Dict[str, int]":
    """B6, ``csrc/wgrad.cu``: 4 stages of e4m3 x and dy boxes (64 rows x
    128 B), two widened buffers (bf16 x, dy hi, dy lo: two boxes each),
    the staged dw tile, the ring's and the widening barriers."""
    return {"align": 1024, "ring": 4 * 2 * 64 * 128,
            "widened": 2 * 6 * 64 * 128,
            "out_stage": 128 * 128 * out_itemsize,
            "barriers": _barriers(2 * 4 + 4)}


def flash_smem(head_dim: int) -> "Dict[str, int]":
    """B8, ``Cfg<D>::kSmem`` of ``csrc/flash_attention.cu``: the q and o
    tiles and 2-stage k and v rings of 64 rows x D bf16, the barriers."""
    tile = head_dim // 64 * 64 * 128
    return {"align": 1024, "tiles": tile * (2 + 2 * 2),
            "barriers": _barriers(2 + 4 * 2)}


#: kernel -> its library, ``csrc/<lib>.cu``
KERNELS = {
    "gmm": "grouped_gemm",
    "gmm_quant": "grouped_gemm",
    "gmm_bf16": "gmm_bf16",
    "wgrad": "wgrad_bf16",
    "wgrad_fp8": "wgrad",
    "flash_attention": "flash_attention",
    "quantize_tilewise": "quant",
    "act_quantize": "act_quant",
}


def wgrad_cluster(block_n: int = 128, n_span: int = 1,
                  k_span: int = 1) -> "Dict[str, int]":
    """The thread-block cluster on which B4 and B6 run a pool geometry's
    super-tile (``Geom`` of ``csrc/wgrad_tile.cuh``): ``ck`` = ``k_span``
    by ``cn`` = ``n_span * block_n / 128`` CTAs, one a 128 x 128
    sub-tile (1 x 1: no cluster).  Raises for a geometry outside
    :data:`WGRAD_GEOMETRIES`."""
    if (block_n, n_span, k_span) not in WGRAD_GEOMETRIES:
        raise ValueError(f"no wgrad cluster for block_n={block_n}, "
                         f"n_span={n_span}, k_span={k_span}")
    return {"ck": k_span, "cn": n_span * block_n // CUDA_TILE_NK}


def kernel_resources(kernel: str, *, block_m: int = 128,
                     out_itemsize: int = 2, head_dim: int = 128,
                     cluster_ctas: int = 1) -> "Dict[str, Any]":
    """Shared memory a CTA (``buffers`` and their ``smem`` total), threads
    a CTA and the CTAs an SM is meant to hold, for one variant of
    ``kernel`` (a key of :data:`KERNELS`); for a grouped GEMM also the
    rows of a piece and its store pool's descriptors at ``block_m``; for
    a wgrad the CTAs of its thread-block cluster (``cluster_ctas``: 1,
    no cluster; the shared memory a CTA is the same in every cluster)."""
    if kernel in ("gmm", "gmm_quant", "gmm_bf16"):
        extra = {"piece_rows": piece_rows(block_m),
                 "store_descriptors": store_descriptors(block_m)}
    else:
        extra = {}
    if kernel in ("gmm", "gmm_quant"):
        buffers, threads, ctas = grouped_gemm_smem(block_m), 256 + 128, 1
    elif kernel == "gmm_bf16":
        nc = _gmm_bf16_consumers(block_m)
        buffers = gmm_bf16_smem(block_m, out_itemsize)
        threads, ctas = 128 * nc + 32, 2 if nc == 1 else 1
    elif kernel == "wgrad":
        buffers, threads, ctas = wgrad_bf16_smem(out_itemsize), 2 * 128 + 32, 1
        extra = {"cluster_ctas": cluster_ctas}
    elif kernel == "wgrad_fp8":
        buffers, threads, ctas = wgrad_fp8_smem(out_itemsize), 4 * 128, 1
        extra = {"cluster_ctas": cluster_ctas}
    elif kernel == "flash_attention":
        buffers = flash_smem(head_dim)
        threads, ctas = 128 + 32, 2 if head_dim == 128 else 3
    elif kernel in ("quantize_tilewise", "act_quantize"):
        # one warp a 1x128 tile, straight from global memory
        buffers, threads, ctas = {}, 256, None
    else:
        raise ValueError(f"unknown kernel {kernel!r}; modelled: "
                         f"{tuple(KERNELS)}")
    return {"kernel": kernel, "buffers": buffers,
            "smem": sum(buffers.values()), "threads": threads,
            "ctas_per_sm": ctas, **extra}


def variants() -> "List[Dict[str, Any]]":
    """Every variant the CUDA libraries build, with its model resources and
    the arguments of its library's ``kernel_resources(a, b, c, out)``
    query: B2 / B7 ``(block_m, out_f32, quantizing)``, B5 ``(block_m,
    out_f32, k_major)`` (one a block_m of :data:`CUDA_BLOCK_MS`, each
    taking every block_n of :data:`CUDA_BLOCK_NS`), B4 / B6 ``(ck,
    out_f32, cn)`` (one a cluster form of :func:`wgrad_cluster`: 1 x 1,
    1 x 2, 2 x 2 and the span-4 form), B8 ``(head_dim, 0, 0)``, B1 ``(0,
    0, 0)``, B3 ``(in_kind, act, 0)``."""
    out = []

    def add(kernel, args, label, **kw):
        extra = ({"block_ns": CUDA_BLOCK_NS}
                 if kernel in ("gmm", "gmm_quant", "gmm_bf16") else {})
        out.append({**kernel_resources(kernel, **kw),
                    "library": KERNELS[kernel],
                    "args": args, "variant": label, **extra})
    for bm in CUDA_BLOCK_MS:
        for f32, it in ((0, 2), (1, 4)):
            dt = "f32" if f32 else "bf16"
            add("gmm", (bm, f32, 0), f"block_m {bm}, {dt} out", block_m=bm)
            add("gmm_quant", (bm, f32, 1),
                f"block_m {bm}, rounded through {dt}", block_m=bm)
            for km in (0, 1):
                add("gmm_bf16", (bm, f32, km),
                    f"block_m {bm}, {dt} out, w "
                    f"{'K' if km else 'N'}-contiguous",
                    block_m=bm, out_itemsize=it)
    forms = []
    for geometry in WGRAD_GEOMETRIES:
        c = wgrad_cluster(*geometry)
        if (c["ck"], c["cn"]) not in forms:
            forms.append((c["ck"], c["cn"]))
    for f32, it in ((0, 2), (1, 4)):
        dt = "f32" if f32 else "bf16"
        for ck, cn in forms:
            label = f"{dt} dw, cluster {ck} x {cn}"
            for kernel in ("wgrad", "wgrad_fp8"):
                add(kernel, (ck, f32, cn), label, out_itemsize=it,
                    cluster_ctas=ck * cn)
    for d in (64, 128):
        add("flash_attention", (d, 0, 0), f"head dim {d}", head_dim=d)
    add("quantize_tilewise", (0, 0, 0), "f32 in")
    for kind, name in enumerate(("f32", "bf16", "e4m3")):
        for act, an in enumerate(("silu_mul", "gelu")):
            add("act_quantize", (kind, act, 0), f"{name} in, {an}")
    return out


def fits_sm(registers: int, threads: int, ctas: int, smem: int, *,
            device_kind: str = "nvidia h100") -> "Dict[str, Any]":
    """Whether ``ctas`` CTAs of ``threads`` threads at ``registers`` a
    thread and ``smem`` bytes of dynamic shared memory fit one SM:
    registers are granted a warp at a time in units of 8 a thread."""
    b = budgets(device_kind)
    warps = _ceil_div(threads, 32)
    regs = ctas * warps * 32 * _ceil_div(registers, 8) * 8
    shared = ctas * (smem + b["smem_reserved_per_cta"])
    return {"registers_used": regs, "registers_budget": b["regs_per_sm"],
            "smem_used": shared, "smem_budget": b["smem_per_sm"],
            "fits": regs <= b["regs_per_sm"] and shared <= b["smem_per_sm"]
            and registers <= b["max_regs_per_thread"]}


# ---------------------------------------------------------------------------
# Per-family footprints and the static feasibility checks
# ---------------------------------------------------------------------------

def family_kernel(family: str, *, wgrad_precision: Optional[str] = None,
                  gemm_precision: Optional[str] = None) -> str:
    """The kernel that runs ``family`` at the given precisions."""
    if family == "gemm":
        return "gmm_bf16" if gemm_precision == "bf16" else "gmm"
    if family == "gemm_quant":
        return "gmm_quant"
    if family == "wgrad":
        return "wgrad_fp8" if wgrad_precision == "fp8" else "wgrad"
    if family == "quantize":
        return "quantize_tilewise"
    if family == "act_quant":
        return "act_quantize"
    raise ValueError(f"no footprint model for operator family {family!r}; "
                     f"modelled families: {FAMILIES}")


def footprint(family: str, config: Any, *, m: int, k: int, n: int,
              wgrad_precision: Optional[str] = None,
              gemm_precision: Optional[str] = None) -> "Dict[str, Any]":
    """Shared memory one CTA of ``family``'s kernel holds under
    ``config`` (a KernelConfig-like object or a ``{"block_m": ..}``
    dict), at a bf16 output: ``{"kernel", "buffers", "total", "threads",
    "ctas_per_sm"}``.  The footprints do not grow with the shape (every
    kernel streams K through its ring); ``m``, ``k`` and ``n`` are taken
    for the callers' symmetry.  The wgrad's precision comes from the
    argument or the config's ``wgrad_precision``;
    ``gemm_precision="bf16"`` selects B5."""
    bm, _, _ = config_blocks(config)
    if family == "wgrad" and wgrad_precision is None:
        wgrad_precision = (config.get("wgrad_precision", "bf16")
                           if isinstance(config, dict)
                           else getattr(config, "wgrad_precision", "bf16"))
    kernel = family_kernel(family, wgrad_precision=wgrad_precision,
                           gemm_precision=gemm_precision)
    r = kernel_resources(kernel, block_m=bm)
    return {"kernel": kernel, "buffers": r["buffers"], "total": r["smem"],
            "threads": r["threads"], "ctas_per_sm": r["ctas_per_sm"]}


def alignment_issues(config: Any, *, k: Optional[int] = None,
                     n: Optional[int] = None,
                     itemsize: int = 1) -> "List[Tuple[str, str]]":
    """``(code, message)`` pairs for the paper's static alignment rules on
    Hopper: whole 8-row MMA fragment groups (block_m % 8), 128-byte
    shared boxes for the 128-byte swizzle (block_n and block_k times the
    e4m3 item size), whole 1x128 scale blocks (block_k % 128) and, where
    the shape is given, 16-byte global rows for TMA (K and N times
    ``itemsize``)."""
    bm, bn, bk = config_blocks(config)
    out = []
    if bm % MMA_ROWS:
        out.append(("mma_rows", f"block_m={bm} is not a multiple of "
                                f"{MMA_ROWS} (an MMA fragment's row group)"))
    if bn % SWIZZLE_BYTES:
        out.append(("swizzle", f"block_n={bn} is not a multiple of "
                               f"{SWIZZLE_BYTES} (a 128-byte swizzled box "
                               f"row of e4m3)"))
    if bk % QUANT_BLOCK:
        out.append(("quant", f"block_k={bk} is not a multiple of "
                             f"QUANT_BLOCK={QUANT_BLOCK}: the tile would "
                             f"cover a fractional 1x128 scale column"))
    for axis, size in (("K", k), ("N", n)):
        if size is not None and size * itemsize % TMA_ROW_ALIGN:
            out.append(("tma_row", f"{axis}={size} rows of {itemsize}-byte "
                                   f"items are not {TMA_ROW_ALIGN}-byte "
                                   f"aligned (a TMA tensor map's stride)"))
    return out


def missing_variant(family: str, config: Any) -> "Optional[str]":
    """Why ``family`` has no CUDA kernel built for ``config``'s geometry,
    or None.  The grouped GEMMs take ``block_m`` in :data:`CUDA_BLOCK_MS`,
    ``block_n`` in :data:`CUDA_BLOCK_NS` and a 128-deep K tile; the
    wgrads take the ``(block_n, n_span, k_span)`` of
    :data:`WGRAD_GEOMETRIES` at a 128-deep K tile (their walk reads no
    ``block_m``); the quantizers take no tile."""
    bm, bn, bk = config_blocks(config)
    if family in ("gemm", "gemm_quant"):
        if bm not in CUDA_BLOCK_MS:
            return (f"no CUDA variant: the grouped GEMMs are built for "
                    f"block_m in {CUDA_BLOCK_MS}, not {bm}")
        if bn not in CUDA_BLOCK_NS or bk != CUDA_TILE_NK:
            return (f"no CUDA variant: the grouped GEMMs tile N at "
                    f"{CUDA_BLOCK_NS} and K at {CUDA_TILE_NK}, not "
                    f"block_n={bn}, block_k={bk}")
    elif family == "wgrad":
        ns, ks = config_spans(config)
        if bk != CUDA_TILE_NK or (bn, ns, ks) not in WGRAD_GEOMETRIES:
            return (f"no CUDA variant: the wgrads are built for (block_n, "
                    f"n_span, k_span) in {WGRAD_GEOMETRIES} at block_k="
                    f"{CUDA_TILE_NK}, not block_n={bn}, n_span={ns}, "
                    f"k_span={ks}, block_k={bk}")
    return None


def degeneracy_issues(config: Any, *, m: int, k: int, n: int,
                      elementwise: bool = False,
                      n_span: int = 1, k_span: int = 1) -> "List[str]":
    """Grid-degeneracy hazards at a concrete shape: a tile wider than the
    operand it walks, or an M tile so tall one visit covers every row
    with half the fetched rows wasted (``block_m >= 2*M``).  Elementwise
    kernels take no M tile.  The wgrad caller passes its spans: the grid
    steps by whole ``(k_span*bk, n_span*bn)`` super-tiles."""
    bm, bn, bk = config_blocks(config)
    bn, bk = bn * n_span, bk * k_span
    span_n = f" * n_span={n_span}" if n_span > 1 else ""
    span_k = f" * k_span={k_span}" if k_span > 1 else ""
    out = []
    if elementwise:
        return out
    if n and bn > n:
        out.append(f"block_n{span_n}={bn} is wider than the operand "
                   f"(N={n}): the N grid has zero full steps")
    if k and bk > k:
        out.append(f"block_k{span_k}={bk} is wider than the operand "
                   f"(K={k}): the K grid has zero full steps")
    if m and bm >= 2 * m and bm > 8:
        out.append(f"block_m={bm} is degenerate for M={m}: one visit "
                   f"covers every row with >=50% of the fetched A rows "
                   f"(and the C flush) wasted")
    return out


def infeasible_reason(family: str, config: Any, m: int, k: int, n: int, *,
                      smem_bytes: float,
                      wgrad_precision: Optional[str] = None,
                      gemm_precision: Optional[str] = None
                      ) -> "Optional[str]":
    """One-line reason this ``(family, config, shape)`` can never run (or
    never run well) on a card with ``smem_bytes`` of shared memory a CTA,
    or ``None``.  In order: misaligned (the rows checked as e4m3, the
    strictest the kernels take), no CUDA variant, a degenerate grid, over
    the shared-memory budget.  ``plan.autotune`` prunes with it before
    ranking and measuring."""
    for code, msg in alignment_issues(config, k=k, n=n):
        return f"misaligned ({code}): {msg}"
    reason = missing_variant(family, config)
    if reason is not None:
        return reason
    elementwise = family in ("quantize", "act_quant")
    ns, ks = config_spans(config) if family == "wgrad" else (1, 1)
    for msg in degeneracy_issues(config, m=m, k=k, n=n,
                                 elementwise=elementwise,
                                 n_span=ns, k_span=ks):
        return f"degenerate grid: {msg}"
    fp = footprint(family, config, m=m, k=k, n=n,
                   wgrad_precision=wgrad_precision,
                   gemm_precision=gemm_precision)
    if fp["total"] > smem_bytes:
        return (f"shared memory {fp['total']} B a CTA exceeds the "
                f"{int(smem_bytes)} B budget")
    return None
