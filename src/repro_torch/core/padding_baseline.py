"""The paper's baseline: explicit padding, then the aligned grouped GEMM.

Paper §3: "Our baseline implementation integrates explicit input padding
with DeepGEMM".  The pipeline, stage by stage:

  1. a padding pass copies each group's rows of ``A`` and ``S_A`` into a
     buffer where every group starts at a ``block_m``-aligned offset (the
     memory and bandwidth the paper eliminates);
  2. the same grouped GEMM as the padding-free path (B2) runs over the
     padded buffer, every group a whole number of tiles;
  3. an unpadding pass gathers the valid rows of ``C``.

Every stage is tensor ops on the device of the group sizes: nothing reads
them back to the host, so the baseline never waits for the device, as
``make_tile_plan`` never does.  The pad and unpad passes are plain
PyTorch, as they are plain XLA in the JAX package.  The padded GEMM plans
through :func:`~repro_torch.kernels.plan.shared_plan`, as the JAX
package's does: each static padded shape's fixed tensors are made once,
and every call replays only the data-dependent ops.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import grouped_gemm_kernel
from repro_torch.kernels.plan import KernelConfig, resolve_config, \
    shared_plan


def padded_group_sizes(group_sizes: torch.Tensor,
                       block_m: int = 128) -> torch.Tensor:
    """Each group size rounded up to a multiple of ``block_m`` (int32)."""
    gs = group_sizes.to(torch.int32)
    return (gs + block_m - 1) // block_m * block_m


def default_padded_m(m: int, num_groups: int, block_m: int = 128) -> int:
    """The static bound on the padded rows: ``M + G*(block_m-1)`` rounded
    up to a multiple of ``block_m``."""
    return -(-(m + num_groups * (block_m - 1)) // block_m) * block_m


def pad_groups(a: torch.Tensor, s_a: torch.Tensor,
               group_sizes: torch.Tensor, *, block_m: int = 128,
               padded_m: Optional[int] = None):
    """Scatter each group's rows of ``a`` and ``s_a`` to block-aligned
    offsets.

    ``padded_m`` is a static bound (default :func:`default_padded_m`);
    rows beyond the data are 0 in ``a`` and 1 in ``s_a``.  Returns
    ``(a_padded, s_a_padded, padded_sizes, row_map)`` where
    ``row_map[i]`` is the padded row of source row i.  As in the JAX
    package, rows past ``sum(group_sizes)`` count as rows of the last
    group (they land past its data, in its padding or in the tail), and a
    row mapped past ``padded_m`` is dropped.
    """
    m = a.shape[0]
    g = group_sizes.shape[0]
    if padded_m is None:
        padded_m = default_padded_m(m, g, block_m)
    dev = group_sizes.device
    gs = group_sizes.to(torch.int64)
    psz = padded_group_sizes(group_sizes, block_m)
    ends = torch.cumsum(gs, 0)
    src_off = ends - gs
    dst_off = torch.cumsum(psz.to(torch.int64), 0) - psz
    # group of each source row: the first whose end lies past it; rows
    # past the data fall to the last group
    rows = torch.arange(m, dtype=torch.int64, device=dev)
    seg = torch.clamp(torch.searchsorted(ends, rows, right=True), max=g - 1)
    row_map = dst_off[seg] + (rows - src_off[seg])
    # one spare row takes what the JAX package's scatter drops
    dst = torch.clamp(row_map, max=padded_m)
    # e4m3 moves as its bytes (0 is +0.0): index_copy_ takes no fp8
    raw = a.view(torch.uint8) if a.element_size() == 1 else a
    a_p = torch.zeros((padded_m + 1, a.shape[1]), dtype=raw.dtype,
                      device=a.device)
    s_p = torch.ones((padded_m + 1, s_a.shape[1]), dtype=s_a.dtype,
                     device=s_a.device)
    a_p.index_copy_(0, dst, raw)
    s_p.index_copy_(0, dst, s_a)
    return (a_p[:padded_m].view(a.dtype), s_p[:padded_m], psz,
            row_map.to(torch.int32))


def unpad_groups(c_padded: torch.Tensor,
                 row_map: torch.Tensor) -> torch.Tensor:
    """The rows of ``c_padded`` that ``row_map`` names, in source order
    (an index past the buffer reads its last row, as a JAX gather
    clamps)."""
    idx = torch.clamp(row_map.to(torch.int64), max=c_padded.shape[0] - 1)
    return c_padded[idx]


def grouped_gemm_fp8_padded(a_fp8, s_a, b_fp8, s_b, group_sizes, *,
                            config: Optional[KernelConfig] = None,
                            out_dtype: Optional[torch.dtype] = None,
                            padded_m: Optional[int] = None) -> torch.Tensor:
    """The whole baseline: pad -> the fp8 grouped GEMM (B2) over the
    padded buffer -> unpad.

    Operands as ``grouped_gemm_kernel.gmm``.  Tile shapes come from
    ``config``; its ``block_m`` is the padding granularity.  The padded
    buffer's group offsets differ from the caller's, so a caller's
    :class:`~repro_torch.kernels.plan.TilePlan` never applies: the GEMM
    plans over the padded sizes here, through the plan cache.  Returns
    [M, N] ``out_dtype`` (default bf16).
    """
    cfg = resolve_config(config, out_dtype=out_dtype)
    a_p, s_p, psz, row_map = pad_groups(a_fp8, s_a, group_sizes,
                                        block_m=cfg.block_m,
                                        padded_m=padded_m)
    num_groups = group_sizes.shape[0]
    plan = shared_plan(psz, a_p.shape[0], block_m=cfg.block_m,
                       num_groups=num_groups)
    c_p = grouped_gemm_kernel.gmm(
        a_p, s_p, b_fp8, s_b, psz, num_groups=num_groups,
        block_m=cfg.block_m, block_n=cfg.block_n, block_k=cfg.block_k,
        out_dtype=cfg.out_dtype or torch.bfloat16, plan=plan)
    return unpad_groups(c_p, row_map)


def padding_overhead_bytes(group_sizes, k: int, kb: int,
                           block_m: int = 128) -> dict:
    """Extra bytes the baseline allocates and moves for A (e4m3, one byte
    an element) and S_A (f32): the quantity behind the paper's Fig. 2b.
    Reads the group sizes on the host."""
    gs = torch.as_tensor(group_sizes).to("cpu", torch.int64)
    pad_rows = int(((gs + block_m - 1) // block_m * block_m - gs).sum())
    return {"pad_rows": pad_rows, "a_bytes": pad_rows * k,
            "sa_bytes": pad_rows * kb * 4}


# ---------------------------------------------------------------------------
# Compile contracts (repro_torch.analysis layer 5: REPRO-T03)
# ---------------------------------------------------------------------------
# The padded buffer's static shape is what the baseline amortizes: one
# PLAN_CACHE shape per padded_m bucket.  Two routings in one bucket share
# a shape; a new bucket builds exactly one more.  The JAX package's calls.

from repro_torch.analysis.retrace import \
    register_compile_contract as _register_compile_contract  # noqa: E402


def _build_baseline_retrace(device):
    import numpy as np
    from repro_torch.kernels import plan as plan_mod
    from repro_torch.kernels import ref as kref

    rng = np.random.default_rng(0)
    k = n = 128
    g = 3

    def randn(r, shape):
        return torch.from_numpy(r.standard_normal(shape).astype(
            np.float32)).to(device)

    def operands(m, seed):
        a8, sa = kref.quantize_tilewise_ref(
            randn(np.random.default_rng(seed), (m, k)))
        b8, sb = kref.quantize_blockwise_ref(randn(rng, (g, k, n)))
        return a8, sa, b8, sb

    # from an empty cache, the counted builds are exactly this sequence's
    plan_mod.PLAN_CACHE.clear()
    cfg = KernelConfig()

    def baseline_step(m, gs_vals, seed, bucket):
        gs = torch.tensor(gs_vals, dtype=torch.int32, device=device)
        return grouped_gemm_fp8_padded(*operands(m, seed), gs, config=cfg,
                                       padded_m=bucket)

    # two same-bucket calls (different routings) + one new bucket
    calls = [(256, [60, 0, 130], 2, 640),
             (256, [100, 50, 40], 3, 640),
             (512, [200, 12, 44], 4, 896)]
    return baseline_step, calls


_register_compile_contract(
    "padding_baseline.bucket.retrace",
    description="the padded pipeline builds one plan-cache shape per "
                "(padded_m) M-bucket: two same-bucket routings share one, "
                "a new bucket adds exactly one",
    build=_build_baseline_retrace,
    expected={"plan_cache_build": 2}, rule="REPRO-T03")
