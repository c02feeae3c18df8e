"""Padding-free fp8 grouped GEMM: the CUDA kernel
(``csrc/grouped_gemm.cu``) and its plain PyTorch version.

``y[rows of group g] = A[rows of g] @ B[g]`` over the unpadded,
concatenated token buffer, with A in e4m3 with 1x128 scales and B in
e4m3 with 128x128 scales (the DeepSeek-V3 recipe, as in the paper).  Per
128-K block the f32 dot is rescaled by ``s_a[row, kb] * s_b[g, kb, nb]``
and accumulated in f32.  Rows in ``[sum(group_sizes), M)`` come back as
defined zeros.

The kernel walks the :class:`~repro_torch.kernels.plan.TilePlan`: one
CTA per (visit, 128-column N tile), each writing only the rows its group
owns (see the source for why the Pallas kernel's read-modify-write store
does not carry over).

:func:`gmm` chooses by the tensor's device: CPU -> :func:`gmm_plain`,
CUDA -> :func:`gmm_cuda`, which launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.plan import QUANT_BLOCK, KernelConfig, TilePlan, \
    make_tile_plan
from repro_torch.kernels.ref import FP8, grouped_gemm_blockscaled_ref

#: M tile heights the kernel is instantiated for: decode's and prefill's
CUDA_BLOCK_MS = (16, 128)
_P, _I = ctypes.c_void_p, ctypes.c_int


def _prepare(a_fp8, s_a, b_fp8, s_b, group_sizes, num_groups, block_m,
             block_n, block_k, plan):
    m, k = a_fp8.shape
    g, k2, n = b_fp8.shape
    if k != k2:
        raise ValueError(
            f"A and B disagree on K: a_fp8 is [M={m}, K={k}] but b_fp8 is "
            f"[G={g}, K={k2}, N={n}]")
    num_groups = num_groups or g
    KernelConfig(block_m=block_m, block_n=block_n,
                 block_k=block_k).validate(m, k, n)
    kb = (k + QUANT_BLOCK - 1) // QUANT_BLOCK
    if tuple(s_a.shape) != (m, kb):
        raise ValueError(f"s_a has shape {tuple(s_a.shape)}; A of shape "
                         f"{(m, k)} needs 1x128 scales of shape {(m, kb)}")
    if tuple(s_b.shape) != (g, kb, n // QUANT_BLOCK):
        raise ValueError(f"s_b has shape {tuple(s_b.shape)}; B of shape "
                         f"{(g, k, n)} needs 128x128 scales of shape "
                         f"{(g, kb, n // QUANT_BLOCK)}")
    if plan is None:
        plan = make_tile_plan(group_sizes, m, block_m=block_m,
                              num_groups=num_groups)
    else:
        plan.check_against(m, block_m, num_groups)
    return m, k, n, num_groups, plan


def gmm_plain(a_fp8, s_a, b_fp8, s_b, group_sizes, *,
              num_groups: Optional[int] = None, block_m: int = 128,
              block_n: int = 128, block_k: int = 128,
              out_dtype: torch.dtype = torch.bfloat16,
              plan: Optional[TilePlan] = None,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch ops: the oracle
    ``ref.grouped_gemm_blockscaled_ref`` on the owned rows (it reads the
    group offsets back to the host), zeros below.  Same signature as
    :func:`gmm`."""
    m, k, n, num_groups, plan = _prepare(
        a_fp8, s_a, b_fp8, s_b, group_sizes, num_groups, block_m, block_n,
        block_k, plan)
    offs = plan.group_offsets.tolist()
    total = offs[num_groups]
    sizes = [offs[g + 1] - offs[g] for g in range(num_groups)]
    y = torch.zeros((m, n), dtype=torch.float32, device=a_fp8.device)
    y[:total] = grouped_gemm_blockscaled_ref(
        a_fp8[:total], s_a[:total], b_fp8, s_b, sizes, out_dtype=torch.float32)
    if out is None:
        return y.to(out_dtype)
    return out.copy_(y)


def gmm_cuda(a_fp8, s_a, b_fp8, s_b, group_sizes, *,
             num_groups: Optional[int] = None, block_m: int = 128,
             block_n: int = 128, block_k: int = 128,
             out_dtype: torch.dtype = torch.bfloat16,
             plan: Optional[TilePlan] = None,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the CUDA grouped GEMM (one launch for the whole plan).
    ``out`` (optional, [M, N] of ``out_dtype``) receives the result; every
    one of its rows is written."""
    m, k, n, num_groups, plan = _prepare(
        a_fp8, s_a, b_fp8, s_b, group_sizes, num_groups, block_m, block_n,
        block_k, plan)
    if block_m not in CUDA_BLOCK_MS:
        raise ValueError(f"the CUDA grouped GEMM supports block_m in "
                         f"{CUDA_BLOCK_MS}, got {block_m}")
    if block_n != 128 or block_k != 128:
        raise ValueError(f"the CUDA grouped GEMM tiles N and K at 128, got "
                         f"block_n={block_n}, block_k={block_k}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"out_dtype must be bf16 or f32, got {out_dtype}")
    if plan.max_visits > 65535:      # visits are the grid's y dimension
        raise ValueError(f"{plan.max_visits} visits exceed the CUDA grid's "
                         f"65535; use a larger block_m")
    dev = a_fp8.device
    for name, t, dt in (("a_fp8", a_fp8, FP8), ("s_a", s_a, torch.float32),
                        ("b_fp8", b_fp8, FP8), ("s_b", s_b, torch.float32),
                        ("group_offsets", plan.group_offsets, torch.int32),
                        ("group_ids", plan.group_ids, torch.int32),
                        ("m_tile_ids", plan.m_tile_ids, torch.int32)):
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name} must be a CUDA tensor on {dev}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if out is None:
        out = torch.empty((m, n), dtype=out_dtype, device=dev)
    elif (tuple(out.shape) != (m, n) or out.dtype != out_dtype
          or out.device != dev or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous [{m}, {n}] {out_dtype} "
                         f"tensor on {dev}")
    if m == 0:
        return out
    fn = build.function("grouped_gemm", "gmm_fp8", [_P] * 8 + [_I] * 7 + [_P])
    status = fn(a_fp8.data_ptr(), s_a.data_ptr(), b_fp8.data_ptr(),
                s_b.data_ptr(), plan.group_offsets.data_ptr(),
                plan.group_ids.data_ptr(), plan.m_tile_ids.data_ptr(),
                out.data_ptr(), m, k, n, num_groups, plan.max_visits,
                block_m, 1 if out_dtype == torch.float32 else 0,
                build.stream_ptr(dev))
    build.check(status, "gmm")
    gmm_cuda.launches += 1
    return out


gmm_cuda.launches = 0


def gmm(a_fp8, s_a, b_fp8, s_b, group_sizes, *,
        num_groups: Optional[int] = None, block_m: int = 128,
        block_n: int = 128, block_k: int = 128,
        out_dtype: torch.dtype = torch.bfloat16,
        plan: Optional[TilePlan] = None,
        out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Padding-free fp8 grouped GEMM.

    a_fp8 [M, K] e4m3, s_a [M, K/128] f32, b_fp8 [G, K, N] e4m3,
    s_b [G, K/128, N/128] f32, group_sizes [G] int with sum <= M.
    ``plan``: the :class:`TilePlan` of these ``group_sizes`` (built here
    when absent); it must come from exactly these sizes.
    Returns [M, N] ``out_dtype``; rows >= sum(group_sizes) are zeros.
    """
    fn = gmm_cuda if a_fp8.is_cuda else gmm_plain
    return fn(a_fp8, s_a, b_fp8, s_b, group_sizes, num_groups=num_groups,
              block_m=block_m, block_n=block_n, block_k=block_k,
              out_dtype=out_dtype, plan=plan, out=out)
