"""Padding-free grouped GEMMs: the CUDA kernels
(``csrc/grouped_gemm.cu``, ``csrc/gmm_bf16.cu``) and their plain PyTorch
versions.

``y[rows of group g] = A[rows of g] @ B[g]`` over the unpadded,
concatenated token buffer.  Three functions:

- :func:`gmm` (B2): A in e4m3 with 1x128 scales and B in e4m3 with
  128x128 scales (the DeepSeek-V3 recipe, as in the paper).  Per 128-K
  block the f32 dot is rescaled by ``s_a[row, kb] * s_b[g, kb, nb]`` and
  accumulated in f32.  Rows in ``[sum(group_sizes), M)`` come back as
  defined zeros.
- :func:`gmm_quant` (B7): the same product, rounded through
  ``out_dtype`` and stored as e4m3 with 1x128 scales straight from the
  kernel: bitwise the quantizer applied to :func:`gmm`'s output.  Tail
  rows come back as payload 0 and scale 1.
- :func:`gmm_bf16` (B5): bf16 operands, no scales, one f32 dot per 128-K
  block added in f32; tail rows are zeros.  B is read in either layout:
  contiguous ``[G, K, N]`` (the forward's weight) or ``transpose(1, 2)``
  of a contiguous ``[G, N, K]`` (the dgrad's ``w^T``, read where it lies).

B2 and B7 share one kernel template (``grouped_gemm.cu``), B5 is its own
(``gmm_bf16.cu``); all three run on Hopper's TMA and wgmma (B2 and B7
widen their e4m3 tiles to f16 on the way into wgmma) and store owned rows
through a pool of power-of-two TMA store descriptors.  Every kernel walks
the :class:`~repro_torch.kernels.plan.TilePlan` at the plan's tile,
``block_m`` rows by ``block_n`` columns: every grouped-GEMM geometry of
the JAX package's ``CONFIG_POOL`` (block_m 8 to 512, block_n 128 or 256,
walked in pieces as ``csrc/tile_geom.cuh`` says).  Each visit writes only
the rows its group owns (see the sources for why the Pallas kernels'
read-modify-write store does not carry over).  Any other geometry raises
with the resource model's reason (``resources.missing_variant``).

Each function chooses by its tensor: a ``FakeTensor`` -> its
``*_abstract`` version (shape-only, :mod:`~repro_torch.kernels.abstract`),
CPU -> its ``*_plain`` version, CUDA -> its ``*_cuda`` wrapper, which
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import abstract, build
from repro_torch.kernels import resources as _resources
from repro_torch.kernels.plan import QUANT_BLOCK, KernelConfig, TilePlan, \
    device_spec, gemm_work, make_tile_plan
from repro_torch.kernels.ref import FP8, gmm_bf16_exact_ref, \
    gmm_quant_ref, grouped_gemm_blockscaled_ref

_P, _I = ctypes.c_void_p, ctypes.c_int


def _prepare(a, s_a, b, s_b, group_sizes, num_groups, block_m, block_n,
             block_k, plan):
    """Shape checks shared by every function of the module (``s_a`` and
    ``s_b`` are None for bf16 operands); builds the plan when absent."""
    m, k = a.shape
    g, k2, n = b.shape
    if k != k2:
        raise ValueError(
            f"A and B disagree on K: A is [M={m}, K={k}] but B is "
            f"[G={g}, K={k2}, N={n}]")
    num_groups = num_groups or g
    KernelConfig(block_m=block_m, block_n=block_n,
                 block_k=block_k).validate(m, k, n)
    kb = (k + QUANT_BLOCK - 1) // QUANT_BLOCK
    if s_a is not None and tuple(s_a.shape) != (m, kb):
        raise ValueError(f"s_a has shape {tuple(s_a.shape)}; A of shape "
                         f"{(m, k)} needs 1x128 scales of shape {(m, kb)}")
    if s_b is not None and tuple(s_b.shape) != (g, kb, n // QUANT_BLOCK):
        raise ValueError(f"s_b has shape {tuple(s_b.shape)}; B of shape "
                         f"{(g, k, n)} needs 128x128 scales of shape "
                         f"{(g, kb, n // QUANT_BLOCK)}")
    if plan is None:
        plan = make_tile_plan(group_sizes, m, block_m=block_m,
                              num_groups=num_groups)
    else:
        plan.check_against(m, block_m, num_groups)
    return m, k, n, num_groups, plan


def _check_cuda(family, block_m, block_n, block_k, plan: TilePlan,
                out_dtype, operands) -> None:
    """What the CUDA kernels take: a tile geometry the resource model
    says is built for ``family`` (``resources.missing_variant``), a bf16
    or f32 output (or rounding) dtype, and contiguous, 16-byte aligned
    operands of the given dtypes on one CUDA device."""
    reason = _resources.missing_variant(
        family, {"block_m": block_m, "block_n": block_n, "block_k": block_k})
    if reason is not None:
        raise ValueError(f"the CUDA grouped GEMM cannot run this tile: "
                         f"{reason}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"out_dtype must be bf16 or f32, got {out_dtype}")
    if plan.max_visits > 65535:      # visits are the grid's y dimension
        raise ValueError(f"{plan.max_visits} visits exceed the CUDA grid's "
                         f"65535; use a larger block_m")
    dev = operands[0][1].device
    for name, t, dt in (*operands,
                        ("group_offsets", plan.group_offsets, torch.int32),
                        ("group_ids", plan.group_ids, torch.int32),
                        ("m_tile_ids", plan.m_tile_ids, torch.int32)):
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name} must be a CUDA tensor on {dev}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _output(out, shape, dtype, like, name):
    """``out``, checked as a kernel's TMA stores take it, or a new tensor
    on ``like``'s device (a fake one for a fake ``like``) when it is
    None."""
    dev = like.device
    if out is None:
        return like.new_empty(shape, dtype=dtype)
    if (tuple(out.shape) != shape or out.dtype != dtype or out.device != dev
            or not out.is_contiguous() or not abstract.aligned(out)):
        raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                         f"{list(shape)} {dtype} tensor on {dev}")
    return out


def _count_work(name, m, k, n, num_groups, block_m, block_n, block_k,
                **kw) -> None:
    """Add one shape-only launch's work (the cost model's, at the static
    M) to ``abstract.WORK``."""
    cfg = KernelConfig(block_m=block_m, block_n=block_n, block_k=block_k)
    abstract.count(name, *gemm_work(m, k, n, num_groups, cfg,
                                    device_spec("nvidia h100"), **kw))


def _plan_args(plan: TilePlan):
    return (plan.group_offsets.data_ptr(), plan.group_ids.data_ptr(),
            plan.m_tile_ids.data_ptr())


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
    ``out`` (optional, a contiguous, 16-byte aligned [M, N] of
    ``out_dtype``) receives the result; every one of its rows is
    written."""
    m, k, n, num_groups, plan = _prepare(
        a_fp8, s_a, b_fp8, s_b, group_sizes, num_groups, block_m, block_n,
        block_k, plan)
    _check_cuda("gemm", block_m, block_n, block_k, plan, out_dtype,
                (("a_fp8", a_fp8, FP8), ("s_a", s_a, torch.float32),
                 ("b_fp8", b_fp8, FP8), ("s_b", s_b, torch.float32)))
    dev = a_fp8.device
    out = _output(out, (m, n), out_dtype, a_fp8, "out")
    if m == 0:
        return out
    fn = build.function("grouped_gemm", "gmm_fp8", [_P] * 8 + [_I] * 8 + [_P])
    status = fn(a_fp8.data_ptr(), s_a.data_ptr(), b_fp8.data_ptr(),
                s_b.data_ptr(), *_plan_args(plan),
                out.data_ptr(), m, k, n, num_groups, plan.max_visits,
                block_m, block_n, 1 if out_dtype == torch.float32 else 0,
                build.stream_ptr(dev))
    build.check(status, "gmm")
    gmm_cuda.launches += 1
    return out


gmm_cuda.launches = 0


def gmm_abstract(a_fp8, s_a, b_fp8, s_b, group_sizes, *,
                 num_groups: Optional[int] = None, block_m: int = 128,
                 block_n: int = 128, block_k: int = 128,
                 out_dtype: torch.dtype = torch.bfloat16,
                 plan: Optional[TilePlan] = None,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Shape-only :func:`gmm` (:mod:`~repro_torch.kernels.abstract`): its
    checks, its [M, N] output (``out`` checked as the kernel takes it) and
    the kernel's work at the static M; reads nothing to the host."""
    m, k, n, num_groups, plan = _prepare(
        a_fp8, s_a, b_fp8, s_b, group_sizes, num_groups, block_m, block_n,
        block_k, plan)
    out = _output(out, (m, n), out_dtype, a_fp8, "out")
    _count_work("gmm", m, k, n, num_groups, block_m, block_n, block_k,
                out_itemsize=out_dtype.itemsize)
    return out


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
    fn = gmm_abstract if abstract.is_fake(a_fp8) else \
        gmm_cuda if a_fp8.is_cuda else gmm_plain
    return fn(a_fp8, s_a, b_fp8, s_b, group_sizes, num_groups=num_groups,
              block_m=block_m, block_n=block_n, block_k=block_k,
              out_dtype=out_dtype, plan=plan, out=out)


# ---------------------------------------------------------------------------
# B7: the quantizing-store grouped GEMM
# ---------------------------------------------------------------------------

def gmm_quant_plain(a_fp8, s_a, b_fp8, s_b, group_sizes, *,
                    num_groups: Optional[int] = None, block_m: int = 128,
                    block_n: int = 128, block_k: int = 128,
                    out_dtype: torch.dtype = torch.bfloat16,
                    plan: Optional[TilePlan] = None):
    """The kernel's function in PyTorch ops: the oracle
    ``ref.gmm_quant_ref``, the quantizer applied to the GEMM's output
    rounded through ``out_dtype`` (it reads the group offsets back to the
    host).  Same signature as :func:`gmm_quant`."""
    m, k, n, num_groups, plan = _prepare(
        a_fp8, s_a, b_fp8, s_b, group_sizes, num_groups, block_m, block_n,
        block_k, plan)
    offs = plan.group_offsets.tolist()
    sizes = [offs[g + 1] - offs[g] for g in range(num_groups)]
    return gmm_quant_ref(a_fp8, s_a, b_fp8, s_b, sizes, out_dtype=out_dtype)


def gmm_quant_cuda(a_fp8, s_a, b_fp8, s_b, group_sizes, *,
                   num_groups: Optional[int] = None, block_m: int = 128,
                   block_n: int = 128, block_k: int = 128,
                   out_dtype: torch.dtype = torch.bfloat16,
                   plan: Optional[TilePlan] = None,
                   out: Optional[tuple] = None):
    """Launch the CUDA quantizing grouped GEMM (one launch for the whole
    plan, an all-empty one included: its visits sweep every tile and
    write payload 0 and scale 1).  ``out`` (optional, ``(q [M, N] e4m3,
    s [M, N/128] f32)``, contiguous and 16-byte aligned) receives the
    result; every one of their rows is written."""
    m, k, n, num_groups, plan = _prepare(
        a_fp8, s_a, b_fp8, s_b, group_sizes, num_groups, block_m, block_n,
        block_k, plan)
    _check_cuda("gemm_quant", block_m, block_n, block_k, plan, out_dtype,
                (("a_fp8", a_fp8, FP8), ("s_a", s_a, torch.float32),
                 ("b_fp8", b_fp8, FP8), ("s_b", s_b, torch.float32)))
    dev = a_fp8.device
    q, s = out if out is not None else (None, None)
    q = _output(q, (m, n), FP8, a_fp8, "q")
    s = _output(s, (m, n // QUANT_BLOCK), torch.float32, a_fp8, "s")
    if m == 0:
        return q, s
    fn = build.function("grouped_gemm", "gmm_fp8_quant",
                        [_P] * 9 + [_I] * 8 + [_P])
    status = fn(a_fp8.data_ptr(), s_a.data_ptr(), b_fp8.data_ptr(),
                s_b.data_ptr(), *_plan_args(plan), q.data_ptr(), s.data_ptr(),
                m, k, n, num_groups, plan.max_visits, block_m, block_n,
                1 if out_dtype == torch.float32 else 0, build.stream_ptr(dev))
    build.check(status, "gmm_quant")
    gmm_quant_cuda.launches += 1
    return q, s


gmm_quant_cuda.launches = 0


def gmm_quant_abstract(a_fp8, s_a, b_fp8, s_b, group_sizes, *,
                       num_groups: Optional[int] = None, block_m: int = 128,
                       block_n: int = 128, block_k: int = 128,
                       out_dtype: torch.dtype = torch.bfloat16,
                       plan: Optional[TilePlan] = None):
    """Shape-only :func:`gmm_quant`: its checks, ``(q [M, N] e4m3, s [M,
    N/128] f32)`` and the kernel's work (a quantizing store) at the static
    M; reads nothing to the host."""
    m, k, n, num_groups, plan = _prepare(
        a_fp8, s_a, b_fp8, s_b, group_sizes, num_groups, block_m, block_n,
        block_k, plan)
    q = _output(None, (m, n), FP8, a_fp8, "q")
    s = _output(None, (m, n // QUANT_BLOCK), torch.float32, a_fp8, "s")
    _count_work("gmm_quant", m, k, n, num_groups, block_m, block_n, block_k,
                quant_output=True)
    return q, s


def gmm_quant(a_fp8, s_a, b_fp8, s_b, group_sizes, *,
              num_groups: Optional[int] = None, block_m: int = 128,
              block_n: int = 128, block_k: int = 128,
              out_dtype: torch.dtype = torch.bfloat16,
              plan: Optional[TilePlan] = None):
    """Padding-free fp8 grouped GEMM with a quantizing store.

    Operands as :func:`gmm`.  Returns ``(q [M, N] e4m3, s [M, N/128]
    f32)``: the product rounded through ``out_dtype`` (the dtype the
    unfused GEMM would store), then quantized 1x128, bitwise
    ``quantize_tilewise(gmm(..., out_dtype=out_dtype).float())``.  Rows
    >= sum(group_sizes) get payload 0 and scale 1.
    """
    fn = gmm_quant_abstract if abstract.is_fake(a_fp8) else \
        gmm_quant_cuda if a_fp8.is_cuda else gmm_quant_plain
    return fn(a_fp8, s_a, b_fp8, s_b, group_sizes, num_groups=num_groups,
              block_m=block_m, block_n=block_n, block_k=block_k,
              out_dtype=out_dtype, plan=plan)


# ---------------------------------------------------------------------------
# B5: the bf16 grouped GEMM
# ---------------------------------------------------------------------------

def weight_layout(w: torch.Tensor) -> int:
    """How the CUDA bf16 grouped GEMM reads ``w`` [G, K, N]: 0 when it is
    contiguous (N-contiguous, the forward's weight), 1 when it is
    ``transpose(1, 2)`` of a contiguous [G, N, K] (K-contiguous, the
    dgrad's ``w^T`` on the forward weight's own storage).  Raises on any
    other strides and on storage not 16-byte aligned."""
    if w.is_contiguous():
        k_major = 0
    elif w.transpose(1, 2).is_contiguous():
        k_major = 1
    else:
        raise ValueError(
            f"w of shape {tuple(w.shape)} has strides {w.stride()}: the CUDA "
            f"bf16 grouped GEMM takes a contiguous [G, K, N] or transpose(1, "
            f"2) of a contiguous [G, N, K]")
    if w.data_ptr() % 16:
        raise ValueError("w must be 16-byte aligned")
    return k_major


def gmm_bf16_plain(x, w, group_sizes, *, num_groups: Optional[int] = None,
                   block_m: int = 128, block_n: int = 128,
                   block_k: int = 128,
                   out_dtype: torch.dtype = torch.bfloat16,
                   plan: Optional[TilePlan] = None,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch ops: the oracle
    ``ref.gmm_bf16_exact_ref`` (it reads the group offsets back to the
    host).  Same signature as :func:`gmm_bf16`."""
    m, k, n, num_groups, plan = _prepare(
        x, None, w, None, group_sizes, num_groups, block_m, block_n, block_k,
        plan)
    offs = plan.group_offsets.tolist()
    sizes = [offs[g + 1] - offs[g] for g in range(num_groups)]
    y = gmm_bf16_exact_ref(x, w, sizes, out_dtype=torch.float32)
    if out is None:
        return y.to(out_dtype)
    return out.copy_(y)


def gmm_bf16_cuda(x, w, group_sizes, *, num_groups: Optional[int] = None,
                  block_m: int = 128, block_n: int = 128, block_k: int = 128,
                  out_dtype: torch.dtype = torch.bfloat16,
                  plan: Optional[TilePlan] = None,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the CUDA bf16 grouped GEMM (one launch for the whole plan)
    on bf16 operands, ``w`` contiguous or ``transpose(1, 2)`` of a
    contiguous tensor (:func:`weight_layout`).  ``out`` (optional, [M, N]
    of ``out_dtype``) receives the result; every one of its rows is
    written."""
    m, k, n, num_groups, plan = _prepare(
        x, None, w, None, group_sizes, num_groups, block_m, block_n, block_k,
        plan)
    _check_cuda("gemm", block_m, block_n, block_k, plan, out_dtype,
                (("x", x, torch.bfloat16),))
    dev = x.device
    if not w.is_cuda or w.device != dev:
        raise ValueError(f"w must be a CUDA tensor on {dev}")
    if w.dtype != torch.bfloat16:
        raise TypeError(f"w must be {torch.bfloat16}, got {w.dtype}")
    k_major = weight_layout(w)
    out = _output(out, (m, n), out_dtype, x, "out")
    if m == 0:
        return out
    fn = build.function("gmm_bf16", "gmm_bf16", [_P] * 6 + [_I] * 10 + [_P])
    status = fn(x.data_ptr(), w.data_ptr(), *_plan_args(plan), out.data_ptr(),
                m, k, n, num_groups, w.shape[0], plan.max_visits, block_m,
                block_n, 1 if out_dtype == torch.float32 else 0, k_major,
                build.stream_ptr(dev))
    build.check(status, "gmm_bf16")
    gmm_bf16_cuda.launches += 1
    return out


gmm_bf16_cuda.launches = 0


def gmm_bf16_abstract(x, w, group_sizes, *,
                      num_groups: Optional[int] = None, block_m: int = 128,
                      block_n: int = 128, block_k: int = 128,
                      out_dtype: torch.dtype = torch.bfloat16,
                      plan: Optional[TilePlan] = None,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Shape-only :func:`gmm_bf16`: its checks, its [M, N] output and the
    kernel's work at the static M; reads nothing to the host."""
    m, k, n, num_groups, plan = _prepare(
        x, None, w, None, group_sizes, num_groups, block_m, block_n, block_k,
        plan)
    out = _output(out, (m, n), out_dtype, x, "out")
    _count_work("gmm_bf16", m, k, n, num_groups, block_m, block_n, block_k,
                precision="bf16", out_itemsize=out_dtype.itemsize)
    return out


def gmm_bf16(x, w, group_sizes, *, num_groups: Optional[int] = None,
             block_m: int = 128, block_n: int = 128, block_k: int = 128,
             out_dtype: torch.dtype = torch.bfloat16,
             plan: Optional[TilePlan] = None,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Padding-free bf16 grouped GEMM.

    x [M, K] bf16, w [G, K, N] bf16 (on a card: contiguous, or
    ``transpose(1, 2)`` of a contiguous [G, N, K]), group_sizes [G] int
    with sum <= M; ``plan`` as in :func:`gmm`.  Per 128-K block one f32
    dot, added in f32.  Returns [M, N] ``out_dtype``; rows >=
    sum(group_sizes) are zeros.
    """
    fn = gmm_bf16_abstract if abstract.is_fake(x) else \
        gmm_bf16_cuda if x.is_cuda else gmm_bf16_plain
    return fn(x, w, group_sizes, num_groups=num_groups, block_m=block_m,
              block_n=block_n, block_k=block_k, out_dtype=out_dtype,
              plan=plan, out=out)
