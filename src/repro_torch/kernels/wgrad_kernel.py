"""Ragged-contraction (wgrad) grouped GEMM: the CUDA kernels
(``csrc/wgrad_bf16.cu`` for bf16 operands, ``csrc/wgrad.cu`` for e4m3
ones) and their plain PyTorch versions.

``dw[g] = x_g^T @ dy_g``, where the contracted axis is the ragged M axis:
group g owns rows ``[offsets[g], offsets[g+1])`` of both the activation
``x`` [M, K] and the upstream gradient ``dy`` [M, N].  This is the last
GEMM of the training step's backward; it shares the forward's
:class:`~repro_torch.kernels.plan.TilePlan` (only its group offsets
matter here).  Rows at or beyond ``sum(group_sizes)`` are excluded, and
groups with no rows come back exactly zero.

Two operand precisions:
  * :func:`gmm_wgrad`: bf16 operands, f32 accumulation (the DeepSeek-V3
    recipe keeps the wgrad at the highest precision); the default.  Its
    kernel writes dw in f32 or bf16 (the f32 sum rounded once), so the
    training path takes dw in the weights' dtype with no cast pass.
  * :func:`gmm_wgrad_fp8`: e4m3 operands with their 1x128 tile scales,
    the forward's ``(a8, s_a)`` and the dgrad's ``(d8, s_d)``, dequantized
    in the kernel (arXiv 2505.20524's all-fp8 step); its kernel too
    writes dw in f32 or bf16.

``n_span`` / ``k_span`` are a :class:`KernelConfig`'s multi-tile wgrad
spans: K and N must be multiples of the span-widened tiles, and the plain
versions compute the same dw for any span.  The CUDA kernels take the JAX
package's pool geometries (``resources.WGRAD_GEOMETRIES``: span 1 at
``block_n`` 128 and 256, ``n_span = k_span`` 2 and 4 at ``block_n`` 128),
each super-tile on a thread-block cluster whose CTAs share operand
stages by TMA multicast (``resources.wgrad_cluster``), bitwise span 1;
any other geometry raises with its reason before any launch, never run
as span 1 in its place.

Each ``*_cuda`` wrapper counts its launches in ``launches`` and, by
``(block_n, n_span, k_span)``, in ``launches_by_geometry``.

Each public function chooses by its tensor: a ``FakeTensor`` goes to the
``*_abstract`` version (shape-only, :mod:`~repro_torch.kernels.abstract`),
a CPU tensor to the plain version, a CUDA tensor to the ``*_cuda``
wrapper, which launches the kernel or raises.
"""
from __future__ import annotations

import collections
import ctypes
from typing import Optional

import torch

from repro_torch.kernels import abstract, build, resources
from repro_torch.kernels.plan import QUANT_BLOCK, KernelConfig, TilePlan, \
    device_spec, wgrad_work
from repro_torch.kernels.ref import FP8, wgrad_exact_ref, \
    wgrad_fp8_exact_ref

_P, _I = ctypes.c_void_p, ctypes.c_int


def _prepare(m, k, m2, n, group_sizes, num_groups, block_m, block_n,
             block_k, plan, n_span=1, k_span=1):
    """Shape checks (K and N multiples of the span-widened tiles); returns
    ``(num_groups, offsets [G+1] int32)``."""
    if m != m2:
        raise ValueError(f"x and dy disagree on M: x is [M={m}, K={k}] but "
                         f"dy is [M={m2}, N={n}]")
    num_groups = num_groups or group_sizes.shape[0]
    KernelConfig(block_m=block_m, block_n=block_n, block_k=block_k,
                 n_span=n_span, k_span=k_span).validate(m, k, n,
                                                        family="wgrad")
    if plan is not None:
        plan.check_against(m, plan.block_m, num_groups)
        return num_groups, plan.group_offsets
    sizes = group_sizes.to(torch.int64)
    offsets = torch.cat([torch.zeros(1, dtype=torch.int64,
                                     device=sizes.device),
                         torch.cumsum(sizes, 0)])
    return num_groups, offsets.to(torch.int32)


def _check_scales(m, k, n, s_x, s_dy):
    if tuple(s_x.shape) != (m, k // QUANT_BLOCK):
        raise ValueError(f"s_x must be [M={m}, K/{QUANT_BLOCK}="
                         f"{k // QUANT_BLOCK}], got {tuple(s_x.shape)}")
    if tuple(s_dy.shape) != (m, n // QUANT_BLOCK):
        raise ValueError(f"s_dy must be [M={m}, N/{QUANT_BLOCK}="
                         f"{n // QUANT_BLOCK}], got {tuple(s_dy.shape)}")


def gmm_wgrad_plain(x, dy, group_sizes, *, num_groups: Optional[int] = None,
                    block_m: int = 128, block_n: int = 128,
                    block_k: int = 128,
                    out_dtype: torch.dtype = torch.float32,
                    plan: Optional[TilePlan] = None, n_span: int = 1,
                    k_span: int = 1) -> torch.Tensor:
    """The kernel's function in PyTorch ops: the checks of
    :func:`gmm_wgrad` around :func:`~repro_torch.kernels.ref.wgrad_exact_ref`
    (one f32 product per group).  Same signature as :func:`gmm_wgrad`."""
    (m, k), (m2, n) = x.shape, dy.shape
    num_groups, _ = _prepare(m, k, m2, n, group_sizes, num_groups,
                             block_m, block_n, block_k, plan, n_span, k_span)
    return wgrad_exact_ref(x, dy, group_sizes, num_groups=num_groups,
                           out_dtype=out_dtype)


def gmm_wgrad_fp8_plain(x_fp8, s_x, dy_fp8, s_dy, group_sizes, *,
                        num_groups: Optional[int] = None, block_m: int = 128,
                        block_n: int = 128, block_k: int = 128,
                        out_dtype: torch.dtype = torch.float32,
                        plan: Optional[TilePlan] = None, n_span: int = 1,
                        k_span: int = 1) -> torch.Tensor:
    """The fp8 kernel's function in PyTorch ops: the checks of
    :func:`gmm_wgrad_fp8` around
    :func:`~repro_torch.kernels.ref.wgrad_fp8_exact_ref` (both operands
    dequantized in f32, then the f32 contraction).  Same signature as
    :func:`gmm_wgrad_fp8`."""
    (m, k), (m2, n) = x_fp8.shape, dy_fp8.shape
    num_groups, _ = _prepare(m, k, m2, n, group_sizes, num_groups,
                             block_m, block_n, block_k, plan, n_span, k_span)
    _check_scales(m, k, n, s_x, s_dy)
    return wgrad_fp8_exact_ref(x_fp8, s_x, dy_fp8, s_dy, group_sizes,
                               num_groups=num_groups, out_dtype=out_dtype)


def _check_geometry(block_n, block_k, n_span, k_span):
    """Raise for a geometry the kernels are not built for, before the
    shapes or the device are looked at: never dropped to span 1 quietly,
    or a tuned span would lie."""
    reason = resources.missing_variant("wgrad", {
        "block_m": 128, "block_n": block_n, "block_k": block_k,
        "n_span": n_span, "k_span": k_span})
    if reason is not None:
        raise ValueError(reason)


def _check_cuda(operands):
    dev = operands[0][1].device
    for name, t, dt in operands:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name} must be a CUDA tensor on {dev}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    return dev


#: output dtypes the wgrad kernels write
WGRAD_OUT_DTYPES = (torch.float32, torch.bfloat16)


def _launch(lib, symbol, argtypes, ptrs, m, k, n, num_groups, dev,
            out_dtype, what, extra=()):
    """Allocate dw [G, K, N] in ``out_dtype`` and launch ``symbol`` of
    ``csrc/<lib>.cu`` with ``ptrs``, dw, the shapes and ``extra`` (the
    f32 flag and the geometry); returns ``(dw, launched)``."""
    dw = torch.empty((num_groups, k, n), dtype=out_dtype, device=dev)
    if m == 0 or num_groups == 0:
        return dw.zero_(), False
    fn = build.function(lib, symbol, argtypes)
    status = fn(*ptrs, dw.data_ptr(), m, k, n, num_groups, *extra,
                build.stream_ptr(dev))
    build.check(status, what)
    return dw, True


def _count(wrapper, launched, geometry):
    """Add a launch of ``wrapper`` at ``geometry`` to its counts."""
    wrapper.launches += launched
    if launched:
        wrapper.launches_by_geometry[geometry] += 1


def gmm_wgrad_cuda(x, dy, group_sizes, *, num_groups: Optional[int] = None,
                   block_m: int = 128, block_n: int = 128,
                   block_k: int = 128,
                   out_dtype: torch.dtype = torch.float32,
                   plan: Optional[TilePlan] = None, n_span: int = 1,
                   k_span: int = 1) -> torch.Tensor:
    """Launch B4 (one launch for every group) on bf16 CUDA tensors, at a
    pool geometry (``block_n``, ``n_span``, ``k_span``).  The kernel
    writes dw in ``out_dtype``, f32 or bf16: its f32 sum rounded once to
    nearest."""
    if out_dtype not in WGRAD_OUT_DTYPES:
        raise TypeError(f"gmm_wgrad_cuda writes dw in {WGRAD_OUT_DTYPES}, "
                        f"not {out_dtype}")
    _check_geometry(block_n, block_k, n_span, k_span)
    (m, k), (m2, n) = x.shape, dy.shape
    num_groups, offsets = _prepare(m, k, m2, n, group_sizes, num_groups,
                                   block_m, block_n, block_k, plan, n_span,
                                   k_span)
    dev = _check_cuda((
        ("x", x, torch.bfloat16), ("dy", dy, torch.bfloat16),
        ("group offsets", offsets, torch.int32)))
    dw, launched = _launch(
        "wgrad_bf16", "wgrad_bf16", [_P] * 4 + [_I] * 8 + [_P],
        (x.data_ptr(), dy.data_ptr(), offsets.data_ptr()),
        m, k, n, num_groups, dev, out_dtype, "gmm_wgrad",
        extra=(int(out_dtype == torch.float32), block_n, n_span, k_span))
    _count(gmm_wgrad_cuda, launched, (block_n, n_span, k_span))
    return dw


gmm_wgrad_cuda.launches = 0
gmm_wgrad_cuda.launches_by_geometry = collections.Counter()


def gmm_wgrad_fp8_cuda(x_fp8, s_x, dy_fp8, s_dy, group_sizes, *,
                       num_groups: Optional[int] = None, block_m: int = 128,
                       block_n: int = 128, block_k: int = 128,
                       out_dtype: torch.dtype = torch.float32,
                       plan: Optional[TilePlan] = None, n_span: int = 1,
                       k_span: int = 1) -> torch.Tensor:
    """Launch B6 (one launch for every group) on e4m3 CUDA tensors and
    their f32 1x128 scales, at a pool geometry as B4.  The kernel writes
    dw in ``out_dtype``, f32 or bf16: its f32 sum rounded once to
    nearest."""
    if out_dtype not in WGRAD_OUT_DTYPES:
        raise TypeError(f"gmm_wgrad_fp8_cuda writes dw in {WGRAD_OUT_DTYPES}, "
                        f"not {out_dtype}")
    _check_geometry(block_n, block_k, n_span, k_span)
    (m, k), (m2, n) = x_fp8.shape, dy_fp8.shape
    num_groups, offsets = _prepare(m, k, m2, n, group_sizes, num_groups,
                                   block_m, block_n, block_k, plan, n_span,
                                   k_span)
    _check_scales(m, k, n, s_x, s_dy)
    dev = _check_cuda((
        ("x_fp8", x_fp8, FP8), ("s_x", s_x, torch.float32),
        ("dy_fp8", dy_fp8, FP8), ("s_dy", s_dy, torch.float32),
        ("group offsets", offsets, torch.int32)))
    dw, launched = _launch(
        "wgrad", "wgrad_fp8", [_P] * 6 + [_I] * 8 + [_P],
        (x_fp8.data_ptr(), s_x.data_ptr(), dy_fp8.data_ptr(),
         s_dy.data_ptr(), offsets.data_ptr()),
        m, k, n, num_groups, dev, out_dtype, "gmm_wgrad_fp8",
        extra=(int(out_dtype == torch.float32), block_n, n_span, k_span))
    _count(gmm_wgrad_fp8_cuda, launched, (block_n, n_span, k_span))
    return dw


gmm_wgrad_fp8_cuda.launches = 0
gmm_wgrad_fp8_cuda.launches_by_geometry = collections.Counter()


def _abstract(name, m, k, n, num_groups, block_m, block_n, block_k,
              n_span, k_span, out_dtype, precision, like):
    """The shape-only wgrad: dw [G, K, N] in ``out_dtype`` and the work of
    ``plan.wgrad_work`` at the static M."""
    cfg = KernelConfig(block_m=block_m, block_n=block_n, block_k=block_k,
                       n_span=n_span, k_span=k_span)
    abstract.count(name, *wgrad_work(m, k, n, num_groups, cfg,
                                     device_spec("nvidia h100"), precision,
                                     dw_itemsize=out_dtype.itemsize))
    return like.new_empty((num_groups, k, n), dtype=out_dtype)


def gmm_wgrad_abstract(x, dy, group_sizes, *,
                       num_groups: Optional[int] = None, block_m: int = 128,
                       block_n: int = 128, block_k: int = 128,
                       out_dtype: torch.dtype = torch.float32,
                       plan: Optional[TilePlan] = None, n_span: int = 1,
                       k_span: int = 1) -> torch.Tensor:
    """Shape-only :func:`gmm_wgrad` (:mod:`~repro_torch.kernels.abstract`):
    its checks, dw [G, K, N] in ``out_dtype`` and B4's work at the static
    M; reads nothing to the host."""
    (m, k), (m2, n) = x.shape, dy.shape
    num_groups, _ = _prepare(m, k, m2, n, group_sizes, num_groups,
                             block_m, block_n, block_k, plan, n_span, k_span)
    return _abstract("gmm_wgrad", m, k, n, num_groups, block_m, block_n,
                     block_k, n_span, k_span, out_dtype, "bf16", x)


def gmm_wgrad_fp8_abstract(x_fp8, s_x, dy_fp8, s_dy, group_sizes, *,
                           num_groups: Optional[int] = None,
                           block_m: int = 128, block_n: int = 128,
                           block_k: int = 128,
                           out_dtype: torch.dtype = torch.float32,
                           plan: Optional[TilePlan] = None, n_span: int = 1,
                           k_span: int = 1) -> torch.Tensor:
    """Shape-only :func:`gmm_wgrad_fp8`: its checks, dw [G, K, N] in
    ``out_dtype`` and B6's work at the static M; reads nothing."""
    (m, k), (m2, n) = x_fp8.shape, dy_fp8.shape
    num_groups, _ = _prepare(m, k, m2, n, group_sizes, num_groups,
                             block_m, block_n, block_k, plan, n_span, k_span)
    _check_scales(m, k, n, s_x, s_dy)
    return _abstract("gmm_wgrad_fp8", m, k, n, num_groups, block_m,
                     block_n, block_k, n_span, k_span, out_dtype, "fp8",
                     x_fp8)


def gmm_wgrad(x, dy, group_sizes, *, num_groups: Optional[int] = None,
              block_m: int = 128, block_n: int = 128, block_k: int = 128,
              out_dtype: torch.dtype = torch.float32,
              plan: Optional[TilePlan] = None, n_span: int = 1,
              k_span: int = 1) -> torch.Tensor:
    """Padding-free ragged-contraction grouped GEMM, bf16 operands.

    x [M, K], dy [M, N], group_sizes [G] int with ``sum <= M``; rows
    beyond the last group, and whatever they hold, are excluded.
    ``plan``: the forward's :class:`TilePlan` of these ``group_sizes``
    (its offsets are used; built from ``group_sizes`` when absent).
    Returns [G, K, N] ``out_dtype`` with f32 accumulation; empty groups
    are exactly zero.
    """
    fn = gmm_wgrad_abstract if abstract.is_fake(x) else \
        gmm_wgrad_cuda if x.is_cuda else gmm_wgrad_plain
    return fn(x, dy, group_sizes, num_groups=num_groups, block_m=block_m,
              block_n=block_n, block_k=block_k, out_dtype=out_dtype,
              plan=plan, n_span=n_span, k_span=k_span)


def gmm_wgrad_fp8(x_fp8, s_x, dy_fp8, s_dy, group_sizes, *,
                  num_groups: Optional[int] = None, block_m: int = 128,
                  block_n: int = 128, block_k: int = 128,
                  out_dtype: torch.dtype = torch.float32,
                  plan: Optional[TilePlan] = None, n_span: int = 1,
                  k_span: int = 1) -> torch.Tensor:
    """:func:`gmm_wgrad` on e4m3 operands: x_fp8 [M, K] with s_x [M, K/128]
    and dy_fp8 [M, N] with s_dy [M, N/128], each row dequantized by its
    own 1x128 scales before the f32-accumulated contraction."""
    fn = gmm_wgrad_fp8_abstract if abstract.is_fake(x_fp8) else \
        gmm_wgrad_fp8_cuda if x_fp8.is_cuda else gmm_wgrad_fp8_plain
    return fn(x_fp8, s_x, dy_fp8, s_dy, group_sizes, num_groups=num_groups,
              block_m=block_m, block_n=block_n, block_k=block_k,
              out_dtype=out_dtype, plan=plan, n_span=n_span, k_span=k_span)
