"""1x128 per-tile fp8 activation quantization: the CUDA kernel
(``csrc/quant.cu``) and its plain PyTorch version.

This is the producer of the grouped GEMM's ``(a_fp8, s_a)`` operands.
Per-row scale layout contract (shared by every consumer): the scales are
``[M, K/128]`` f32, one per 1x128 tile of the row.

:func:`quantize_tilewise` chooses by its tensor: a ``FakeTensor`` goes
to :func:`quantize_tilewise_abstract` (shape-only,
:mod:`~repro_torch.kernels.abstract`), a CPU tensor to
:func:`quantize_tilewise_plain`, a CUDA tensor to
:func:`quantize_tilewise_cuda`, which launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import abstract, build
from repro_torch.kernels.plan import quantize_bytes
from repro_torch.kernels.ref import FP8, QUANT_BLOCK, quantize_tilewise_ref

_P, _I = ctypes.c_void_p, ctypes.c_int


def quantize_tilewise_plain(x: torch.Tensor):
    """The kernel's arithmetic in PyTorch ops (the oracle
    ``ref.quantize_tilewise_ref``): per 1x128 tile, ``scale = amax *
    f32(1/448)`` (1 for an all-zero tile), then ``q = x / scale`` rounded
    to e4m3."""
    return quantize_tilewise_ref(x)


def _check(x: torch.Tensor) -> None:
    if x.dim() != 2:
        raise ValueError(f"x must be [M, K], got shape {tuple(x.shape)}")
    if x.shape[1] % QUANT_BLOCK != 0:
        raise ValueError(f"K={x.shape[1]} must be a multiple of {QUANT_BLOCK}")


def quantize_tilewise_cuda(x: torch.Tensor):
    """Launch the CUDA quantizer on ``x`` [M, K] f32 (contiguous, on a
    CUDA device).  Allocates the outputs; runs on the current stream."""
    _check(x)
    if not x.is_cuda:
        raise ValueError("quantize_tilewise_cuda needs a CUDA tensor")
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous and 16-byte aligned")
    m, k = x.shape
    q = torch.empty((m, k), dtype=FP8, device=x.device)
    s = torch.empty((m, k // QUANT_BLOCK), dtype=torch.float32, device=x.device)
    if m == 0:
        return q, s
    fn = build.function("quant", "quantize_tilewise_f32",
                        [_P] * 3 + [_I] * 2 + [_P])
    status = fn(x.data_ptr(), q.data_ptr(), s.data_ptr(), m, k,
                build.stream_ptr(x.device))
    build.check(status, "quantize_tilewise")
    quantize_tilewise_cuda.launches += 1
    return q, s


quantize_tilewise_cuda.launches = 0


def quantize_tilewise_abstract(x: torch.Tensor):
    """Shape-only :func:`quantize_tilewise`: its checks, the [M, K] e4m3
    payload and [M, K/128] f32 scales, and the pass's bytes
    (``plan.quantize_bytes``; no operations counted); reads nothing."""
    _check(x)
    m, k = x.shape
    q = x.new_empty((m, k), dtype=FP8)
    s = x.new_empty((m, k // QUANT_BLOCK), dtype=torch.float32)
    abstract.count("quantize_tilewise", 0.0, quantize_bytes(m, k))
    return q, s


def quantize_tilewise(x: torch.Tensor):
    """x: [M, K] f32, K % 128 == 0 -> (q [M, K] e4m3, s [M, K/128] f32)."""
    _check(x)
    if abstract.is_fake(x):
        return quantize_tilewise_abstract(x)
    if x.is_cuda:
        return quantize_tilewise_cuda(x)
    return quantize_tilewise_plain(x)
