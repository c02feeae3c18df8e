"""Fused activation -> 1x128 per-tile fp8 quantization: the CUDA kernel
(``csrc/act_quant.cu``) and its plain PyTorch version.

One pass reads the gate/up GEMM outputs, computes the activation per
element in f32 and emits the fp8 payload plus 1x128 scales directly: the
activation ``h`` never touches device memory.  The scale layout is the
quantizer's (``[M, K/128]`` f32), so every GEMM consumer accepts it.

Supported activations:
  - ``silu_mul``: ``silu(g) * u`` (the SwiGLU expert FFN epilogue)
  - ``gelu``: unary tanh ``gelu(g)`` (``u`` must be None)

The fp8-input mode (dequantize g/u on load) belongs to the fused-producer
path and is not ported yet.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import ACTIVATIONS, FP8, QUANT_BLOCK, \
    act_quantize_ref

_P, _I = ctypes.c_void_p, ctypes.c_int


def _check(g, u, act, s_g, s_u) -> None:
    if act not in ACTIVATIONS:
        raise ValueError(f"unknown activation {act!r}; expected {ACTIVATIONS}")
    if s_g is not None or s_u is not None:
        raise NotImplementedError(
            "fp8-input (dequantize-on-load) act_quantize belongs to the "
            "fused-producer path, which is not ported yet (ROADMAP A8)")
    if act == "silu_mul":
        if u is None:
            raise ValueError("act='silu_mul' needs both g and u")
        if u.shape != g.shape:
            raise ValueError(f"g {tuple(g.shape)} and u {tuple(u.shape)} must match")
    elif u is not None:
        raise ValueError(f"act={act!r} is unary; got a second operand")
    if g.dim() != 2 or g.shape[1] % QUANT_BLOCK != 0:
        raise ValueError(f"g must be [M, K] with K % {QUANT_BLOCK} == 0, "
                         f"got {tuple(g.shape)}")


def act_quantize_plain(g, u=None, *, act: str = "silu_mul"):
    """The activation in f32 (``ref.act_f32``: silu as ``g * sigmoid(g)``,
    gelu in its tanh form), then the 1x128 quantizer's arithmetic: the
    oracle ``ref.act_quantize_ref``."""
    return act_quantize_ref(g, u, act)


def act_quantize_cuda(g, u=None, *, act: str = "silu_mul"):
    """Launch the fused CUDA epilogue on bf16 or f32 CUDA tensors."""
    _check(g, u, act, None, None)
    ops = (g,) if u is None else (g, u)
    for t in ops:
        if not t.is_cuda or t.device != g.device:
            raise ValueError("act_quantize_cuda needs CUDA tensors on one device")
        if t.dtype not in (torch.bfloat16, torch.float32) or t.dtype != g.dtype:
            raise TypeError(f"g/u must both be bf16 or both f32, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("g/u must be contiguous and 16-byte aligned")
    m, k = g.shape
    q = torch.empty((m, k), dtype=FP8, device=g.device)
    s = torch.empty((m, k // QUANT_BLOCK), dtype=torch.float32, device=g.device)
    if m == 0:
        return q, s
    fn = build.function("act_quant", "act_quantize", [_P] * 4 + [_I] * 4 + [_P])
    status = fn(g.data_ptr(), None if u is None else u.data_ptr(),
                q.data_ptr(), s.data_ptr(), m, k,
                0 if act == "silu_mul" else 1,
                1 if g.dtype == torch.bfloat16 else 0,
                build.stream_ptr(g.device))
    build.check(status, "act_quantize")
    act_quantize_cuda.launches += 1
    return q, s


act_quantize_cuda.launches = 0


def act_quantize(g, u=None, *, s_g=None, s_u=None, act: str = "silu_mul"):
    """g (and u for silu_mul): [M, K], K % 128 == 0, bf16 or f32.
    Returns ``(q[M, K] e4m3, s[M, K/128] f32)``."""
    _check(g, u, act, s_g, s_u)
    if g.is_cuda:
        return act_quantize_cuda(g, u, act=act)
    return act_quantize_plain(g, u, act=act)
