"""Fused activation -> 1x128 per-tile fp8 quantization: the CUDA kernel
(``csrc/act_quant.cu``) and its plain PyTorch version.

One pass reads the gate/up GEMM outputs, computes the activation per
element in f32 and emits the fp8 payload plus 1x128 scales directly: the
activation ``h`` never touches device memory.  The scale layout is the
quantizer's (``[M, K/128]`` f32), so every GEMM consumer accepts it.

Supported activations:
  - ``silu_mul``: ``silu(g) * u`` (the SwiGLU expert FFN epilogue)
  - ``gelu``: unary tanh ``gelu(g)`` (``u`` must be None)

Two input modes: bf16 or f32 operands, or (the fused-producer path) e4m3
operands with their 1x128 scales ``s_g``/``s_u``, dequantized on load as
``float(q) * s``, so the activation runs on exactly the values the
quantizing GEMM kept.

:func:`act_quantize` chooses by its tensor: a ``FakeTensor`` goes to
:func:`act_quantize_abstract` (shape-only,
:mod:`~repro_torch.kernels.abstract`), a CPU tensor to the plain version,
a CUDA tensor to :func:`act_quantize_cuda`, which launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import abstract, build
from repro_torch.kernels.plan import act_quant_bytes
from repro_torch.kernels.ref import ACTIVATIONS, FP8, QUANT_BLOCK, \
    act_quantize_ref, dequantize_tilewise_ref

_P, _I = ctypes.c_void_p, ctypes.c_int


def _check(g, u, act, s_g, s_u) -> None:
    """The reference's argument checks."""
    if act not in ACTIVATIONS:
        raise ValueError(f"unknown activation {act!r}; expected {ACTIVATIONS}")
    if act == "silu_mul":
        if u is None:
            raise ValueError("act='silu_mul' needs both g and u")
        if u.shape != g.shape:
            raise ValueError(f"g {tuple(g.shape)} and u {tuple(u.shape)} must match")
    elif u is not None:
        raise ValueError(f"act={act!r} is unary; got a second operand")
    if s_g is not None and u is not None and s_u is None:
        raise ValueError("fp8 inputs need scales for both operands "
                         "(got s_g but not s_u)")
    if s_g is None and s_u is not None:
        raise ValueError("got s_u without s_g")
    if g.dim() != 2 or g.shape[1] % QUANT_BLOCK != 0:
        raise ValueError(f"g must be [M, K] with K % {QUANT_BLOCK} == 0, "
                         f"got {tuple(g.shape)}")
    m, k = g.shape
    for name, sc in (("s_g", s_g), ("s_u", s_u)):
        if sc is not None and tuple(sc.shape) != (m, k // QUANT_BLOCK):
            raise ValueError(
                f"{name} has shape {tuple(sc.shape)}; fp8 operands of shape "
                f"{(m, k)} need 1x128 scales of shape {(m, k // QUANT_BLOCK)}")


def act_quantize_plain(g, u=None, *, s_g=None, s_u=None,
                       act: str = "silu_mul"):
    """fp8 operands dequantized (``ref.dequantize_tilewise_ref``), the
    activation in f32 (``ref.act_f32``: silu as ``g * sigmoid(g)``, gelu
    in its tanh form), then the 1x128 quantizer's arithmetic: the oracle
    ``ref.act_quantize_ref``."""
    if s_g is not None:
        g = dequantize_tilewise_ref(g, s_g)
        u = None if u is None else dequantize_tilewise_ref(u, s_u)
    return act_quantize_ref(g, u, act)


def act_quantize_cuda(g, u=None, *, s_g=None, s_u=None,
                      act: str = "silu_mul"):
    """Launch the fused CUDA epilogue on bf16 or f32 CUDA tensors, or on
    e4m3 ones with their f32 scales.  Launches are counted per input
    mode: ``launches`` (bf16/f32) and ``fp8_launches``."""
    _check(g, u, act, s_g, s_u)
    fp8 = s_g is not None
    ops = [("g", g), ("u", u), ("s_g", s_g), ("s_u", s_u)]
    for name, t in ops:
        if t is None:
            continue
        if not t.is_cuda or t.device != g.device:
            raise ValueError("act_quantize_cuda needs CUDA tensors on one device")
        if name.startswith("s_"):
            want = (torch.float32,)
        elif fp8:
            want = (FP8,)
        else:
            want = (torch.bfloat16, torch.float32)
        if t.dtype not in want or (name == "u" and t.dtype != g.dtype):
            raise TypeError(f"{name} must be one of {want} (g and u alike), "
                            f"got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    m, k = g.shape
    q = torch.empty((m, k), dtype=FP8, device=g.device)
    s = torch.empty((m, k // QUANT_BLOCK), dtype=torch.float32, device=g.device)
    if m == 0:
        return q, s
    fn = build.function("act_quant", "act_quantize", [_P] * 6 + [_I] * 4 + [_P])

    def ptr(t):
        return None if t is None else t.data_ptr()
    in_kind = 2 if fp8 else (1 if g.dtype == torch.bfloat16 else 0)
    status = fn(g.data_ptr(), ptr(u), ptr(s_g), ptr(s_u), q.data_ptr(),
                s.data_ptr(), m, k, 0 if act == "silu_mul" else 1, in_kind,
                build.stream_ptr(g.device))
    build.check(status, "act_quantize")
    # one count per input mode: bf16/f32 operands, fp8 operands
    if fp8:
        act_quantize_cuda.fp8_launches += 1
    else:
        act_quantize_cuda.launches += 1
    return q, s


act_quantize_cuda.launches = 0
act_quantize_cuda.fp8_launches = 0


def act_quantize_abstract(g, u=None, *, s_g=None, s_u=None,
                          act: str = "silu_mul"):
    """Shape-only :func:`act_quantize`: its checks, the [M, K] e4m3 payload
    and [M, K/128] f32 scales, and the pass's bytes
    (``plan.act_quant_bytes``: one or two operands, bf16 / f32, or e4m3
    with scales; no operations counted), under ``act_quantize`` or, for
    fp8 operands, ``act_quantize_fp8``; reads nothing."""
    _check(g, u, act, s_g, s_u)
    m, k = g.shape
    q = g.new_empty((m, k), dtype=FP8)
    s = g.new_empty((m, k // QUANT_BLOCK), dtype=torch.float32)
    fp8 = s_g is not None
    abstract.count("act_quantize_fp8" if fp8 else "act_quantize", 0.0,
                   act_quant_bytes(m, k, g.element_size(), in_scales=fp8,
                                   operands=1 if u is None else 2))
    return q, s


def act_quantize(g, u=None, *, s_g=None, s_u=None, act: str = "silu_mul"):
    """g (and u for silu_mul): [M, K], K % 128 == 0: bf16 or f32, or e4m3
    with 1x128 scales ``s_g`` (and ``s_u``) of shape [M, K/128] f32.
    Returns ``(q[M, K] e4m3, s[M, K/128] f32)``."""
    _check(g, u, act, s_g, s_u)
    fn = act_quantize_abstract if abstract.is_fake(g) else \
        act_quantize_cuda if g.is_cuda else act_quantize_plain
    return fn(g, u, s_g=s_g, s_u=s_u, act=act)
