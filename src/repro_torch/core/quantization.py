"""FP8 quantization of activations and weights.

1x128 per-tile activation quant + 128x128 per-block weight quant, the
paper's (= DeepSeek-V3's) scheme.

:class:`QuantizedActivation` is the quantize-once record: one
``quantize_tilewise`` of a shared activation buffer, handed to every GEMM
that consumes the same buffer (the MoE gate and up projections).

The tilewise and fused quantizers reach their kernels through the kernel
modules' attributes (``quant_kernel.quantize_tilewise``,
``epilogue_kernel.act_quantize``), which choose by the tensor's device.
The blockwise weight quantizer is plain PyTorch: it is no kernel in the
JAX package either.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.analysis import events as _events
from repro_torch.kernels import epilogue_kernel, quant_kernel
from repro_torch.kernels import ref as kref

QUANT_BLOCK = 128  # the paper's 1x128 / 128x128 quantization granularity


@dataclasses.dataclass(frozen=True)
class QuantizedActivation:
    """1x128-tile fp8 representation of one activation buffer.

    ``q``: [M, K] e4m3; ``scale``: [M, K/128] f32 with
    ``x ~= q * repeat(scale, 128, dim=1)``.

    CONTRACT: a record is only valid for the exact buffer it was built
    from; build it with :func:`quantize_activation` where the buffer is
    produced and never cache it across routing decisions.
    """
    q: torch.Tensor
    scale: torch.Tensor


def quantize_tilewise(x: torch.Tensor):
    """[M, K] f32 -> (e4m3 [M, K], f32 [M, K/128]).  The backward's
    quantizations of ``dy`` come through here too."""
    # one event per STANDALONE tilewise quantization: the quantize-once
    # counts read these; the fused epilogue quantizes in its kernel
    _events.emit("quantize_tilewise", shape=tuple(x.shape))
    return quant_kernel.quantize_tilewise(x)


def quantize_activation(x: torch.Tensor) -> QuantizedActivation:
    """ONE ``quantize_tilewise`` of ``x`` (cast to f32, as the reference
    does), wrapped as the shareable record.  Like the reference's
    ``stop_gradient`` producer, the record carries no gradient: the
    layers consuming it return x's gradient through their dgrad."""
    q8, s = quantize_tilewise(x.detach().float().contiguous())
    return QuantizedActivation(q8, s)


def fused_act_quantize(g, u=None, *, act="silu_mul") -> QuantizedActivation:
    """Fused producer: activation + ONE tilewise quantization, with no
    intermediate ``h`` in memory.  bf16 inputs go to the kernel as they
    are (their upcast to f32 is exact and happens in registers)."""
    q8, s = epilogue_kernel.act_quantize(
        g.contiguous(), None if u is None else u.contiguous(), act=act)
    return QuantizedActivation(q8, s)


def fused_act_quantize_fp8(g8, s_g, u8=None, s_u=None, *,
                           act="silu_mul") -> QuantizedActivation:
    """Fused producer epilogue on fp8 operands: the gate/up GEMMs' fp8
    payloads and 1x128 scales (from the quantizing grouped GEMM) are
    dequantized on load, so the bf16 g/u never exist.  They come out of a
    non-differentiable producer; gradients reach the FFN's inputs through
    its backward's activation recompute."""
    q8, s = epilogue_kernel.act_quantize(g8, u8, s_g=s_g, s_u=s_u, act=act)
    return QuantizedActivation(q8, s)


def quantize_blockwise(w: torch.Tensor):
    """[K, N] -> (e4m3 [K, N], f32 [K/128, N/128])."""
    return kref.quantize_blockwise_ref(w)


def quantize_blockwise_batched(w: torch.Tensor):
    """[G, K, N] -> (e4m3 [G, K, N], f32 [G, K/128, N/128])."""
    return kref.quantize_blockwise_ref(w)
