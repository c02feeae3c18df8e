"""Padding-free FP8 grouped linear layers, forward only.

``grouped_linear(x, w, group_sizes)`` computes ``y[rows of group g] =
x[rows of g] @ w[g]`` over the unpadded concatenated token buffer: x is
quantized 1x128 tilewise (or comes quantized, see ``quantized=``), w is
quantized 128x128 blockwise on every call, as in the reference, and the
product runs on the padding-free grouped GEMM.  ``grouped_linear_fused``
takes the gate/up outputs instead of x and runs the fused
activation->quantize epilogue in front of the GEMM.

These are plain functions for inference; call them under
``torch.inference_mode()``.  The differentiable versions come with the
training slice.  The kernels are reached through
``grouped_gemm_kernel.gmm``, which chooses by the tensor's device.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import quantization as q
from repro_torch.kernels import grouped_gemm_kernel
from repro_torch.kernels.epilogue_kernel import ACTIVATIONS
from repro_torch.kernels.plan import KernelConfig, TilePlan, make_tile_plan, \
    resolve_config


def _gemm(a8, sa, w, group_sizes, cfg: KernelConfig, plan: Optional[TilePlan]):
    b8, sb = q.quantize_blockwise_batched(w)
    if plan is None:
        plan = make_tile_plan(group_sizes, a8.shape[0], block_m=cfg.block_m,
                              num_groups=w.shape[0])
    return grouped_gemm_kernel.gmm(
        a8, sa, b8, sb, group_sizes, num_groups=w.shape[0],
        block_m=cfg.block_m, block_n=cfg.block_n, block_k=cfg.block_k,
        out_dtype=cfg.out_dtype, plan=plan)


def grouped_linear(x: torch.Tensor, w: torch.Tensor,
                   group_sizes: torch.Tensor, *, precision: str = "bf16",
                   out_dtype: Optional[torch.dtype] = None,
                   config: Optional[KernelConfig] = None,
                   plan: Optional[TilePlan] = None,
                   quantized: Optional[q.QuantizedActivation] = None
                   ) -> torch.Tensor:
    """x: [M, K]; w: [G, K, N]; group_sizes: [G] with ``sum <= M``.  Rows
    beyond the last group come back as zeros.

    ``plan``: the routing decision's :class:`TilePlan`, shared by every
    GEMM with these ``group_sizes``.  ``quantized``: the
    :class:`~repro_torch.core.quantization.QuantizedActivation` of exactly
    this ``x``, shared by every GEMM that consumes it.  ``out_dtype``:
    explicit > the config's > ``x.dtype``.
    """
    if precision != "fp8":
        raise NotImplementedError(
            f"grouped_linear(precision={precision!r}): only the fp8 path is "
            "ported; the bf16 grouped GEMM kernel is ROADMAP A8")
    cfg = resolve_config(config, out_dtype=out_dtype)
    if cfg.out_dtype is None:
        cfg = cfg.with_(out_dtype=x.dtype)
    if quantized is None:
        quantized = q.quantize_activation(x)
    return _gemm(quantized.q, quantized.scale, w, group_sizes, cfg, plan)


def dense_linear_fp8(x: torch.Tensor, w: torch.Tensor, *,
                     out_dtype: Optional[torch.dtype] = None,
                     config: Optional[KernelConfig] = None,
                     plan: Optional[TilePlan] = None,
                     quantized: Optional[q.QuantizedActivation] = None
                     ) -> torch.Tensor:
    """The G=1 case: a DeepSeek-style fp8 linear for dense layers (the MoE
    shared experts).  ``plan``/``quantized`` forward so several GEMMs on
    one input share one G=1 plan and one quantization."""
    gs = torch.full((1,), x.shape[0], dtype=torch.int32, device=x.device)
    return grouped_linear(x, w[None], gs, precision="fp8",
                          out_dtype=out_dtype, config=config, plan=plan,
                          quantized=quantized)


def grouped_linear_fused(g: torch.Tensor, u: Optional[torch.Tensor],
                         w: torch.Tensor, group_sizes: torch.Tensor, *,
                         act: str = "silu_mul",
                         out_dtype: Optional[torch.dtype] = None,
                         config: Optional[KernelConfig] = None,
                         plan: Optional[TilePlan] = None) -> torch.Tensor:
    """``y[rows of g'] = act(g, u)[rows of g'] @ w[g']`` with ``act`` =
    ``silu(g)*u`` or unary ``gelu(g)``.  The activation and its 1x128
    quantization run as ONE fused pass; the down GEMM consumes its fp8
    output directly.  ``out_dtype``: explicit > the config's > ``g.dtype``.
    """
    if act not in ACTIVATIONS:
        raise ValueError(f"unknown activation {act!r}; "
                         f"expected one of {ACTIVATIONS}")
    if act == "silu_mul" and u is None:
        raise ValueError("act='silu_mul' needs both g and u")
    if act != "silu_mul" and u is not None:
        raise ValueError(f"act={act!r} is unary; got a second operand")
    cfg = resolve_config(config, out_dtype=out_dtype)
    if cfg.out_dtype is None:
        cfg = cfg.with_(out_dtype=g.dtype)
    qh = q.fused_act_quantize(g, u, act=act)
    return _gemm(qh.q, qh.scale, w, group_sizes, cfg, plan)


def dense_linear_fp8_fused(g: torch.Tensor, u: Optional[torch.Tensor],
                           w: torch.Tensor, *, act: str = "silu_mul",
                           out_dtype: Optional[torch.dtype] = None,
                           config: Optional[KernelConfig] = None,
                           plan: Optional[TilePlan] = None) -> torch.Tensor:
    """G=1 fused-epilogue fp8 linear (the shared-expert down projection).
    Leading dims of ``g``/``u`` are flattened to rows."""
    lead, f = g.shape[:-1], g.shape[-1]
    g2 = g.reshape(-1, f)
    u2 = None if u is None else u.reshape(-1, f)
    gs = torch.full((1,), g2.shape[0], dtype=torch.int32, device=g.device)
    y = grouped_linear_fused(g2, u2, w[None], gs, act=act,
                             out_dtype=out_dtype, config=config, plan=plan)
    return y.reshape(*lead, w.shape[-1])
