"""Differentiable padding-free grouped linear layers, fp8 and bf16.

``grouped_linear(x, w, group_sizes)`` computes ``y[rows of group g] =
x[rows of g] @ w[g]`` over the unpadded concatenated token buffer.  With
``precision="fp8"`` x is quantized 1x128 tilewise (or comes quantized,
see ``quantized=``), w is quantized 128x128 blockwise on every call, as
in the reference, and the product runs on the padding-free fp8 grouped
GEMM; with ``precision="bf16"`` both run as bf16 on the bf16 grouped
GEMM, the numerics baseline.  ``grouped_linear_fused`` takes the gate/up
outputs instead of x and runs the fused activation->quantize epilogue in
front of the GEMM.  ``grouped_linear_ffn`` is the whole expert FFN with
producer-side quantizing epilogues: the gate/up GEMMs store fp8 and the
activation dequantizes them on load, so g and u never exist wider than
fp8.

All are ``torch.autograd.Function``s that mirror the JAX package's
custom VJPs.  The fp8 backward quantizes ``dy`` 1x128 ONCE for both of
its GEMMs: the dgrad ``dx = dy @ w^T`` on the same fp8 grouped GEMM (w^T
re-quantized 128x128, f32 out) and the wgrad ``dw[g] = x_g^T dy_g`` on
the wgrad kernel, bf16 operands by default or, under
``KernelConfig.wgrad_precision="fp8"``, the fp8 operands the forward and
the dgrad already hold.  All GEMMs of a layer reuse one
:class:`TilePlan`.  The kernels are reached through the kernel modules'
attributes (``grouped_gemm_kernel.gmm``, ``wgrad_kernel.gmm_wgrad*``),
which choose by the tensor's device.  The config (tile shapes,
``backend``, ``wgrad_precision``) is read in the forward and kept for the
backward.

``KernelConfig.backend="padded_baseline"`` runs every fp8 GEMM of these
layers, forward and dgrad, through the paper's baseline
(:mod:`repro_torch.core.padding_baseline`: pad, the same fp8 grouped
GEMM, unpad) and builds no layer plan: each padded GEMM plans over its
padded sizes.  The quantizing GEMM becomes that GEMM, then the tilewise
quantizer, the JAX package's unfused composition.  The quantizers and
the wgrad keep their kernels, as the JAX package resolves a gemm-only
backend in those families; the bf16 path ignores the backend with a
warning, as the JAX package's does.
"""
from __future__ import annotations

import warnings
from typing import Optional

import torch

from repro_torch.analysis import events as _events
from repro_torch.core import padding_baseline
from repro_torch.core import quantization as q
from repro_torch.kernels import grouped_gemm_kernel, quant_kernel, \
    wgrad_kernel
from repro_torch.kernels import ref as kref
from repro_torch.kernels.epilogue_kernel import ACTIVATIONS
from repro_torch.kernels.plan import PADDED_BASELINE, KernelConfig, \
    TilePlan, make_tile_plan, resolve_config


def _plan(plan: Optional[TilePlan], group_sizes, m: int, cfg: KernelConfig,
          num_groups: int) -> Optional[TilePlan]:
    """The fp8 layer's plan, built here when absent; None under the padded
    baseline, whose GEMMs plan over their padded sizes and whose wgrads
    take the group offsets from the sizes."""
    if plan is None and cfg.backend != PADDED_BASELINE:
        plan = make_tile_plan(group_sizes, m, block_m=cfg.block_m,
                              num_groups=num_groups)
    return plan


def _gemm(a8, sa, w, group_sizes, cfg: KernelConfig, plan: TilePlan,
          out_dtype):
    """``a @ w[g]`` per group on the fp8 grouped GEMM, w quantized here;
    under the padded baseline, pad -> the same GEMM -> unpad."""
    b8, sb = q.quantize_blockwise_batched(w)
    if cfg.backend == PADDED_BASELINE:
        return padding_baseline.grouped_gemm_fp8_padded(
            a8, sa, b8, sb, group_sizes, config=cfg, out_dtype=out_dtype)
    return grouped_gemm_kernel.gmm(
        a8, sa, b8, sb, group_sizes, num_groups=w.shape[0],
        block_m=cfg.block_m, block_n=cfg.block_n, block_k=cfg.block_k,
        out_dtype=out_dtype, plan=plan)


def _gemm_quant(a8, sa, w, group_sizes, cfg: KernelConfig, plan: TilePlan,
                round_dtype):
    """``a @ w[g]`` per group on the quantizing fp8 grouped GEMM: e4m3
    payload and 1x128 scales of the product rounded through
    ``round_dtype``.  Under the padded baseline: the padded GEMM, then
    the tilewise quantizer (bitwise what the quantizing GEMM stores)."""
    # one event per producer-GEMM dispatch, under every backend: the
    # producer-fusion contracts (REPRO-C05) pin the gate/up routing count
    _events.emit("gemm_quant", m=a8.shape[0], n=w.shape[2])
    if cfg.backend == PADDED_BASELINE:
        y = _gemm(a8, sa, w, group_sizes, cfg, plan, round_dtype)
        return quant_kernel.quantize_tilewise(y.float())
    b8, sb = q.quantize_blockwise_batched(w)
    return grouped_gemm_kernel.gmm_quant(
        a8, sa, b8, sb, group_sizes, num_groups=w.shape[0],
        block_m=cfg.block_m, block_n=cfg.block_n, block_k=cfg.block_k,
        out_dtype=round_dtype, plan=plan)


def _gemm_bf16(x, w, group_sizes, cfg: KernelConfig, plan: TilePlan,
               out_dtype):
    """``x @ w[g]`` per group on the bf16 grouped GEMM, operands cast to
    bf16; x made contiguous, w passed as it lies (the kernel reads a
    contiguous w and the dgrad's ``w.transpose(1, 2)`` alike)."""
    return grouped_gemm_kernel.gmm_bf16(
        x.to(torch.bfloat16).contiguous(), w.to(torch.bfloat16),
        group_sizes, num_groups=w.shape[0], block_m=cfg.block_m,
        block_n=cfg.block_n, block_k=cfg.block_k, out_dtype=out_dtype,
        plan=plan)


def _dgrad(d8, sd, w, group_sizes, cfg: KernelConfig, plan: TilePlan):
    """``dx = dy @ w[g]^T`` per group on the fp8 grouped GEMM, w^T
    quantized 128x128 blockwise, f32 out, on the forward's plan."""
    # contiguous before quantizing: the quantizer keeps its input's
    # strides, and the kernel takes a row-major [G, N, K]
    return _gemm(d8, sd, w.transpose(1, 2).contiguous(), group_sizes, cfg,
                 plan, torch.float32)


def _wgrad(operands, group_sizes, cfg: KernelConfig, plan: TilePlan,
           w: torch.Tensor):
    """``dw[g] = a_g^T dy_g``, f32-accumulated, written in ``w``'s dtype
    by either kernel (each rounds its f32 sum once).  ``operands``:
    ``(a, dy)``, cast to bf16 here, or under fp8 wgrad ``(a8, s_a, d8,
    s_d)``."""
    kw = dict(num_groups=w.shape[0], block_n=cfg.block_n,
              block_k=cfg.block_k, n_span=cfg.n_span, k_span=cfg.k_span,
              out_dtype=w.dtype, plan=plan)
    if cfg.wgrad_precision == "fp8":
        return wgrad_kernel.gmm_wgrad_fp8(*operands, group_sizes, **kw)
    a, dy = (t.to(torch.bfloat16).contiguous() for t in operands)
    return wgrad_kernel.gmm_wgrad(a, dy, group_sizes, **kw)


class _GroupedLinearFP8(torch.autograd.Function):
    """Mirrors ``_fp8_fwd`` / ``_fp8_bwd`` of the JAX package's
    ``core/grouped_gemm.py``."""

    @staticmethod
    def forward(ctx, x, w, group_sizes, plan, quantized, cfg):
        # quantize-once: a caller's QuantizedActivation (the MoE gate/up
        # pair shares one) replaces the tilewise quantization of x
        if quantized is None:
            quantized = q.quantize_activation(x)
        plan = _plan(plan, group_sizes, x.shape[0], cfg, w.shape[0])
        y = _gemm(quantized.q, quantized.scale, w, group_sizes, cfg, plan,
                  cfg.out_dtype)
        ctx.cfg, ctx.plan, ctx.x_dtype = cfg, plan, x.dtype
        if cfg.wgrad_precision == "fp8":
            # the residual is the quantized activation; x itself is freed
            ctx.save_for_backward(quantized.q, quantized.scale, w,
                                  group_sizes)
        else:
            # DeepSeek recipe: the wgrad contracts the highest-precision x
            ctx.save_for_backward(x, w, group_sizes)
        return y

    @staticmethod
    def backward(ctx, dy):
        cfg, plan = ctx.cfg, ctx.plan
        *res, w, group_sizes = ctx.saved_tensors
        # ONE quantization of dy serves the dgrad and the fp8 wgrad
        d8, sd = q.quantize_tilewise(dy.float().contiguous())
        dx = _dgrad(d8, sd, w, group_sizes, cfg, plan)
        # res: (a8, s_a) under fp8 wgrad, else (x,)
        operands = (*res, d8, sd) if cfg.wgrad_precision == "fp8" \
            else (res[0], dy)
        dw = _wgrad(operands, group_sizes, cfg, plan, w)
        # a supplied QuantizedActivation gets no gradient: x's reaches it
        # through dx, as the JAX package's zero cotangent for it says
        return dx.to(ctx.x_dtype), dw, None, None, None, None


class _GroupedLinearFP8Fused(torch.autograd.Function):
    """Mirrors ``_fused_fwd`` / ``_fused_bwd`` of the JAX package's
    ``core/grouped_gemm.py``."""

    @staticmethod
    def forward(ctx, g, u, w, group_sizes, plan, cfg, act):
        # ONE fused pass: activation + 1x128 quantization; h never exists
        qh = q.fused_act_quantize(g, u, act=act)
        plan = _plan(plan, group_sizes, g.shape[0], cfg, w.shape[0])
        y = _gemm(qh.q, qh.scale, w, group_sizes, cfg, plan, cfg.out_dtype)
        ctx.cfg, ctx.plan, ctx.act = cfg, plan, act
        # (g, u) for the activation's VJP; under fp8 wgrad the quantized h
        # rides along, so h is never quantized standalone
        h_res = (qh.q, qh.scale) if cfg.wgrad_precision == "fp8" else ()
        ctx.save_for_backward(g, u, w, group_sizes, *h_res)
        return y

    @staticmethod
    def backward(ctx, dy):
        cfg, plan, act = ctx.cfg, ctx.plan, ctx.act
        g, u, w, group_sizes, *h_res = ctx.saved_tensors
        d8, sd = q.quantize_tilewise(dy.float().contiguous())
        dh = _dgrad(d8, sd, w, group_sizes, cfg, plan)
        # dsilu(g)*u / silu(g)*du: autograd of the f32 activation the
        # kernel fused, recomputed from the residuals
        with torch.enable_grad():
            ins = [t.detach().requires_grad_() for t in (g, u) if t is not None]
            h = kref.act_f32(ins[0], ins[1] if u is not None else None, act)
            grads = torch.autograd.grad(h, ins, dh)
        # under bf16 wgrad the recomputed h (cast to bf16) is contracted
        operands = (*h_res, d8, sd) if cfg.wgrad_precision == "fp8" \
            else (h.detach(), dy)
        dw = _wgrad(operands, group_sizes, cfg, plan, w)
        dg = grads[0].to(g.dtype)
        du = grads[1].to(u.dtype) if u is not None else None
        return dg, du, dw, None, None, None, None


class _GroupedLinearFFNFP8(torch.autograd.Function):
    """Mirrors ``_ffn_fwd`` / ``_ffn_bwd`` of the JAX package's
    ``core/grouped_gemm.py``."""

    @staticmethod
    def forward(ctx, x, w_gate, w_up, w_down, group_sizes, plan, quantized,
                cfg, act):
        # quantize-once: ONE tilewise quantization of x feeds the gate AND
        # up GEMMs (and, under fp8 wgrad, both of their wgrads)
        if quantized is None:
            quantized = q.quantize_activation(x)
        a8, sa = quantized.q, quantized.scale
        plan = _plan(plan, group_sizes, x.shape[0], cfg, w_up.shape[0])
        # producer epilogue: the gate/up GEMMs round through x.dtype (what
        # the unfused GEMM would store) and store fp8 + 1x128 scales
        u8, su = _gemm_quant(a8, sa, w_up, group_sizes, cfg, plan, x.dtype)
        if w_gate is not None:
            g8, sg = _gemm_quant(a8, sa, w_gate, group_sizes, cfg, plan,
                                 x.dtype)
            qh = q.fused_act_quantize_fp8(g8, sg, u8, su, act=act)
        else:
            # unary activation (gelu): w_up is the single projection
            g8 = sg = None
            qh = q.fused_act_quantize_fp8(u8, su, act=act)
        y = _gemm(qh.q, qh.scale, w_down, group_sizes, cfg, plan,
                  cfg.out_dtype)
        ctx.cfg, ctx.plan, ctx.act, ctx.x_dtype = cfg, plan, act, x.dtype
        if cfg.wgrad_precision == "fp8":
            # all-fp8 step: the quantized x and h are the residuals, so the
            # backward quantizes neither again; x itself is freed
            res = (a8, sa, qh.q, qh.scale)
        else:
            # DeepSeek recipe: the raw x is kept, h recomputed in f32
            res = (x,)
        ctx.save_for_backward(g8, sg, u8, su, w_gate, w_up, w_down,
                              group_sizes, *res)
        return y

    @staticmethod
    def backward(ctx, dy):
        cfg, plan, act = ctx.cfg, ctx.plan, ctx.act
        (g8, sg, u8, su, w_gate, w_up, w_down, group_sizes,
         *res) = ctx.saved_tensors
        # ONE quantization of dy serves the down dgrad AND its fp8 wgrad
        d8, sd = q.quantize_tilewise(dy.float().contiguous())
        dh = _dgrad(d8, sd, w_down, group_sizes, cfg, plan)
        # recompute the activation from the dequantized fp8 payloads: the
        # values the fused epilogue ran on (g and u never existed wider);
        # tail rows dequantize to 0 (payload 0, scale 1)
        with torch.enable_grad():
            ins = [kref.dequantize_tilewise_ref(t, s).requires_grad_()
                   for t, s in ((g8, sg), (u8, su)) if t is not None]
            h = kref.act_f32(ins[0], ins[1] if len(ins) == 2 else None, act)
            grads = torch.autograd.grad(h, ins, dh)
        dg, du = grads if w_gate is not None else (None, grads[0])
        # quantize du (and dg) ONCE each: for the dgrads and, under fp8
        # wgrad, the wgrads.  Standalone quantizations of the whole
        # forward + backward: x, dy, dg, du; never g, u or h
        du8, sdu = q.quantize_tilewise(du.contiguous())
        dx = _dgrad(du8, sdu, w_up, group_sizes, cfg, plan)
        if w_gate is not None:
            dg8, sdg = q.quantize_tilewise(dg.contiguous())
            dx = dx + _dgrad(dg8, sdg, w_gate, group_sizes, cfg, plan)
        if cfg.wgrad_precision == "fp8":
            a8, sa, h8, sh = res
            ops_down, ops_up = (h8, sh, d8, sd), (a8, sa, du8, sdu)
            ops_gate = None if w_gate is None else (a8, sa, dg8, sdg)
        else:
            (x,) = res
            ops_down, ops_up = (h.detach(), dy), (x, du)
            ops_gate = None if w_gate is None else (x, dg)
        dw_down = _wgrad(ops_down, group_sizes, cfg, plan, w_down)
        dw_up = _wgrad(ops_up, group_sizes, cfg, plan, w_up)
        dw_gate = None if w_gate is None else \
            _wgrad(ops_gate, group_sizes, cfg, plan, w_gate)
        # a supplied QuantizedActivation gets no gradient, as in
        # _GroupedLinearFP8
        return (dx.to(ctx.x_dtype), dw_gate, dw_up, dw_down, None, None,
                None, None, None)


class _GroupedLinearBF16(torch.autograd.Function):
    """Mirrors ``_bf16_fwd`` / ``_bf16_bwd`` of the JAX package's
    ``core/grouped_gemm.py``, on the bf16 grouped GEMM."""

    @staticmethod
    def forward(ctx, x, w, group_sizes, plan, cfg):
        if plan is None:     # the bf16 GEMM takes no backend
            plan = make_tile_plan(group_sizes, x.shape[0],
                                  block_m=cfg.block_m, num_groups=w.shape[0])
        y = _gemm_bf16(x, w, group_sizes, cfg, plan, cfg.out_dtype)
        ctx.cfg, ctx.plan = cfg, plan
        ctx.save_for_backward(x, w, group_sizes)
        return y

    @staticmethod
    def backward(ctx, dy):
        cfg, plan = ctx.cfg, ctx.plan
        x, w, group_sizes = ctx.saved_tensors
        # dx = dy @ w^T on the same kernel, f32 out; w^T is read where it
        # lies (K-contiguous), with no transposed copy of the weight
        dx = _gemm_bf16(dy, w.transpose(1, 2), group_sizes, cfg, plan,
                        torch.float32)
        dw = _wgrad((x, dy), group_sizes, cfg, plan, w)
        return dx.to(x.dtype), dw, None, None, None


def grouped_linear(x: torch.Tensor, w: torch.Tensor,
                   group_sizes: torch.Tensor, *, precision: str = "bf16",
                   out_dtype: Optional[torch.dtype] = None,
                   config: Optional[KernelConfig] = None,
                   plan: Optional[TilePlan] = None,
                   quantized: Optional[q.QuantizedActivation] = None
                   ) -> torch.Tensor:
    """x: [M, K]; w: [G, K, N]; group_sizes: [G] with ``sum <= M``.  Rows
    beyond the last group come back as zeros, and are excluded from the
    backward's wgrad.

    ``precision``: ``"fp8"`` (the paper's kernel) or ``"bf16"`` (the bf16
    grouped GEMM forward and dgrad, the bf16 wgrad: the numerics
    baseline).  ``plan``: the routing decision's :class:`TilePlan`,
    shared by every GEMM with these ``group_sizes``.  ``quantized`` (fp8
    only): the :class:`~repro_torch.core.quantization.QuantizedActivation`
    of exactly this ``x``, shared by every GEMM that consumes it; it gets
    no gradient.  ``out_dtype``: explicit > the config's > ``x.dtype``.
    The fp8 wgrad's precision is the config's ``wgrad_precision``; the
    bf16 path takes only ``"bf16"``.
    """
    cfg = resolve_config(config, out_dtype=out_dtype)
    if cfg.out_dtype is None:
        cfg = cfg.with_(out_dtype=x.dtype)
    if precision == "fp8":
        return _GroupedLinearFP8.apply(x, w, group_sizes, plan, quantized,
                                       cfg)
    if precision == "bf16":
        if quantized is not None:
            raise ValueError(
                "grouped_linear(precision='bf16') takes no quantized=...: "
                "the bf16 path never quantizes; use precision='fp8' to "
                "consume a QuantizedActivation")
        if cfg.wgrad_precision == "fp8":
            raise ValueError(
                "grouped_linear(precision='bf16') takes no "
                "wgrad_precision='fp8': the fp8-operand wgrad needs the fp8 "
                "forward's quantized residual; use precision='fp8'")
        if cfg.backend is not None:
            warnings.warn(
                f"grouped_linear(precision='bf16') ignores "
                f"backend={cfg.backend!r}: the bf16 path always runs the "
                "bf16 grouped GEMM; use precision='fp8' to select a "
                "grouped-GEMM backend", stacklevel=2)
        return _GroupedLinearBF16.apply(x, w, group_sizes, plan, cfg)
    raise ValueError(f"unknown precision {precision!r}")


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
    output directly.  The backward recomputes the activation in f32 from
    ``(g, u)``; the wgrad as in :func:`grouped_linear`.
    ``out_dtype``: explicit > the config's > ``g.dtype``.
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
    return _GroupedLinearFP8Fused.apply(g, u, w, group_sizes, plan, cfg, act)


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


def grouped_linear_ffn(x: torch.Tensor, w_gate: Optional[torch.Tensor],
                       w_up: torch.Tensor, w_down: torch.Tensor,
                       group_sizes: torch.Tensor, *, act: str = "silu_mul",
                       out_dtype: Optional[torch.dtype] = None,
                       config: Optional[KernelConfig] = None,
                       plan: Optional[TilePlan] = None,
                       quantized: Optional[q.QuantizedActivation] = None
                       ) -> torch.Tensor:
    """Whole fp8 expert FFN with producer-side quantizing epilogues:
    ``y = act(x @ w_gate, x @ w_up) @ w_down`` per group, where the
    gate/up GEMMs store fp8 payload + 1x128 scales directly and the
    activation dequantizes them on load.  Nothing wider than fp8 crosses
    device memory between the producer GEMMs and the down GEMM.

    ``w_gate``: [G, K, F] (``None`` for the unary ``gelu``, where ``w_up``
    is the single projection); ``w_up``: [G, K, F]; ``w_down``: [G, F,
    N].  ``quantized``/``plan`` as in :func:`grouped_linear`; the wgrad's
    precision is the config's ``wgrad_precision``.

    Numerics: the producer is bitwise the unfused GEMM -> quantize
    composition, but the FFN applies one more e4m3 quantization to g/u
    than :func:`grouped_linear_fused` pipelines: a tolerance, not
    equality.  Standalone quantizations: forward one (``x``, none when
    ``quantized`` is given); forward + backward four (``x``, ``dy``,
    ``dg``, ``du``).
    """
    if act not in ACTIVATIONS:
        raise ValueError(f"unknown activation {act!r}; "
                         f"expected one of {ACTIVATIONS}")
    if act == "silu_mul" and w_gate is None:
        raise ValueError("act='silu_mul' needs both w_gate and w_up")
    if act != "silu_mul" and w_gate is not None:
        raise ValueError(f"act={act!r} is unary; pass the single projection "
                         "as w_up with w_gate=None")
    cfg = resolve_config(config, out_dtype=out_dtype)
    if cfg.out_dtype is None:
        cfg = cfg.with_(out_dtype=x.dtype)
    return _GroupedLinearFFNFP8.apply(x, w_gate, w_up, w_down, group_sizes,
                                      plan, quantized, cfg, act)


def dense_ffn_fp8(x: torch.Tensor, w_gate: Optional[torch.Tensor],
                  w_up: torch.Tensor, w_down: torch.Tensor, *,
                  act: str = "silu_mul",
                  out_dtype: Optional[torch.dtype] = None,
                  config: Optional[KernelConfig] = None,
                  plan: Optional[TilePlan] = None,
                  quantized: Optional[q.QuantizedActivation] = None
                  ) -> torch.Tensor:
    """G=1 producer-fused fp8 FFN (the MoE shared experts).  Leading dims
    of ``x`` are flattened to rows; ``plan`` is the caller's G=1 plan of
    those rows."""
    lead, k = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, k)
    gs = torch.full((1,), x2.shape[0], dtype=torch.int32, device=x.device)
    y = grouped_linear_ffn(
        x2, None if w_gate is None else w_gate[None], w_up[None],
        w_down[None], gs, act=act, out_dtype=out_dtype, config=config,
        plan=plan, quantized=quantized)
    return y.reshape(*lead, w_down.shape[-1])


# ---------------------------------------------------------------------------
# Kernel contracts (repro_torch.analysis layer 1)
# ---------------------------------------------------------------------------
# Declarative invariants for every public fp8 path in this module, checked
# by ``python -m repro_torch.analysis --contracts`` on the aten ops a call
# dispatches.  The contracts, their operands and their counts are the JAX
# package's.  The build functions take the device and run only when a
# contract is checked: registration costs nothing at import.

from repro_torch.analysis.contracts import register_contract as \
    _register_contract  # noqa: E402


def _contract_operands(device):
    """Shared example problem: G=3 with an empty group and a ragged tail
    (sum(gs)=190 < M=256), the shapes every padding-free claim is about;
    the JAX package's numpy draws."""
    import numpy as np
    rng = np.random.default_rng(0)

    def t(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(device)
    x, w = t((256, 128)), t((3, 128, 128))
    gu, wd = t((2, 256, 256)), t((3, 256, 128))
    gs = torch.tensor([60, 0, 130], dtype=torch.int32, device=device)
    return x, w, gu, wd, gs


def _ffn_weights(device):
    """The FFN contracts' gate, up and down weights (numpy seed 1)."""
    import numpy as np
    rng = np.random.default_rng(1)
    return tuple(torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 .to(device) for s in ((3, 128, 256), (3, 128, 256),
                                       (3, 256, 128)))


def _grad_of(loss):
    """``fn(*args)`` -> the gradients of ``loss(*args)`` w.r.t. every
    argument, as the JAX package's ``jax.grad(loss, argnums=all)``."""
    def grads(*args):
        args = [a.detach().requires_grad_() for a in args]
        return torch.autograd.grad(loss(*args), args)
    return grads


def _build_linear_fwd(device, config: Optional[KernelConfig] = None):
    x, w, _, _, gs = _contract_operands(device)
    cfg = config or KernelConfig()
    return (lambda x, w: grouped_linear(x, w, gs, precision="fp8",
                                        config=cfg)), (x, w)


def _build_linear_grad(device):
    x, w, _, _, gs = _contract_operands(device)
    cfg = KernelConfig()

    def loss(x, w):
        y = grouped_linear(x, w, gs, precision="fp8", config=cfg)
        return torch.sum(y.float() ** 2)
    return _grad_of(loss), (x, w)


def _build_fused_fwd(device):
    _, _, gu, wd, gs = _contract_operands(device)
    cfg = KernelConfig()
    return (lambda g, u: grouped_linear_fused(g, u, wd, gs, act="silu_mul",
                                              config=cfg)), (gu[0], gu[1])


def _build_fused_grad(device):
    _, _, gu, wd, gs = _contract_operands(device)
    cfg = KernelConfig()

    def loss(g, u, w):
        y = grouped_linear_fused(g, u, w, gs, act="silu_mul", config=cfg)
        return torch.sum(y.float() ** 2)
    return _grad_of(loss), (gu[0], gu[1], wd)


def _build_ffn_fwd(device):
    x, _, _, _, gs = _contract_operands(device)
    wg, wu, wd = _ffn_weights(device)
    cfg = KernelConfig()
    return (lambda x: grouped_linear_ffn(x, wg, wu, wd, gs, act="silu_mul",
                                         config=cfg)), (x,)


def _build_ffn_grad(device):
    x, _, _, _, gs = _contract_operands(device)
    cfg = KernelConfig(wgrad_precision="fp8")

    def loss(x, wg, wu, wd):
        y = grouped_linear_ffn(x, wg, wu, wd, gs, act="silu_mul",
                               config=cfg)
        return torch.sum(y.float() ** 2)
    return _grad_of(loss), (x, *_ffn_weights(device))


_register_contract(
    "grouped_linear.fp8.fwd",
    description="fp8 forward: ONE standalone quantize (x), one plan "
                "build, zero padding copies",
    build=_build_linear_fwd,
    quantize_count=1, quantize_shapes=((256, 128),),
    plan_builds=1, forbid_padding=True)

_register_contract(
    "grouped_linear.fp8.grad",
    description="fp8 fwd+bwd: quantizes exactly {x, dy}; the forward's "
                "TilePlan serves the dgrad and wgrad (one build total)",
    build=_build_linear_grad,
    quantize_count=2, quantize_shapes=((256, 128), (256, 128)),
    plan_builds=1, forbid_padding=True)

_register_contract(
    "grouped_linear_fused.fp8.fwd",
    description="fused epilogue forward: ZERO standalone quantizes (the "
                "act_quant pass owns h), no wide h materialization",
    build=_build_fused_fwd,
    quantize_count=0, plan_builds=1, forbid_padding=True,
    forbid_wide_shapes=((256, 256),))

_register_contract(
    "grouped_linear_fused.fp8.grad",
    description="fused epilogue fwd+bwd: quantizes exactly {dy}; one "
                "plan build serves forward, dgrad, and wgrad",
    build=_build_fused_grad,
    quantize_count=1, quantize_shapes=((256, 128),),
    plan_builds=1, forbid_padding=True)

_register_contract(
    "grouped_linear_ffn.fp8.fwd",
    description="producer-fused FFN forward: ONE standalone quantize "
                "(x), gate/up through the quantizing GEMM, g/u/h never "
                "wider than fp8",
    build=_build_ffn_fwd,
    quantize_count=1, quantize_shapes=((256, 128),),
    plan_builds=1, gemm_quant_calls=2, forbid_padding=True,
    forbid_wide_shapes=((256, 256),))

_register_contract(
    "grouped_linear_ffn.fp8.grad",
    description="producer-fused FFN fwd+bwd (all-fp8 wgrad): quantizes "
                "exactly {x, dy, dg, du}, never g/u/h",
    build=_build_ffn_grad,
    quantize_count=4,
    quantize_shapes=((256, 128), (256, 128), (256, 256), (256, 256)),
    plan_builds=1, gemm_quant_calls=2, forbid_padding=True)


# ---------------------------------------------------------------------------
# Compile contracts (repro_torch.analysis layer 5: REPRO-T01)
# ---------------------------------------------------------------------------
# Three steps with DIFFERENT routings (new group_sizes values, same shapes)
# prepare nothing after the first: no kernel build or load, no plan-cache
# shape, no autotune measurement.  The port plans per routing decision
# with tensor ops (make_tile_plan), which is no preparation.

from repro_torch.analysis.retrace import PREPARES as _PREPARES  # noqa: E402
from repro_torch.analysis.retrace import \
    register_compile_contract as _register_compile_contract  # noqa: E402


def _routing_steps(device, step, args, routings):
    calls = [(*args, torch.tensor(r, dtype=torch.int32, device=device))
             for r in routings]
    return step, calls


def _build_linear_retrace(device):
    x, w, _, _, _ = _contract_operands(device)
    cfg = KernelConfig()

    def linear_step(x, w, gs):
        return _grad_of(lambda x, w: torch.sum(grouped_linear(
            x, w, gs, precision="fp8", config=cfg).float() ** 2))(x, w)
    return _routing_steps(device, linear_step, (x, w),
                          ([60, 0, 130], [100, 50, 40], [0, 0, 256]))


def _build_ffn_retrace(device):
    x, _, _, _, _ = _contract_operands(device)
    cfg = KernelConfig(wgrad_precision="fp8")

    def ffn_step(x, wg, wu, wd, gs):
        return _grad_of(lambda *a: torch.sum(grouped_linear_ffn(
            *a, gs, act="silu_mul", config=cfg).float() ** 2))(
                x, wg, wu, wd)
    return _routing_steps(device, ffn_step, (x, *_ffn_weights(device)),
                          ([60, 0, 130], [100, 50, 40], [256, 0, 0]))


_register_compile_contract(
    "grouped_linear.fp8.retrace",
    description="fp8 fwd+bwd step prepares nothing after the first of "
                "three routing changes of the same shape",
    build=_build_linear_retrace,
    expected=dict.fromkeys(_PREPARES, 0), warmup=1, rule="REPRO-T01")

_register_compile_contract(
    "grouped_linear_ffn.fp8.retrace",
    description="producer-fused FFN fwd+bwd step (all-fp8 wgrad) "
                "prepares nothing after the first of three routing "
                "changes of the same shape",
    build=_build_ffn_retrace,
    expected=dict.fromkeys(_PREPARES, 0), warmup=1, rule="REPRO-T01")
