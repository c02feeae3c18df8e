"""Padding-free Mixture-of-Experts layer built on the grouped GEMM.

This is the paper's target workload: top-k routing produces dynamic group
sizes per expert; the expert FFNs run as one padding-free grouped GEMM
over the concatenated, ragged token buffer.

Ported: ragged dispatch on one device (``ep_size=1``), shared experts and
the aux outputs, forward and backward, in three recipes: fp8 (the fused
activation epilogue feeds the down GEMM), fp8 with
``KernelConfig.fuse_producer`` (the gate/up GEMMs store fp8 directly, so
g and u never exist wider) and ``precision="bf16"`` (the bf16 grouped
GEMM, the numerics baseline).  ``backend="padded_baseline"`` runs the
fp8 GEMMs through the paper's baseline (pad, the same GEMM, unpad), which
plans over its padded sizes, so the layer builds no plan of its own.
Gradients reach the router through the top-k weights and the
load-balance loss; the token dispatch and the combine are gathers both
ways, so the backward, like the forward, sums each token's k slots in
one fixed order without atomics.

``dispatch="dense"`` is GShard's capacity-bucket dispatch, the padding
regime the paper removes: each expert's rows go into a bucket of
``cap_e`` rows, the buckets run three batched products in x's dtype
(also under ``precision="fp8"``, as in the reference; the shared experts
keep their fp8 kernels), and rows past an expert's capacity are dropped.
Unlike the reference, which scatters the dropped rows as zeros onto the
last slot of the last expert (so an overflowing last expert loses its
last kept row), the buckets take the kept rows only (ROADMAP C).
Not yet ported, and raising ``NotImplementedError``: expert parallelism
(ROADMAP A15).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.grouped_gemm import (dense_ffn_fp8, dense_linear_fp8,
                                           dense_linear_fp8_fused,
                                           grouped_linear, grouped_linear_ffn,
                                           grouped_linear_fused)
from repro_torch.core.quantization import quantize_activation
from repro_torch.kernels.plan import PADDED_BASELINE, KernelConfig, \
    make_tile_plan, resolve_config


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_model: int
    d_ff_expert: int
    num_shared_experts: int = 0
    norm_topk_prob: bool = False
    capacity_factor: float = 2.0
    precision: str = "fp8"
    # the grouped GEMMs' backend ("padded_baseline"), set over the kernel
    # config's; None keeps the config's, "auto" sets it back to None
    backend: Optional[str] = None
    kernel_config: Optional[KernelConfig] = None
    router_dtype: torch.dtype = torch.float32
    dispatch: str = "ragged"


def init_moe_params(cfg: MoEConfig, *, generator: torch.Generator,
                    device, dtype=torch.float32) -> "dict[str, torch.Tensor]":
    """Random normal weights scaled like the reference's, drawn from
    ``generator`` on ``device``."""
    d, f, e = cfg.d_model, cfg.d_ff_expert, cfg.num_experts

    def normal(shape, scale, dt):
        x = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return (x * scale).to(dt)

    p = {
        "router": normal((d, e), d ** -0.5, torch.float32),
        "w_gate": normal((e, d, f), d ** -0.5, dtype),
        "w_up": normal((e, d, f), d ** -0.5, dtype),
        "w_down": normal((e, f, d), f ** -0.5, dtype),
    }
    if cfg.num_shared_experts:
        fs = f * cfg.num_shared_experts
        p["shared_gate"] = normal((d, fs), d ** -0.5, dtype)
        p["shared_up"] = normal((d, fs), d ** -0.5, dtype)
        p["shared_down"] = normal((fs, d), fs ** -0.5, dtype)
    return p


def _capacity(num_slots: int, ep_size: int, cf: float,
              align: int = 128) -> int:
    """Static capacity of the packed buffer.  With ``ep_size == 1`` every
    slot is real and the buffer keeps exactly ``num_slots`` rows; the
    kernel handles the ragged M."""
    if ep_size == 1:
        return num_slots
    cap_all = -(-num_slots // align) * align
    c = -(-int(num_slots / ep_size * cf) // align) * align
    return min(cap_all, max(c, align))


def _sum_slots(rows: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``out[t] = sum_j rows[pos[t, j]]`` in f32, added in ascending slot
    order (``pos`` is sorted along its rows): the packed order of the
    reference's scatter-add, computed with gathers."""
    out = rows[pos[:, 0]].float()
    for j in range(1, pos.shape[1]):
        out = out + rows[pos[:, j]].float()
    return out


class _Dispatch(torch.autograd.Function):
    """``xs = x[token_of]``: each packed slot reads its token's row.  The
    backward sums each token's k slot gradients with :func:`_sum_slots`,
    in the combine's order, instead of an atomic scatter-add."""

    @staticmethod
    def forward(ctx, x, token_of, pos):
        ctx.save_for_backward(pos)
        return x[token_of]

    @staticmethod
    def backward(ctx, dxs):
        (pos,) = ctx.saved_tensors
        return _sum_slots(dxs, pos).to(dxs.dtype), None, None


class _Combine(torch.autograd.Function):
    """``out[t] = sum_j contrib[pos[t, j]]`` (f32); its backward hands each
    slot its token's gradient, ``dout[token_of]``."""

    @staticmethod
    def forward(ctx, contrib, token_of, pos):
        ctx.save_for_backward(token_of)
        return _sum_slots(contrib, pos)

    @staticmethod
    def backward(ctx, dout):
        (token_of,) = ctx.saved_tensors
        return dout[token_of], None, None


def _silu_mul_bf16(g, u):
    """``silu(g) * u`` in the operands' dtype, one rounding per operation
    as the reference's ``jax.nn.silu(g) * u`` on bf16 tensors (its "§Perf
    I5": activations in the compute dtype)."""
    return g * torch.sigmoid(g) * u


def _dense_experts(params, xs: torch.Tensor, gs: torch.Tensor,
                   num_slots: int, capacity_factor: float) -> torch.Tensor:
    """GShard-style expert FFN over the packed rows ``xs`` [cap, d] with
    group sizes ``gs``: each expert's first ``cap_e`` rows (the ceiling
    of ``num_slots * capacity_factor / E``, rounded up to 8) go into its
    bucket of an [E, cap_e, d] tensor, the buckets run the gate, up and
    down products batched, and each kept row reads its result back; the
    other rows are 0.  Buckets and results move by gathers, whose
    backward adds into distinct rows; empty bucket slots and dropped rows
    read one zero row past the data."""
    e = gs.shape[0]
    cap, d = xs.shape
    cap_e = max(-(-int(num_slots * capacity_factor) // e), 1)
    cap_e = (cap_e + 7) // 8 * 8
    ends = torch.cumsum(gs, 0)
    starts = ends - gs
    slot = torch.arange(cap_e, device=xs.device)
    src = torch.where(slot < gs[:, None], starts[:, None] + slot, cap)
    xe = torch.cat([xs, xs.new_zeros(1, d)])[src]            # [E, cap_e, d]
    he = _silu_mul_bf16(torch.bmm(xe, params["w_gate"]),
                        torch.bmm(xe, params["w_up"]))
    ye = torch.bmm(he, params["w_down"])                      # [E, cap_e, d]
    row = torch.arange(cap, device=xs.device)
    gid = torch.searchsorted(ends, row, right=True).clamp_(max=e - 1)
    pos = row - starts[gid]
    keep = (row < ends[-1]) & (pos < cap_e)
    back = torch.where(keep, gid * cap_e + pos, e * cap_e)
    return torch.cat([ye.reshape(e * cap_e, d), ye.new_zeros(1, d)])[back]


def moe_apply(params, x: torch.Tensor, cfg: MoEConfig, *, ep_rank: int = 0,
              ep_size: int = 1):
    """x: [T, d_model].  Returns (y [T, d_model], aux dict)."""
    if ep_size != 1 or ep_rank != 0:
        raise NotImplementedError("expert parallelism is not ported yet "
                                  "(ROADMAP A15)")
    if cfg.dispatch not in ("ragged", "dense"):
        raise ValueError(f"unknown dispatch {cfg.dispatch!r}")
    if cfg.precision not in ("fp8", "bf16"):
        raise ValueError(f"unknown precision {cfg.precision!r}")
    t, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    kcfg = resolve_config(cfg.kernel_config, backend=cfg.backend)

    # ---- routing (real f32: TF32 is off for the whole port) -------------
    logits = x.to(cfg.router_dtype) @ params["router"].to(cfg.router_dtype)
    probs = torch.softmax(logits, dim=-1)
    weights, ids = torch.topk(probs, k, dim=-1)                # [T, k]
    if cfg.norm_topk_prob:
        weights = weights / weights.sum(-1, keepdim=True)

    # ---- pack the T*k slots by expert (all experts are local) -----------
    num_slots = t * k
    cap = _capacity(num_slots, ep_size, cfg.capacity_factor,
                    align=kcfg.block_m)
    flat_ids = ids.reshape(-1)
    sel = torch.argsort(flat_ids, stable=True)                # packed slots
    # slots per expert; a scatter-add, since bincount on CUDA reads the
    # largest id back to the host
    counts = torch.zeros(e, dtype=torch.int64, device=x.device).scatter_add_(
        0, flat_ids, torch.ones_like(flat_ids))
    gs = counts.to(torch.int32)
    total = gs.sum()
    token_of = torch.div(sel, k, rounding_mode="floor")
    # each token owns exactly k slots; pos[t] lists them in packed order
    inv = torch.empty_like(sel)
    inv[sel] = torch.arange(cap, device=x.device)
    pos = torch.sort(inv.reshape(t, k), dim=1).values         # [T, k]
    xs = _Dispatch.apply(x, token_of, pos)                    # [cap, d]

    # ---- padding-free ragged expert FFN (the paper's kernel) ------------
    # one plan per routing decision serves every GEMM of the layer (the
    # padded baseline's GEMMs plan over their padded sizes: no layer
    # plan); in fp8, one quantization of xs serves the gate and up GEMMs
    fp8 = cfg.precision == "fp8"
    planned = not (fp8 and kcfg.backend == PADDED_BASELINE)
    ragged = cfg.dispatch == "ragged"
    tile_plan = make_tile_plan(gs, cap, block_m=kcfg.block_m,
                               num_groups=e) if planned and ragged else None
    qx = quantize_activation(xs) if fp8 and ragged else None
    if not ragged:
        y = _dense_experts(params, xs, gs, num_slots, cfg.capacity_factor)
    elif fp8 and kcfg.fuse_producer:
        # producer-fused FFN: the gate/up GEMMs store fp8 + 1x128 scales
        # and the activation dequantizes them on load; the FFN performs
        # exactly one standalone quantization (qx)
        y = grouped_linear_ffn(xs, params["w_gate"], params["w_up"],
                               params["w_down"], gs, act="silu_mul",
                               config=kcfg, plan=tile_plan, quantized=qx)
    elif fp8:
        g = grouped_linear(xs, params["w_gate"], gs, precision="fp8",
                           config=kcfg, plan=tile_plan, quantized=qx)
        u = grouped_linear(xs, params["w_up"], gs, precision="fp8",
                           config=kcfg, plan=tile_plan, quantized=qx)
        y = grouped_linear_fused(g, u, params["w_down"], gs, act="silu_mul",
                                 config=kcfg, plan=tile_plan)  # [cap, d]
    else:
        g = grouped_linear(xs, params["w_gate"], gs, precision="bf16",
                           config=kcfg, plan=tile_plan)
        u = grouped_linear(xs, params["w_up"], gs, precision="bf16",
                           config=kcfg, plan=tile_plan)
        y = grouped_linear(_silu_mul_bf16(g, u), params["w_down"], gs,
                           precision="bf16", config=kcfg, plan=tile_plan)

    # ---- combine: gather each token's k slots back through the inverse
    # permutation and add them in packed order, the order of the
    # reference's scatter-add, without atomics
    w_flat = weights.reshape(-1)[sel]
    contrib = y.float() * w_flat[:, None]                     # [cap, d]
    out = _Combine.apply(contrib, token_of, pos)

    # ---- shared experts ---------------------------------------------------
    if cfg.num_shared_experts:
        fs = params["shared_gate"].shape[1]
        if fp8 and d % 128 == 0 and fs % 128 == 0:
            # plan-once + quantize-once, like the routed path: one G=1
            # plan and one quantization of x serve all three GEMMs
            splan = make_tile_plan(
                torch.full((1,), t, dtype=torch.int32, device=x.device), t,
                block_m=kcfg.block_m, num_groups=1) if planned else None
            qs = quantize_activation(x)
            if kcfg.fuse_producer:
                out = out + dense_ffn_fp8(
                    x, params["shared_gate"], params["shared_up"],
                    params["shared_down"], act="silu_mul", config=kcfg,
                    out_dtype=torch.float32, plan=splan, quantized=qs)
            else:
                sg = dense_linear_fp8(x, params["shared_gate"], config=kcfg,
                                      plan=splan, quantized=qs)
                su = dense_linear_fp8(x, params["shared_up"], config=kcfg,
                                      plan=splan, quantized=qs)
                out = out + dense_linear_fp8_fused(
                    sg, su, params["shared_down"], act="silu_mul",
                    config=kcfg, out_dtype=torch.float32, plan=splan)
        else:
            # bf16 shared experts: plain matmuls, as the reference leaves
            # them to XLA
            sh = _silu_mul_bf16(x @ params["shared_gate"],
                                x @ params["shared_up"])
            out = out + (sh @ params["shared_down"]).float()

    # ---- aux: load-balance loss + drop stats --------------------------------
    me = probs.mean(dim=0)
    ce = counts.float() / t          # mean over tokens of one_hot(ids).sum(1)
    aux = {
        "load_balance_loss": e * torch.sum(me * ce) / k,
        "dropped_fraction": 1.0 - total / num_slots,
        "expert_ids": ids,
    }
    return out.to(x.dtype), aux
