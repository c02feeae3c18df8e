"""AdamW with warmup + cosine schedule, global-norm clipping, optional f32
master weights (for bf16 models) and optional int8 error-feedback
gradient compression: the JAX package's ``optim/adamw.py``.

State is a plain dict of tensors on the params' device: f32 ``m``, ``v``
(and ``master``, ``ef``) trees shaped like the params, and a 0-d int32
``step``.  Unlike the reference, :func:`apply_updates` updates the params
and the state IN PLACE, one tensor at a time under ``torch.no_grad()``:
the global norm is taken first, then each tensor is clipped and updated,
so at most a few f32 temporaries of one tensor exist at once (an f32 copy
of every gradient of a 2.9 B-parameter model would be 11.6 GB).  The int8
compression scales each tensor by its own max; the port's decoder keeps
one tensor per layer where the JAX package stacks the layers, so there
each layer gets its own scale.

Sharded params (``axes``: per leaf, in ``tree_leaves`` order, the mesh
axes its storage spec names, ``distributed.sharding.spec_axes``; with
``mesh``) hold only this rank's slice.  The clipping norm is the whole
logical tree's: each leaf's squares are summed over every axis its spec
names (``data`` too, under FSDP), the replicated ones counted once; the
int8 compression's max is the whole logical tensor's, a max over the
same axes.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

from repro_torch.distributed import context as dctx
from repro_torch.tree import tree_leaves, tree_map

# XLA compiles the reference's division by the constant 127 into a
# multiplication by its f32 reciprocal; the port does the same so the two
# pick the same int8 rounding
INT8_MAX_RECIP = float(torch.tensor(1.0 / 127.0, dtype=torch.float32))


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    clip_norm: float = 1.0
    use_master: bool = True          # keep an f32 master copy of bf16 params
    compress_grads: bool = False     # int8 + error feedback (cross-pod AR)


def schedule(step: torch.Tensor, cfg: OptConfig) -> torch.Tensor:
    """Learning rate at ``step`` (a tensor): linear warmup, then cosine
    decay to ``min_lr_ratio * lr`` at ``total_steps``."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def init_opt_state(params, cfg: OptConfig) -> dict:
    leaf = tree_leaves(params)[0]

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    state = {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
             "step": torch.zeros((), dtype=torch.int32, device=leaf.device)}
    if cfg.use_master:
        state["master"] = tree_map(
            lambda p: p.detach().to(torch.float32, copy=True), params)
    if cfg.compress_grads:
        state["ef"] = tree_map(zeros, params)
    return state


def _norm(squares, axes, mesh) -> torch.Tensor:
    """sqrt of the sum of ``squares`` (one 0-d f32 tensor a leaf), each
    leaf's summed over the mesh axes ``axes`` gives it (none without
    ``axes``)."""
    parts = {}
    for i, sq in enumerate(squares):
        key = tuple(sorted(set(axes[i]))) if axes else ()
        parts[key] = parts.get(key, 0.0) + sq
    total = 0.0
    for key in sorted(parts):
        part = parts[key]
        for a in key:
            part = dctx.all_reduce(part, mesh.group(a))
        total = total + part
    return torch.sqrt(torch.as_tensor(total))


def global_norm(tree, *, axes=None, mesh=None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf of the logical tree, in
    f32, one leaf at a time."""
    return _norm((torch.sum(xf * xf) for xf in
                   (x.float() for x in tree_leaves(tree))), axes, mesh)


def _amax(t: torch.Tensor, axes, mesh) -> torch.Tensor:
    """The largest ``|t|`` of the logical tensor whose slice ``t`` is, a
    max over the mesh axes ``axes`` (an empty slice counts 0)."""
    m = t.abs().amax() if t.numel() else t.new_zeros(())
    for a in axes:
        m = dctx.all_reduce(m, mesh.group(a), op=dist.ReduceOp.MAX)
    return m


def _compress_int8(g: torch.Tensor, ef: torch.Tensor, axes=(), mesh=None):
    """Error-feedback int8 compression: quantize (g + residual) per
    tensor (the whole logical tensor's max, over ``axes``); return the
    dequantized value actually 'transmitted' and the new residual."""
    t = g.float() + ef
    scale = torch.clamp(_amax(t, axes, mesh), min=1e-30) * INT8_MAX_RECIP
    q = torch.clamp(torch.round(t / scale), -127, 127)
    # XLA fuses the reference's t - q * scale into one multiply-add, one
    # rounding; q * scale is exact in f64, so this rounds the same way
    resid = (t.double() - q.double() * scale.double()).float()
    return q * scale, resid


def _grad_f32(g: torch.Tensor, ef, axes=(), mesh=None):
    """The gradient as the optimizer sees it, a fresh f32 tensor, with the
    new error-feedback residual (None without compression)."""
    if ef is None:
        return g.to(torch.float32, copy=True), None
    return _compress_int8(g, ef, axes, mesh)


@torch.no_grad()
def apply_updates(params, grads, state: dict, cfg: OptConfig, *,
                  axes=None, mesh=None):
    """One AdamW step, in place.  Returns ``(params, state, metrics)``
    (the same param and state objects) with ``lr`` and ``grad_norm``.
    ``axes`` (with ``mesh``): per leaf, the mesh axes its slice is taken
    over (module docstring)."""
    step = state["step"] + 1
    lr = schedule(step, cfg)
    ps, gs = tree_leaves(params), tree_leaves(grads)
    ms, vs = tree_leaves(state["m"]), tree_leaves(state["v"])
    masters = tree_leaves(state["master"]) if cfg.use_master else ps
    efs = tree_leaves(state["ef"]) if cfg.compress_grads else [None] * len(ps)
    if len(gs) != len(ps):
        raise ValueError(f"{len(gs)} gradients for {len(ps)} params")
    lax = axes or [()] * len(ps)

    # the norm of what is transmitted; each compressed gradient is made
    # again below rather than kept (compression is deterministic)
    gnorm = _norm((torch.sum(gf * gf) for gf in
                   (_grad_f32(g, ef, a, mesh)[0]
                    for g, ef, a in zip(gs, efs, lax))), axes, mesh)
    clip = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                       max=1.0)
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, device=step.device), step.float())
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, device=step.device), step.float())

    for p, g, m, v, master, ef, a in zip(ps, gs, ms, vs, masters, efs, lax):
        gf, new_ef = _grad_f32(g, ef, a, mesh)
        if ef is not None:
            ef.copy_(new_ef)
        gf.mul_(clip)
        m.mul_(cfg.b1).add_(gf, alpha=1 - cfg.b1)
        v.mul_(cfg.b2).addcmul_(gf, gf, value=1 - cfg.b2)
        del gf
        if master.dtype != torch.float32:      # bf16 params, no master
            master = master.float()
        upd = (m / b1c).div_((v / b2c).sqrt_().add_(cfg.eps))
        upd.add_(master, alpha=cfg.weight_decay)
        master.sub_(upd.mul_(lr))
        if master is not p:
            p.copy_(master)
    state["step"] = step
    return params, state, {"lr": lr, "grad_norm": gnorm}
