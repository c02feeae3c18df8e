"""Training step: forward, backward and AdamW, with microbatch gradient
accumulation; the JAX package's ``train/trainer.py``.

The global batch [B, S] is split into ``grad_accum`` microbatches of
[B / grad_accum, S]; their gradients are summed in f32 and averaged, then
one optimizer update runs.  Params and optimizer state are updated in
place (see :mod:`repro_torch.optim.adamw`).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.kernels import plan as plan_mod
from repro_torch.optim import adamw
from repro_torch.tree import tree_leaves, tree_unflatten


def value_and_grad(loss_fn: Callable, params, batch):
    """``((loss, metrics), grads)`` of ``loss_fn(params, batch)`` with
    respect to every param leaf; grads share the params' structure and
    dtypes.  The params carry ``requires_grad`` only during the call."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, metrics = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), tree_unflatten(params, grads)


def make_train_step(loss_fn: Callable, opt_cfg: adamw.OptConfig,
                    grad_accum: int = 1,
                    kernel_config: Optional[plan_mod.KernelConfig] = None,
                    wgrad_precision: Optional[str] = None):
    """loss_fn(params, batch) -> (loss, metrics dict of scalars).  Returns
    ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` with ``loss``, ``lr`` and ``grad_norm`` in the metrics.

    ``kernel_config`` pins the tile shapes of every grouped GEMM run under
    the step whose model carries no config of its own; ``wgrad_precision``
    (``"fp8"`` for the all-fp8 wgrad, ``None``/``"bf16"`` for the default)
    folds into it.  Both reach the layers through the plan module's
    default-config seam.
    """
    if kernel_config is not None or wgrad_precision is not None:
        inner_loss = loss_fn

        def loss_fn(params, batch):
            cfg = plan_mod.resolve_config(kernel_config)
            if wgrad_precision is not None:
                cfg = cfg.with_(wgrad_precision=wgrad_precision)
            with plan_mod.default_config(cfg):
                return inner_loss(params, batch)

    def train_step(params, opt_state, batch):
        if grad_accum == 1:
            (loss, metrics), grads = value_and_grad(loss_fn, params, batch)
        else:
            gsum, lsum = None, 0.0
            for i in range(grad_accum):
                mb = {k: v.reshape(grad_accum, v.shape[0] // grad_accum,
                                   *v.shape[1:])[i] for k, v in batch.items()}
                (l, _), g = value_and_grad(loss_fn, params, mb)
                g = tree_leaves(g)
                if gsum is None:
                    gsum = [x.to(torch.float32, copy=True) for x in g]
                else:
                    for a, b in zip(gsum, g):
                        a.add_(b.float())
                lsum = lsum + l
                del g
            grads = tree_unflatten(params, [a.div_(grad_accum) for a in gsum])
            loss = lsum / grad_accum
            metrics = {}
        params, opt_state, opt_metrics = adamw.apply_updates(
            params, grads, opt_state, opt_cfg)
        metrics = {**metrics, **opt_metrics, "loss": loss}
        return params, opt_state, metrics

    return train_step
