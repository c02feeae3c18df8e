"""Training step: forward, backward and AdamW, with microbatch gradient
accumulation; the JAX package's ``train/trainer.py``.

The global batch [B, S] is split into ``grad_accum`` microbatches of
[B / grad_accum, S]; their gradients are summed in f32 and averaged, then
one optimizer update runs.  Params and optimizer state are updated in
place (see :mod:`repro_torch.optim.adamw`).

On a mesh (the reference's batch spec ``P(("pod", "data"))`` on dim 0
under ``jit``): every rank is handed the same global batch and takes its
block of rows along the joint ``("pod", "data")`` axis; the loss, the
metrics and every gradient are averaged over that joint group (the
gradients in f32, one leaf at a time).  An FSDP leaf (its spec in
``specs``, the storage specs of the params, names ``data``) takes its
gradient from its gather's reduce-scatter, the mean over ``data``
already, and is then averaged over ``pod`` alone.  The clipping norm
counts each leaf over every axis its spec names.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.distributed import context as dctx
from repro_torch.distributed.sharding import spec_axes
from repro_torch.kernels import plan as plan_mod
from repro_torch.optim import adamw
from repro_torch.tree import tree_leaves, tree_paths, tree_unflatten


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


def data_rows(batch: dict, mesh) -> dict:
    """This rank's rows (dim 0) of the global ``batch``: its block of the
    joint ``("pod", "data")`` axis."""
    n, i = mesh.batch_ranks, mesh.batch_coord()
    if n == 1:
        return batch
    out = {}
    for k, v in batch.items():
        if v.shape[0] % n:
            raise ValueError(f"batch {k} of {v.shape[0]} rows does not "
                             f"split over {n} batch ranks")
        out[k] = v.chunk(n)[i]
    return out


def _mean_over(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """The mean of ``x`` over ``group`` (n ranks), reduced in f32."""
    return dctx.all_reduce(x.float(), group).div_(n).to(x.dtype)


def make_grad_fn(loss_fn: Callable, grad_accum: int = 1, mesh=None,
                 specs: Optional[dict] = None):
    """``grad_fn(params, batch) -> ((loss, metrics), grads)`` over the
    global ``batch``: its ``grad_accum`` microbatches' gradients summed in
    f32 and averaged; on a mesh, this rank's rows, and the loss, the
    metrics and the gradients averaged over the joint batch group (an
    FSDP leaf of ``specs`` over ``pod`` alone)."""
    n_data = 1 if mesh is None else mesh.batch_ranks
    data_group = None if mesh is None else mesh.batch_group()
    n_pod = 1 if mesh is None else mesh.shape.get("pod", 1)
    pod_group = mesh.group("pod") if n_pod > 1 else None

    def grad_fn(params, batch):
        if mesh is not None:
            batch = data_rows(batch, mesh)
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
        if mesh is not None:
            loss = _mean_over(torch.as_tensor(loss), data_group, n_data)
            metrics = {k: _mean_over(v, data_group, n_data)
                       for k, v in metrics.items()}
            for p, g in tree_paths(grads) if n_data > 1 else ():
                if specs is not None and "data" in spec_axes(specs[p]):
                    if n_pod > 1:
                        g.copy_(_mean_over(g, pod_group, n_pod))
                else:
                    g.copy_(_mean_over(g, data_group, n_data))
        return (loss, metrics), grads

    return grad_fn


def make_train_step(loss_fn: Callable, opt_cfg: adamw.OptConfig,
                    grad_accum: int = 1,
                    kernel_config: Optional[plan_mod.KernelConfig] = None,
                    wgrad_precision: Optional[str] = None,
                    mesh=None, specs: Optional[dict] = None):
    """loss_fn(params, batch) -> (loss, metrics dict of scalars).  Returns
    ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` with ``loss``, ``lr`` and ``grad_norm`` in the metrics.

    ``kernel_config`` pins the tile shapes of every grouped GEMM run under
    the step whose model carries no config of its own; ``wgrad_precision``
    (``"fp8"`` for the all-fp8 wgrad, ``None``/``"bf16"`` for the default)
    folds into it.  Both reach the layers through the plan module's
    default-config seam.  ``mesh`` (with ``specs``, the path -> spec of
    the params as stored) makes the step data-parallel over its batch
    axes: each rank's step takes the same global batch.  The step's
    parts are its attributes: ``grad_fn(params, batch) -> ((loss,
    metrics), grads)`` and ``update(params, grads, opt_state) -> (params,
    opt_state, opt_metrics)``.
    """
    if kernel_config is not None or wgrad_precision is not None:
        inner_loss = loss_fn

        def loss_fn(params, batch):
            cfg = plan_mod.resolve_config(kernel_config)
            if wgrad_precision is not None:
                cfg = cfg.with_(wgrad_precision=wgrad_precision)
            with plan_mod.default_config(cfg):
                return inner_loss(params, batch)

    grad_fn = make_grad_fn(loss_fn, grad_accum, mesh, specs)

    def update(params, grads, opt_state):
        axes = None if mesh is None else \
            [spec_axes(specs[p]) for p, _ in tree_paths(params)]
        return adamw.apply_updates(params, grads, opt_state, opt_cfg,
                                   axes=axes, mesh=mesh)

    def train_step(params, opt_state, batch):
        (loss, metrics), grads = grad_fn(params, batch)
        params, opt_state, opt_metrics = update(params, grads, opt_state)
        metrics = {**metrics, **opt_metrics, "loss": loss}
        return params, opt_state, metrics

    # the step's two parts, for a caller that accounts for them apart
    # (the dry run: the gradient part once a microbatch, the update once)
    train_step.grad_fn, train_step.update = grad_fn, update
    return train_step
