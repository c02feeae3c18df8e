"""Logical activation specs and the collectives of the port.

The JAX package's ``distributed/context.py``: :func:`spec_for` maps
logical axis names to mesh axes with the reference's rules, bit for bit
(a spec is a tuple of mesh axis names, tuples of them, or None, as a
``PartitionSpec``).  The reference keeps its mesh and its rule overrides
(``set_mesh(mesh, rules)``; its dry run sets ``{"seq": "model"}`` under
``seq_shard``) in process-wide state that its launcher sets; here both
are arguments, as every caller holds them.  The reference's
``constrain`` places activations for GSPMD; local shards have nothing to
place, so it has no counterpart here: the collectives it implies are
explicit (below).

The collectives go through :func:`all_reduce` and :func:`all_gather`,
which count their calls and bytes in :data:`COLLECTIVES`, in all and by
type (the reference dry run's names: ``all-reduce``, ``all-gather``;
``gather`` for a checkpoint's gathers).
:func:`reduce_from` and :func:`copy_to` are the two halves of a sharded
layer's gradient that ``shard_map``'s transpose gives the reference: the
sum of the ranks' partial outputs (forward sum, backward identity) and
the replicated input whose gradient each rank holds a part of (forward
identity, backward sum).  The gloo backend reduces CUDA tensors but
gathers only host ones, so :func:`all_gather` stages through the host
under gloo.

Sequence parallelism (Megatron-SP; the reference's ``seq_shard``, whose
residual stream GSPMD keeps split over ``model`` along the sequence):
:func:`gather_seq` gathers a sequence-split activation before a
tensor-parallel module (backward: a reduce-scatter of the ranks'
partial gradients) and :func:`scatter_seq` reduce-scatters a
row-parallel module's partial outputs back to this rank's chunk
(backward: a gather).  :func:`split_seq` takes this rank's chunk of a
replicated activation (backward: a gather) and ``gather_seq(...,
grad="own")`` rebuilds a replicated one (backward: this rank's chunk of
a gradient every rank holds whole).  FSDP (ZeRO-3 storage over
``data``): :func:`gather_data` all-gathers a stored shard at use
(backward: the gradient reduce-scattered, divided by the group's size
as the data mean is), and :func:`broadcast_from` hands a leaf that one
rank of the group stores whole to the others (backward: the mean
reduced onto that rank).  A reduce-scatter is an :func:`all_reduce`
and a narrow (gloo has no reduce-scatter), so every collective is
counted.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

# logical activation axis -> mesh axes (None = replicated)
_DEFAULT_RULES = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,          # activations replicated over `model` between ops
    "heads": "model",
    "mlp": "model",
    "vocab": "model",
    "expert": "model",
    "kv_seq": "model",      # decode KV caches: sequence-sharded (flash-decode)
}

#: calls and bytes of every collective this process made, in all and
#: under ``per_type``: collective type -> {"calls", "bytes",
#: "result_bytes"}.  ``bytes`` are the inputs this rank hands in;
#: ``result_bytes`` the result buffers, the reference dry run's unit (an
#: all-gather's result is the group's size times its input)
COLLECTIVES = {"calls": 0, "bytes": 0, "per_type": {}}


def model_axis_size(mesh) -> int:
    """The size of ``mesh``'s model axis (1 without a mesh)."""
    if mesh is None or "model" not in mesh.axis_names:
        return 1
    return mesh.shape["model"]


def spec_for(shape, logical_axes, mesh, rules=None) -> tuple:
    """The spec of ``shape`` given per-dim logical names, dropping any
    axis that does not divide the dim (GQA kv-head replication etc.).
    A mesh axis is used at most once per spec; feature axes (heads/mlp/
    vocab/...) take priority over "seq" (sequence parallelism is applied
    only where it doesn't conflict).  ``rules`` overrides entries of the
    default rules, as the reference's ``set_mesh(mesh, rules)``.  ``()``
    without a mesh."""
    if mesh is None:
        return ()
    table = {**_DEFAULT_RULES, **(rules or {})}
    parts = [None] * len(shape)
    used: set = set()

    def try_assign(i, name):
        axes = None if name is None else table.get(name)
        if axes is None:
            return
        tup = axes if isinstance(axes, tuple) else (axes,)
        tup = tuple(a for a in tup if a in mesh.axis_names
                    and a not in used)
        size = 1
        for a in tup:
            size *= mesh.shape[a]
        if size > 1 and shape[i] % size == 0:
            parts[i] = tup if len(tup) > 1 else tup[0]
            used.update(tup)

    order = [i for i, n in enumerate(logical_axes) if n not in (None, "seq")]
    order += [i for i, n in enumerate(logical_axes) if n == "seq"]
    for i in order:
        try_assign(i, logical_axes[i])
    return tuple(parts)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def default_backend(device) -> str:
    """``nccl`` for a CUDA device, ``gloo`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def count_collective(x: torch.Tensor, kind: str, parts: int = 1) -> None:
    """Count one collective of type ``kind`` on input ``x`` whose result
    holds ``parts`` such inputs (an all-gather's or a gather's: the
    group's size).  The ``per_type`` table is replaced, never changed in
    place, so a shallow copy of :data:`COLLECTIVES` stays a consistent
    snapshot."""
    nbytes = x.numel() * x.element_size()
    COLLECTIVES["calls"] += 1
    COLLECTIVES["bytes"] += nbytes
    old = COLLECTIVES["per_type"].get(
        kind, {"calls": 0, "bytes": 0, "result_bytes": 0})
    COLLECTIVES["per_type"] = {**COLLECTIVES["per_type"], kind: {
        "calls": old["calls"] + 1, "bytes": old["bytes"] + nbytes,
        "result_bytes": old["result_bytes"] + parts * nbytes}}


def reset_collectives() -> None:
    COLLECTIVES.update(calls=0, bytes=0, per_type={})


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Reduce ``x`` over ``group`` in place (and return it)."""
    count_collective(x, "all-reduce")
    dist.all_reduce(x, op=op, group=group)
    return x


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's tensors concatenated along ``dim``, in group-rank
    order, bit for bit: the ranks exchange raw bytes."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    dev = x.device
    x = x.contiguous()
    if dist.get_backend(group) == "gloo":
        x = x.cpu()
    raw = x.reshape(-1).view(torch.uint8)
    parts = [torch.empty_like(raw) for _ in range(n)]
    count_collective(raw, "all-gather", n)
    dist.all_gather(parts, raw, group=group)
    return torch.cat([p.view(x.dtype).reshape(x.shape) for p in parts],
                     dim).to(dev)


class _ReduceFrom(torch.autograd.Function):
    """Sum of the ranks' partials; each rank's partial takes the whole
    gradient of the sum."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _CopyTo(torch.autograd.Function):
    """A replicated input of a sharded computation: each rank's gradient
    is a part of the whole, which is their sum."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dx):
        return all_reduce(dx.contiguous().clone(), ctx.group), None


class _MeanOver(torch.autograd.Function):
    """The mean over the group; its backward is the mean of the ranks'
    gradients, the convention of a data-parallel step, which averages
    every rank's gradients over the same group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.clone(), group).div_(dist.get_world_size(group))

    @staticmethod
    def backward(ctx, dy):
        n = dist.get_world_size(ctx.group)
        return all_reduce(dy.contiguous().clone(), ctx.group).div_(n), None


def mean_over(x: torch.Tensor, group) -> torch.Tensor:
    return _MeanOver.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFrom.apply(x, group)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyTo.apply(x, group)


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def own_chunk(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's contiguous chunk of ``x`` along ``dim`` (group-rank
    order), a view."""
    c = x.shape[dim] // group_size(group)
    return x.narrow(dim, group_rank(group) * c, c)


def _wide(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def _reduce_own(dy: torch.Tensor, dim: int, group, mean: bool):
    """This rank's chunk of the group's sum (or mean) of ``dy``, reduced
    in f32 (or wider) and cast back: a reduce-scatter."""
    g = all_reduce(dy.to(_wide(dy.dtype), copy=True).contiguous(), group)
    if mean:
        g.div_(group_size(group))
    return own_chunk(g, dim, group).to(dy.dtype).contiguous()


class _Gather(torch.autograd.Function):
    """The group's tensors concatenated along ``dim``.  Its backward:
    ``"sum"``, the ranks' partial gradients summed and this rank's chunk
    kept (a reduce-scatter); ``"mean"``, the same divided by the group's
    size (FSDP: a data-parallel gradient); ``"own"``, this rank's chunk
    of a gradient every rank holds whole."""

    @staticmethod
    def forward(ctx, x, dim, group, grad):
        ctx.dim, ctx.group, ctx.grad = dim, group, grad
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, dy):
        if ctx.grad == "own":
            dx = own_chunk(dy, ctx.dim, ctx.group).contiguous()
        else:
            dx = _reduce_own(dy, ctx.dim, ctx.group, ctx.grad == "mean")
        return dx, None, None, None


class _Chunk(torch.autograd.Function):
    """This rank's chunk along ``dim`` of the ranks' sum (``reduce``: a
    reduce-scatter of partials, summed in ``x``'s dtype; the row-parallel
    partials are f32) or of a tensor every rank holds whole; its
    backward gathers the chunks' gradients, so whatever made ``x`` sees
    the whole gradient on every rank."""

    @staticmethod
    def forward(ctx, x, dim, group, reduce):
        ctx.dim, ctx.group = dim, group
        if reduce:
            x = all_reduce(x.contiguous().clone(), group)
        return own_chunk(x, dim, group).contiguous()

    @staticmethod
    def backward(ctx, dy):
        return all_gather(dy, ctx.dim, ctx.group), None, None, None


def gather_seq(x: torch.Tensor, group, dim: int = 1, grad: str = "sum"):
    """The whole sequence from every rank's chunk (``grad``: see
    :class:`_Gather`; ``"sum"`` before a tensor-parallel module, whose
    ranks' input gradients are partial, ``"own"`` before a module every
    rank runs whole)."""
    return _Gather.apply(x, dim, group, grad)


def scatter_seq(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """This rank's chunk of the sum of the ranks' partials ``x``."""
    return _Chunk.apply(x, dim, group, True)


def split_seq(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """This rank's chunk of ``x``, which every rank holds whole."""
    return _Chunk.apply(x, dim, group, False)


def gather_data(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """An FSDP shard gathered at use; the gradient goes back as this
    rank's chunk of the group's mean."""
    return _Gather.apply(x, dim, group, "mean")


class _BroadcastFrom(torch.autograd.Function):
    """The tensor the group's rank ``src`` holds, on every rank (an
    all-reduce in which the other ranks add zeros: exact); its backward
    reduces the mean of the ranks' gradients onto ``src`` (the others'
    placeholders take an empty gradient)."""

    @staticmethod
    def forward(ctx, x, src, shape, group):
        ctx.src, ctx.group = src, group
        ctx.like = (x.shape, x.dtype, x.device)
        here = dist.get_rank(group) == src
        buf = x.clone() if here else x.new_zeros(shape)
        return all_reduce(buf, group)

    @staticmethod
    def backward(ctx, dy):
        g = all_reduce(dy.to(_wide(dy.dtype), copy=True).contiguous(),
                       ctx.group).div_(group_size(ctx.group))
        if dist.get_rank(ctx.group) != ctx.src:
            shape, dtype, device = ctx.like
            return (torch.zeros(shape, dtype=dtype, device=device), None,
                    None, None)
        return g.to(dy.dtype), None, None, None


def broadcast_from(x: torch.Tensor, src: int, shape, group) -> torch.Tensor:
    """The ``shape`` tensor that the group's rank ``src`` holds as ``x``
    (the other ranks pass an empty placeholder)."""
    return _BroadcastFrom.apply(x, src, tuple(shape), group)


def check_equal(x: torch.Tensor, group, what: str) -> None:
    """Raise unless ``x`` (integers) is the same on every rank of
    ``group``: one MAX reduction of ``[x, -x]``."""
    if group_size(group) == 1:
        return
    both = torch.stack([x, -x]).to(torch.int64)
    all_reduce(both, group, op=dist.ReduceOp.MAX)
    if not (torch.equal(both[0], x.to(torch.int64))
            and torch.equal(-both[1], x.to(torch.int64))):
        raise RuntimeError(f"{what} differs between the ranks of the group")
