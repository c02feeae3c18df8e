"""Parameter partition rules (logical-name based, MaxText-style) and the
slicing and gathering of sharded leaves; no model is imported here.

:func:`build_param_specs` is the JAX package's ``distributed/sharding.py``
rule for rule: a spec per leaf from its path and rank, with the same
divisibility guard (dims that do not divide their axes are replicated,
e.g. 4 KV heads on a 16-way model axis) and the same FSDP extension.
The reference stacks layers under ``layers`` (a leading layer axis that
takes a leading ``None``); the port keeps one dict per layer in a list
(``layers/<i>/...``), so its specs are the reference's without that
``None``; ``models.transformer.reference_stack`` tells it which leaves
the reference stacks, and where, for the FSDP rule.  Where that rule
shards the stacked layer axis itself, the spec is an :class:`Owner`:
the data rank whose block of layers holds the leaf keeps it whole.
Specs are tuples of mesh axis names (or tuples of names, sliced
major-first) and ``None``, one entry per leading dim, as
``tuple(PartitionSpec)`` (missing trailing entries are ``None``); a
tree's specs are a dict keyed by leaf path; :func:`spec_axes` names the
axes of either kind.  :func:`rule_spec` is the rule of one leaf before
the divisibility guard: ``core.moe``'s ``shard_moe_params`` reads an MoE
layer's layout from it; :func:`rule_dim` is the logical dim (heads, kv
heads, ``d_ff``, vocab, recurrent width) the rule splits, which
``models.transformer.tp_split`` decides for each model;
:func:`rule_storage` applies the guard and the FSDP rule to one leaf.

What the port stores sharded is ``models.transformer.storage_specs``:
the MoE leaves, and the dense leaves where their heads, widths or vocab
divide the model axis, each extended over ``data`` under FSDP.
:func:`slice_leaf` / :func:`shard_tree` keep a rank's slices,
:func:`use_leaf` / :func:`use_tree` gather an FSDP shard at use (its
gradient reduce-scattered back), :func:`gather_leaf` /
:func:`gather_tree` rebuild the full logical arrays (a checkpoint's),
leaf by leaf.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Optional

import torch

from repro_torch.distributed import context as dctx
from repro_torch.tree import tree_paths, tree_unflatten

#: the reference's ``fsdp_min_size``: FSDP shards a leaf of this many
#: elements or more (its stacked copies counted), smaller ones stay whole
FSDP_MIN_SIZE = 1 << 20

# (path regex, spec for the logical [unstacked] shape, the logical dim
# the spec's "model" entry splits: what ``models.transformer.tp_split``
# decides per model)
# weight naming is a repo-wide convention (models/layers.py)
_RULES_2D = [
    (r"(^|/)wq$", (None, "model"), "heads"),
    (r"(^|/)(wk|wv)$", (None, "model"), "kv"),
    (r"(^|/)wo$", ("model", None), "heads"),
    (r"(^|/)(w_gate|w_up)$", (None, "model"), "mlp"),
    (r"(^|/)w_down$", ("model", None), "mlp"),
    (r"(^|/)shared_(gate|up)$", (None, "model"), "mlp"),
    (r"(^|/)shared_down$", ("model", None), "mlp"),
    (r"(^|/)embedding$", ("model", None), "vocab"),
    (r"(^|/)lm_head$", (None, "model"), "vocab"),
    (r"(^|/)router$", (), None),
    (r"(^|/)vision_proj$", (), None),
    (r"(^|/)(w_in|w_x|w_y)$", (None, "model"), "recurrent"),  # in-projs
    (r"(^|/)w_out$", ("model", None), "recurrent"),           # out-proj
]
_RULES_1D = [
    (r"(^|/)bq$", ("model",), "heads"),
    (r"(^|/)b[kv]$", ("model",), "kv"),
    (r"(^|/)(b_in|b_x|b_y)$", ("model",), "recurrent"),
]
# MoE 3-D experts tensors: EP shards dim0 (experts); TP shards the d_ff dim
_MOE_3D = {
    "w_gate": {"ep": ("model", None, None), "tp": (None, None, "model")},
    "w_up": {"ep": ("model", None, None), "tp": (None, None, "model")},
    "w_down": {"ep": ("model", None, None), "tp": (None, "model", None)},
}


def _rule(path: str, ndim: int) -> "tuple[tuple, Optional[str]]":
    """(spec, logical dim) of the first rule matching ``path``."""
    rules = _RULES_2D if ndim >= 2 else _RULES_1D
    if "/moe/" in path or path.startswith("moe/"):
        rules = _RULES_2D + _RULES_1D
    return next(((spec, dim) for pat, spec, dim in rules
                 if re.search(pat, path)), ((), None))


def rule_spec(path: str, ndim: int, moe_mode: str) -> tuple:
    """The rule's spec of the leaf at ``path`` with ``ndim`` dims (an MoE
    layer's leaves lie under ``moe/``), before the divisibility guard."""
    last = path.rsplit("/", 1)[-1]
    if ("/moe/" in path or path.startswith("moe/")) and last in _MOE_3D \
            and ndim >= 3:
        return _MOE_3D[last][moe_mode]
    return _rule(path, ndim)[0]


def rule_dim(path: str, ndim: int) -> Optional[str]:
    """The logical dim (``"heads"``, ``"kv"``, ``"mlp"``, ``"vocab"``,
    ``"recurrent"``) that the rule of a dense leaf splits over the model
    axis; None for a leaf the rules keep whole."""
    return _rule(path, ndim)[1]


def _axis_size(mesh, ax) -> int:
    return math.prod(mesh.shape[a] for a in
                     (ax if isinstance(ax, tuple) else (ax,)))


@dataclasses.dataclass(frozen=True)
class Owner:
    """The spec of a leaf the reference stacks with its layer copies and
    shards along that layer axis over ``axis`` (FSDP, where the layer axis
    is the largest that divides): a per-layer tree has no such axis, so
    the rank at ``index`` along ``axis`` (the one whose block of layers
    holds this one) keeps the leaf whole, or its model slice by ``spec``,
    of ``shape``; every other rank of the axis holds an empty placeholder
    and is handed the leaf at use (``context.broadcast_from``).  Each rank
    then holds the bytes the reference's spec gives it."""
    axis: str
    index: int
    spec: tuple
    shape: tuple


def _names(ax, axis: str) -> bool:
    """Whether the spec entry ``ax`` (an axis, a tuple of them, or None)
    names ``axis``."""
    return axis in (ax if isinstance(ax, tuple) else (ax,))


def spec_axes(spec) -> tuple:
    """Every mesh axis ``spec`` names (a tuple spec or an :class:`Owner`),
    in order."""
    if isinstance(spec, Owner):
        return spec_axes(spec.spec) + (spec.axis,)
    out = []
    for ax in spec:
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            if a is not None:
                out.append(a)
    return tuple(out)


def _fsdp(shape, out, mesh, stacked, fsdp_min_size):
    """``out`` (a leaf's model-axis spec, a list) extended by the
    reference's FSDP rule over ``data``: an already model-sharded dim
    that ``data`` also divides takes ``("model", "data")``; else the
    largest unsharded dim ``data`` divides takes it; where that is the
    reference's stacked layer axis (``stacked``: the leaf's ``(copies,
    position)`` in its stack), the layer's owner keeps it
    (:class:`Owner`)."""
    ndim = len(shape)
    copies, pos = stacked if stacked is not None else (None, None)
    size = math.prod(shape) * (copies or 1)
    if "data" not in mesh.axis_names or ndim + (copies is not None) < 2 \
            or size < fsdp_min_size:
        return tuple(out)
    dsz = mesh.shape["data"]
    ext = [i for i in range(ndim)
           if out[i] == "model"
           and shape[i] % (dsz * mesh.shape["model"]) == 0]
    if ext:
        out[ext[0]] = ("model", "data")
        return tuple(out)
    cands = sorted((i for i in range(ndim)
                    if out[i] is None and shape[i] % dsz == 0),
                   key=lambda i: -shape[i])
    if copies is not None and copies % dsz == 0 and \
            (not cands or copies >= shape[cands[0]]):
        local = tuple(n // (_axis_size(mesh, ax) if ax else 1)
                      for n, ax in zip(shape, out))
        return Owner("data", pos // (copies // dsz), tuple(out), local)
    if cands:
        out[cands[0]] = "data"
    return tuple(out)


def build_param_specs(params, mesh, *, moe_mode: str = "ep",
                      fsdp: bool = False,
                      fsdp_min_size: Optional[int] = None,
                      stack: Optional[dict] = None) -> dict:
    """Path -> spec of every leaf of ``params`` (STORAGE sharding), the
    reference's rules on the port's unstacked tree.

    ``fsdp=True`` additionally shards the largest remaining unsharded dim
    of every big weight over the ``data`` axis (ZeRO-3 storage), extending
    an already model-sharded dim with ``data`` where it divides.  The
    reference decides "big" (``fsdp_min_size``, :data:`FSDP_MIN_SIZE` by
    default) and "a weight" (two dims
    or more) on its stacked leaf; ``stack``
    (``models.transformer.reference_stack``) gives the copies it stacks a
    layer's leaves with and the layer's place among them, so the port
    decides as it does.  Where the reference shards the stacked layer
    axis itself, which a per-layer tree has not, the spec is an
    :class:`Owner`.
    """
    return {path: rule_storage(path, tuple(leaf.shape),
                               rule_spec(path, leaf.dim(), moe_mode), mesh,
                               fsdp=fsdp, fsdp_min_size=fsdp_min_size,
                               stack=stack)
            for path, leaf in tree_paths(params)}


def rule_storage(path: str, shape: tuple, spec: tuple, mesh, *,
                 fsdp: bool = False, fsdp_min_size: Optional[int] = None,
                 stack: Optional[dict] = None):
    """The storage spec of the leaf at ``path`` of ``shape`` from its
    model-axis rule ``spec``: the divisibility guard, then, with
    ``fsdp``, the FSDP rule (:func:`build_param_specs`)."""
    ndim = len(shape)
    parts = list(spec) + [None] * (ndim - len(spec))
    out = [None if ax is None or dim % _axis_size(mesh, ax) else ax
           for dim, ax in zip(shape, parts)]
    out += [None] * (ndim - len(out))
    if not fsdp:
        return tuple(out)
    top = path.split("/")
    stacked = (stack[top[0]][int(top[1])]
               if stack and top[0] in stack and len(top) > 1 else None)
    return _fsdp(shape, out, mesh, stacked,
                 FSDP_MIN_SIZE if fsdp_min_size is None else fsdp_min_size)


def _chunks(spec_entry, mesh) -> "tuple[int, int]":
    """(index, count) of this rank's chunk of a dim sharded over
    ``spec_entry`` (one axis, or a tuple with the first axis major)."""
    axes = spec_entry if isinstance(spec_entry, tuple) else (spec_entry,)
    idx, n = 0, 1
    for a in axes:
        idx = idx * mesh.shape[a] + mesh.coord(a)
        n *= mesh.shape[a]
    return idx, n


def slice_leaf(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's slice of the full leaf ``x``, a tensor of its own (an
    :class:`Owner` leaf: its model slice on the owner, an empty
    placeholder elsewhere)."""
    if isinstance(spec, Owner):
        x = slice_leaf(x, spec.spec, mesh)
        if mesh.coord(spec.axis) == spec.index:
            return x if x.shape == spec.shape else x.clone()
        return x.new_empty((0,) + tuple(x.shape[1:]))
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        idx, n = _chunks(ax, mesh)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not "
                             f"divide over {ax} ({n})")
        c = x.shape[dim] // n
        x = x.narrow(dim, idx * c, c)
    return x.clone() if any(a is not None for a in spec) else x


def local_numel(shape, spec, mesh) -> int:
    """Elements of this rank's slice of a leaf of ``shape`` stored by
    ``spec``: the reference's arithmetic (an :class:`Owner` leaf: all of
    its model slice on the owner, none elsewhere)."""
    if isinstance(spec, Owner):
        return math.prod(spec.shape) if \
            mesh.coord(spec.axis) == spec.index else 0
    n = math.prod(shape)
    for ax in spec:
        if ax is not None:
            n //= _axis_size(mesh, ax)
    return n


def use_leaf(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The leaf as the model computes with it: this rank's model-axis
    slice, its FSDP shard gathered over ``data`` (the gradient
    reduce-scattered back as the data mean; an :class:`Owner` leaf
    broadcast from its owner).  ``x`` itself where ``spec`` names no
    ``data``."""
    if isinstance(spec, Owner):
        return dctx.broadcast_from(x, spec.index, spec.shape,
                                   mesh.group(spec.axis))
    for dim, ax in enumerate(spec):
        if _names(ax, "data"):
            x = dctx.gather_data(x, dim, mesh.group("data"))
    return x


def use_tree(tree, specs: dict, mesh, prefix: str = ""):
    """:func:`use_leaf` of every leaf of ``tree`` (its paths under
    ``prefix`` in ``specs``); the tree itself where none names data."""
    named = tree_paths(tree)
    if not any("data" in spec_axes(specs[prefix + p]) for p, _ in named):
        return tree
    return tree_unflatten(tree, [use_leaf(x, specs[prefix + p], mesh)
                                 for p, x in named])


def gather_leaf(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The full leaf from every rank's slice ``x`` (a collective over the
    axes ``spec`` names)."""
    if isinstance(spec, Owner):
        with torch.no_grad():
            x = dctx.broadcast_from(x, spec.index, spec.shape,
                                    mesh.group(spec.axis))
        spec = spec.spec
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        for a in reversed(ax if isinstance(ax, tuple) else (ax,)):
            x = dctx.all_gather(x, dim, mesh.group(a))
    return x


def shard_tree(tree, specs: dict, mesh, prefix: str = ""):
    """A tree of this rank's slices of ``tree``'s full leaves (their
    paths under ``prefix`` in ``specs``)."""
    return tree_unflatten(tree, [slice_leaf(x, specs[prefix + p], mesh)
                                 for p, x in tree_paths(tree)])


def _gather_one(x: torch.Tensor, dim: int, group, dst: int):
    """The concatenation along ``dim`` of the group's ``x`` on its rank
    ``dst`` (one ``gather``: each rank sends its part once), None on the
    others."""
    import torch.distributed as dist
    n = dist.get_world_size(group)
    here = dist.get_rank(group) == dst
    raw = x.contiguous().reshape(-1).view(torch.uint8)   # any dtype
    if raw.device.type == "cuda" and dist.get_backend(group) == "gloo":
        raw = raw.cpu()
    parts = [torch.empty_like(raw) for _ in range(n)] if here else None
    dctx.count_collective(raw, "gather", n)
    dist.gather(raw, parts, dst=dist.get_global_rank(group, dst),
                group=group)
    if not here:
        return None
    return torch.cat([q.view(x.dtype).reshape(x.shape) for q in parts],
                     dim).to(x.device)


def _gather_to(x: torch.Tensor, spec, mesh, dst: int):
    """The full leaf on the rank at (data 0, model ``dst``) from every
    rank's slice ``x``, None on the others: its ``data`` parts gathered
    onto the first data row, then its model parts onto ``dst``.  A rank
    off the first data row takes part only where ``spec`` names
    ``data``."""
    if isinstance(spec, Owner):
        x = gather_leaf(x, Owner(spec.axis, spec.index, (), spec.shape),
                        mesh)
        spec = spec.spec
    if set(spec_axes(spec)) - {"model", "data"}:
        raise NotImplementedError(f"a gather to one rank over {spec}")
    first = "data" not in mesh.axis_names or mesh.coord("data") == 0
    for dim, ax in enumerate(spec):
        if _names(ax, "data"):
            x = _gather_one(x, dim, mesh.group("data"), 0)
            if x is None:
                return None
    if not first:
        return None
    for dim, ax in enumerate(spec):
        if _names(ax, "model"):
            x = _gather_one(x, dim, mesh.group("model"), dst)
            if x is None:
                return None
    return x


def gather_tree(tree, specs: dict, mesh, dst: Optional[int] = None):
    """A tree of full logical leaves from this rank's slices (every rank
    of each gathered axis takes part).  With ``dst``, only the rank at
    (data 0, model ``dst``) receives them, and the others get None: a
    quarter of the bytes of an all-gather on 4 ranks."""
    if dst is None:
        return tree_unflatten(tree, [gather_leaf(x, specs[p], mesh)
                                     for p, x in tree_paths(tree)])
    out = [_gather_to(x, specs[p], mesh, dst) if spec_axes(specs[p]) else x
           for p, x in tree_paths(tree)]
    here = mesh.coord("model") == dst and (
        "data" not in mesh.axis_names or mesh.coord("data") == 0)
    return tree_unflatten(tree, out) if here else None


def tree_specs(tree, param_specs: dict) -> dict:
    """Path -> spec of every leaf of ``tree`` (the params, or a tree that
    holds trees of their structure, as the optimizer state does): a leaf
    takes the spec of the param whose path ends its own, the longest
    such; any other leaf (a step count) is replicated."""
    out = {}
    for path, _ in tree_paths(tree):
        parts = path.split("/")
        out[path] = next((param_specs[q] for q in
                          ("/".join(parts[j:]) for j in range(len(parts)))
                          if q in param_specs), ())
    return out
