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
the reference stacks, for the FSDP rule.  Specs are tuples of mesh axis
names (or tuples of names) and ``None``, one entry per leading dim, as
``tuple(PartitionSpec)`` (missing trailing entries are ``None``); a
tree's specs are a dict keyed by leaf path.  :func:`rule_spec` is the
rule of one leaf before the divisibility guard: ``core.moe``'s
``shard_moe_params`` reads an MoE layer's layout from it; :func:`rule_dim`
is the logical dim (heads, kv heads, ``d_ff``, vocab) the rule splits,
which ``models.transformer.tp_split`` decides for each model.

What the port stores sharded is ``models.transformer.storage_specs``:
the MoE leaves, and the attention families' dense leaves where their
heads, ``d_ff`` or vocab divide the model axis.  :func:`slice_leaf` /
:func:`shard_tree` keep a
rank's slices, :func:`gather_leaf` / :func:`gather_tree` rebuild the
full logical arrays (a checkpoint's), leaf by leaf.
"""
from __future__ import annotations

import math
import re
from typing import Optional

import torch

from repro_torch.distributed import context as dctx
from repro_torch.tree import tree_paths, tree_unflatten

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


def build_param_specs(params, mesh, *, moe_mode: str = "ep",
                      fsdp: bool = False, fsdp_min_size: int = 1 << 20,
                      stack: Optional[dict] = None) -> dict:
    """Path -> spec of every leaf of ``params`` (STORAGE sharding), the
    reference's rules on the port's unstacked tree.

    ``fsdp=True`` additionally shards the largest remaining unsharded dim
    of every big weight over the ``data`` axis (ZeRO-3 storage), extending
    an already model-sharded dim with ``data`` where it divides.  The
    reference decides "big" (``fsdp_min_size``) and "a weight" (two dims
    or more) on its stacked leaf; ``stack``
    (``models.transformer.reference_stack``) gives the copies it stacks a
    layer's leaves with, so the port decides as it does.  Where the reference would shard the stacked layer axis
    itself, which a per-layer tree has not, this raises.
    """
    out_specs = {}
    for path, leaf in tree_paths(params):
        shape = tuple(leaf.shape)
        ndim = len(shape)
        spec = rule_spec(path, ndim, moe_mode)
        parts = list(spec) + [None] * (ndim - len(spec))
        out = []
        for dim, ax in zip(shape, parts):
            out.append(None if ax is None or dim % _axis_size(mesh, ax)
                       else ax)
        out += [None] * (ndim - len(out))
        top = path.split("/")
        copies = (stack[top[0]][int(top[1])]
                  if stack and top[0] in stack and len(top) > 1 else None)
        size = math.prod(shape) * (copies or 1)
        if fsdp and "data" in mesh.axis_names and \
                ndim + (copies is not None) >= 2 and size >= fsdp_min_size:
            dsz = mesh.shape["data"]
            ext = [i for i in range(ndim)
                   if out[i] == "model"
                   and shape[i] % (dsz * mesh.shape["model"]) == 0]
            if ext:
                out[ext[0]] = ("model", "data")
            else:
                cands = sorted((i for i in range(ndim)
                                if out[i] is None and shape[i] % dsz == 0),
                               key=lambda i: -shape[i])
                if copies is not None and copies % dsz == 0 and \
                        (not cands or copies >= shape[cands[0]]):
                    raise NotImplementedError(
                        f"{path}: the reference shards its stacked layer "
                        f"axis over data here")
                if cands:
                    out[cands[0]] = "data"
        out_specs[path] = tuple(out)
    return out_specs


def _chunks(spec_entry, mesh) -> "tuple[int, int]":
    """(index, count) of this rank's chunk of a dim sharded over
    ``spec_entry`` (one axis, or a tuple with the first axis major)."""
    axes = spec_entry if isinstance(spec_entry, tuple) else (spec_entry,)
    idx, n = 0, 1
    for a in axes:
        idx = idx * mesh.shape[a] + mesh.coord(a)
        n *= mesh.shape[a]
    return idx, n


def slice_leaf(x: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's slice of the full leaf ``x``, a tensor of its own."""
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


def gather_leaf(x: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """The full leaf from every rank's slice ``x`` (a collective over the
    axes ``spec`` names)."""
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        for a in reversed(ax if isinstance(ax, tuple) else (ax,)):
            x = dctx.all_gather(x, dim, mesh.group(a))
    return x


def shard_tree(tree, specs: dict, mesh):
    """A tree of this rank's slices of ``tree``'s full leaves."""
    return tree_unflatten(tree, [slice_leaf(x, specs[p], mesh)
                                 for p, x in tree_paths(tree)])


def _gather_to(x: torch.Tensor, spec: tuple, mesh, dst: int):
    """The full leaf on the model-axis rank ``dst`` from every model
    rank's slice ``x`` (one ``gather``: each rank sends its slice once),
    None on the others."""
    import torch.distributed as dist
    if set(spec) - {None, "model"}:
        raise NotImplementedError(f"a gather to one rank over {spec}")
    group, n = mesh.group("model"), mesh.shape["model"]
    here = mesh.coord("model") == dst
    raw = x.contiguous().reshape(-1).view(torch.uint8)   # any dtype
    parts = [torch.empty_like(raw) for _ in range(n)] if here else None
    dist.gather(raw, parts, dst=dist.get_global_rank(group, dst),
                group=group)
    if not here:
        return None
    return torch.cat([q.view(x.dtype).reshape(x.shape) for q in parts],
                     spec.index("model"))


def gather_tree(tree, specs: dict, mesh, dst: Optional[int] = None):
    """A tree of full logical leaves from this rank's slices (every rank
    of each gathered axis takes part).  With ``dst``, only the rank at
    that coordinate of the model axis receives them, and the others get
    None: a quarter of the bytes of an all-gather on 4 ranks, for trees
    sharded over the model axis alone."""
    if dst is None:
        return tree_unflatten(tree, [gather_leaf(x, specs[p], mesh)
                                     for p, x in tree_paths(tree)])
    out = [_gather_to(x, specs[p], mesh, dst) if any(specs[p]) else x
           for p, x in tree_paths(tree)]
    return tree_unflatten(tree, out) if mesh.coord("model") == dst \
        else None


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
