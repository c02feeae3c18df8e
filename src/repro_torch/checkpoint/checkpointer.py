"""Fault-tolerant checkpointing: atomic, versioned, auto-resume; the JAX
package's ``checkpoint/checkpointer.py``, writing the same files.

Layout:  <dir>/step_<n>/{arrays.npz, meta.json}  written to
``.tmp_step_<n>`` and ``os.rename``d into place (atomic on POSIX), then
``latest`` rewritten through ``.latest_tmp``.  A crash mid-write leaves
at most an orphan tmp dir; ``latest_step`` only ever sees complete
checkpoints.  ``keep_last`` bounds disk usage.

Leaves are named ``a<i>`` in :func:`~repro_torch.tree.tree_leaves` order
(sorted dict keys, the order of ``jax.tree.leaves``).  numpy has no
bfloat16, so a bf16 leaf is stored as its raw 2-byte words, a ``|V2``
array, as the JAX package's bf16 arrays come out of ``np.savez``; other
dtypes keep their own.  ``meta.json`` carries the reference's keys and
each leaf's torch dtype (``dtypes``).  :func:`restore` fills a tree of
the wanted structure in place, each leaf keeping its dtype and device,
bit for bit.  Leaves go to and from the host one at a time.

Sharded (``mesh`` and ``specs``, the path -> spec of every leaf as
stored, ``distributed.sharding.tree_specs``): a checkpoint keeps the
full logical arrays, the reference's format, so it restores onto any
mesh, with or without FSDP.  :func:`save` gathers each sharded leaf
over its axes on the ranks of the first pod and data row (a leaf
sharded over ``data``, an FSDP shard, on every rank of that pod's data
axis as well), rank 0 writes, and every rank waits at a barrier until
the step is published; :func:`restore` reads the full arrays on every
rank and keeps each rank's slice for the mesh it restores onto, which
may be another than the one that saved (the elastic restart).
"""
from __future__ import annotations

import json
import os
import shutil
import zipfile
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed import sharding
from repro_torch.tree import tree_paths

_BYTES = np.dtype("V2")


def _to_numpy(x: torch.Tensor) -> np.ndarray:
    x = x.detach().contiguous().cpu()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(_BYTES)
    return x.numpy()


def _from_numpy(a: np.ndarray) -> torch.Tensor:
    if a.dtype == _BYTES:                 # raw bf16 words
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _structure(tree) -> str:
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        return "[" + ", ".join(_structure(v) for v in tree) + "]"
    return "*"


def _joins(mesh, spec) -> bool:
    """Whether this rank takes part in gathering a leaf stored by
    ``spec``: on the first pod, the first data row, and every data rank
    where ``spec`` names ``data``."""
    if "pod" in mesh.axis_names and mesh.coord("pod"):
        return False
    return "data" not in mesh.axis_names or mesh.coord("data") == 0 or \
        "data" in sharding.spec_axes(spec)


def save(ckpt_dir: str, step: int, tree: Any, *, keep_last: int = 3,
         extra_meta: Optional[dict] = None, mesh=None,
         specs: Optional[dict] = None) -> str:
    final = os.path.join(ckpt_dir, f"step_{step}")
    named = tree_paths(tree)
    if mesh is not None:
        # the full arrays, gathered on the first data row's ranks
        full = (sharding.gather_leaf(x, specs[p], mesh) for p, x in named
                if _joins(mesh, specs[p]))
        if mesh.rank != 0:
            for _ in full:
                pass
            dist.barrier()
            return final
    else:
        full = (x for _, x in named)
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f".tmp_step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    dtypes = []
    # np.savez's own entries (a<i>.npy, stored, zip64), one leaf at a time
    with zipfile.ZipFile(os.path.join(tmp, "arrays.npz"), "w",
                         compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for i, x in enumerate(full):
            dtypes.append(str(x.dtype).removeprefix("torch."))
            with zf.open(f"a{i}.npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, _to_numpy(x),
                                          allow_pickle=False)
    meta = {"step": step, "num_leaves": len(named),
            "treedef": _structure(tree), "dtypes": dtypes,
            **(extra_meta or {})}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)

    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                       # atomic publish
    with open(os.path.join(ckpt_dir, ".latest_tmp"), "w") as f:
        f.write(str(step))
    os.rename(os.path.join(ckpt_dir, ".latest_tmp"),
              os.path.join(ckpt_dir, "latest"))

    _gc(ckpt_dir, keep_last)
    if mesh is not None:
        dist.barrier()
    return final


def _gc(ckpt_dir: str, keep_last: int):
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep_last] if keep_last else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"),
                      ignore_errors=True)


def all_steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_"):
            try:
                out.append(int(name.split("_", 1)[1]))
            except ValueError:
                pass
    return out


def latest_step(ckpt_dir: str) -> Optional[int]:
    path = os.path.join(ckpt_dir, "latest")
    if os.path.exists(path):
        with open(path) as f:
            s = int(f.read().strip())
        if os.path.isdir(os.path.join(ckpt_dir, f"step_{s}")):
            return s
    steps = all_steps(ckpt_dir)     # fall back to scan (torn 'latest')
    return max(steps) if steps else None


@torch.no_grad()
def restore(ckpt_dir: str, step: int, like: Any, *, mesh=None,
            specs: Optional[dict] = None) -> Tuple[Any, dict]:
    """Restore into ``like``: each of its tensors is overwritten in place
    with the saved leaf (cast to its dtype where the file's differs, as
    the reference's ``astype``), or with this rank's slice of it on a
    ``mesh``, and ``like`` is returned with the meta."""
    path = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    named = tree_paths(like)
    if meta["num_leaves"] != len(named):
        raise ValueError(f"checkpoint/model mismatch: {meta['num_leaves']} "
                         f"leaves saved, {len(named)} wanted")
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for i, (p, ref) in enumerate(named):
            src = _from_numpy(data[f"a{i}"])
            if mesh is not None:
                src = sharding.slice_leaf(src, specs[p], mesh)
            if src.shape != ref.shape:
                raise ValueError(f"leaf a{i}: saved shape {tuple(src.shape)}"
                                 f", wanted {tuple(ref.shape)}")
            ref.copy_(src)
    return like, meta


def restore_latest(ckpt_dir: str, like: Any, *, mesh=None,
                   specs: Optional[dict] = None):
    s = latest_step(ckpt_dir)
    if s is None:
        return None, None, None
    tree, meta = restore(ckpt_dir, s, like, mesh=mesh, specs=specs)
    return tree, meta, s
