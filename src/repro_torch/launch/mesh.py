"""Meshes of ranks: the JAX package's ``launch/mesh.py`` on
``torch.distributed``.

A :class:`Mesh` names its axes (``("data", "model")``, or ``("pod",
"data", "model")``) and holds their sizes.  Ranks lie on it row-major,
as ``jax.make_mesh`` lays out devices: rank ``r`` of a (data, model)
mesh sits at ``(r // model, r % model)``.  Built while a default process
group exists, the mesh also holds this rank's coordinates and, for each
axis, the process group of the ranks that differ from this one only
along that axis (``group("model")`` is this rank's row of the model
axis).  Every rank builds every group, in the same order, as
``dist.new_group`` requires.  A mesh built with no process group (the
production meshes, a dry run, the CPU tests) holds shapes, and
coordinates where a rank is given; asking it for a group raises.

Which device a rank computes on is its caller's choice:
``launch/train.py`` takes ``cuda:{LOCAL_RANK % device_count}``.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional

import torch.distributed as dist

#: model-axis sizes the elastic re-mesh tries, largest first
MODEL_PARALLEL_CANDIDATES = (16, 8, 4, 2, 1)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    axis_names: tuple
    sizes: tuple
    rank: Optional[int] = None          # this rank; None: shapes only
    groups: Optional[dict] = None       # axis -> this rank's process group

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"axes {self.axis_names} and sizes "
                             f"{self.sizes} differ in length")
        if self.rank is not None and not 0 <= self.rank < self.size:
            raise ValueError(f"rank {self.rank} is off a mesh of "
                             f"{self.size} ranks")

    @property
    def shape(self) -> dict:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    @property
    def coords(self) -> dict:
        """Axis name -> this rank's index along it (row-major)."""
        if self.rank is None:
            raise RuntimeError("a mesh of shapes only has no coordinates")
        out, r = {}, self.rank
        for name, n in reversed(list(zip(self.axis_names, self.sizes))):
            out[name] = r % n
            r //= n
        return {name: out[name] for name in self.axis_names}

    def coord(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: str):
        """The process group of this rank's line along ``axis``."""
        if self.groups is None:
            raise RuntimeError("this mesh holds shapes only: it was built "
                               "with no process group initialised")
        return self.groups[axis]


def _lines(sizes: tuple, axis: int) -> list:
    """Every line of ranks along ``axis`` (the others fixed), in
    row-major order of the other coordinates."""
    strides = [math.prod(sizes[i + 1:]) for i in range(len(sizes))]
    others = [i for i in range(len(sizes)) if i != axis]
    lines = []
    for flat in range(math.prod(sizes[i] for i in others)):
        base, rest = 0, flat
        for i in reversed(others):
            base += (rest % sizes[i]) * strides[i]
            rest //= sizes[i]
        lines.append([base + j * strides[axis] for j in range(sizes[axis])])
    return lines


def make_mesh(sizes, axis_names, *, with_groups: Optional[bool] = None
              ) -> Mesh:
    """A mesh of ``sizes`` over ``axis_names``.  ``with_groups`` (default:
    whether a process group is initialised) builds one process group per
    axis line; the mesh must then cover the whole world."""
    sizes, axis_names = tuple(int(s) for s in sizes), tuple(axis_names)
    if with_groups is None:
        with_groups = dist.is_available() and dist.is_initialized()
    if not with_groups:
        return Mesh(axis_names, sizes)
    world = dist.get_world_size()
    if math.prod(sizes) != world:
        raise ValueError(f"a {sizes} mesh needs {math.prod(sizes)} ranks; "
                         f"the process group has {world}")
    rank = dist.get_rank()
    groups = {}
    for i, name in enumerate(axis_names):
        for line in _lines(sizes, i):
            g = dist.new_group(line)        # every rank, every line
            if rank in line:
                groups[name] = g
    return Mesh(axis_names, sizes, rank=rank, groups=groups)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16 x 16 = 256 chips a pod; 2 pods = 512 multi-pod.  Shapes only."""
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"),
                         with_groups=False)
    return make_mesh((16, 16), ("data", "model"), with_groups=False)


def mesh_shape_for(n_devices: int, *, model_parallel: Optional[int] = None
                   ) -> tuple:
    """(data, model) for ``n_devices``: the largest model axis of
    :data:`MODEL_PARALLEL_CANDIDATES` that divides it, unless given."""
    if model_parallel is None:
        model_parallel = 1
        for cand in MODEL_PARALLEL_CANDIDATES:
            if n_devices % cand == 0 and cand <= n_devices:
                model_parallel = cand
                break
    return n_devices // model_parallel, model_parallel


def make_mesh_for(n_devices: int, *, model_parallel: Optional[int] = None,
                  with_groups: Optional[bool] = None) -> Mesh:
    """Elastic re-mesh: the best (data, model) mesh for however many
    ranks survive (used on restart after node loss)."""
    return make_mesh(mesh_shape_for(n_devices,
                                     model_parallel=model_parallel),
                     ("data", "model"), with_groups=with_groups)


def local_mesh() -> Mesh:
    """The mesh over every rank of the process group (one rank without
    one).  ``WORLD_SIZE > 1`` with no process group raises: the ranks
    would each run alone."""
    if dist.is_available() and dist.is_initialized():
        return make_mesh_for(dist.get_world_size())
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise RuntimeError("WORLD_SIZE > 1 but no process group is "
                           "initialised")
    return make_mesh_for(1)
