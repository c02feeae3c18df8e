"""Meshes of ranks: the JAX package's ``launch/mesh.py`` on
``torch.distributed``.

A :class:`Mesh` names its axes (``("data", "model")``, or ``("pod",
"data", "model")``) and holds their sizes.  Ranks lie on it row-major,
as ``jax.make_mesh`` lays out devices: rank ``r`` of a (data, model)
mesh sits at ``(r // model, r % model)``.  Built while a default process
group exists, the mesh also holds this rank's coordinates and, for each
axis, the process group of the ranks that differ from this one only
along that axis (``group("model")`` is this rank's row of the model
axis), and, on a mesh with both ``pod`` and ``data``, the group of the
joint batch axis ``("pod", "data")`` (the reference's batch spec
``P(("pod", "data"))``: the ranks that differ from this one in pod or
data, pod-major).  Every rank builds every group, in the same order, as
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
#: the axes a batch's rows are split over, major first
BATCH_AXES = ("pod", "data")


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

    @property
    def batch_axes(self) -> tuple:
        """The axes of :data:`BATCH_AXES` this mesh has."""
        return tuple(a for a in BATCH_AXES if a in self.axis_names)

    @property
    def batch_ranks(self) -> int:
        """How many blocks a batch's rows split into."""
        return math.prod(self.shape[a] for a in self.batch_axes)

    def batch_coord(self) -> int:
        """This rank's block of a batch's rows (pod-major)."""
        idx = 0
        for a in self.batch_axes:
            idx = idx * self.shape[a] + self.coord(a)
        return idx

    def batch_group(self):
        """The process group of the joint batch axis (``data`` alone on a
        mesh without ``pod``)."""
        axes = self.batch_axes
        return self.group(axes if len(axes) > 1 else axes[0])

    def group(self, axis):
        """The process group of this rank's line along ``axis`` (or its
        plane along a tuple of axes: ``("pod", "data")``)."""
        if self.groups is None:
            raise RuntimeError("this mesh holds shapes only: it was built "
                               "with no process group initialised")
        return self.groups[axis]


def _lines(sizes: tuple, axes) -> list:
    """Every line (or plane, for a tuple of axis indices) of ranks along
    ``axes``, the others fixed, in row-major order of the other
    coordinates; each lists its ranks row-major over ``axes``."""
    axes = (axes,) if isinstance(axes, int) else tuple(axes)
    strides = [math.prod(sizes[i + 1:]) for i in range(len(sizes))]
    others = [i for i in range(len(sizes)) if i not in axes]

    def offsets(dims):
        out = [0]
        for i in dims:
            out = [o + j * strides[i] for o in out for j in range(sizes[i])]
        return out
    return [[base + o for o in offsets(axes)] for base in offsets(others)]


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
    keys = list(enumerate(axis_names))
    if all(a in axis_names for a in BATCH_AXES):
        keys.append((tuple(axis_names.index(a) for a in BATCH_AXES),
                     BATCH_AXES))
    for i, name in keys:
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
