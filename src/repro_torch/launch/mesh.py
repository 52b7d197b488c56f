"""Meshes: the reference's production and debug meshes, and a
``torch.distributed`` mesh of real ranks.

``make_production_mesh`` and ``make_debug_mesh`` are FUNCTIONS that return
an abstract :class:`Mesh` with the reference's shapes and names: the single
pod is (data=16, model=16) = 256 chips, multi-pod adds a leading pod axis,
(pod=2, data=16, model=16) = 512 chips; the debug meshes are (2, 4) and
(2, 2, 2). Spec code (``distributed/sharding.py``) reads only a mesh's
``shape`` and ``axis_names``, so these need no devices and no process
group.

``make_device_mesh`` joins this process to a world of ``prod(shape)``
ranks and wraps ``torch.distributed.device_mesh.init_device_mesh``. Ranks
are laid out row-major over the axes, as on a jax mesh. The backend is
NCCL where each rank has a card of its own, and gloo on the CPU or for
several ranks on one card (NCCL refuses two ranks on one device). The mesh
then knows this rank's coordinates and holds one process group for every
set of two or more axes beside the device mesh's one per axis, created on
every rank in the same order when the mesh is made, so a collective over
any set of axes (``distributed/sharding.py``) finds its group.
"""
from __future__ import annotations

import itertools
from datetime import timedelta
from math import prod
from typing import Dict, Optional, Sequence, Tuple

import numpy as np


class Mesh:
    """A named mesh. ``shape`` maps each axis name to its size, in axis
    order. A mesh of real ranks (:func:`make_device_mesh`) also has
    ``rank``, ``device`` (where this rank's tensors live), ``backend`` and
    ``device_mesh``; an abstract one has ``rank = None``."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], *,
                 rank: Optional[int] = None, device=None, backend=None,
                 device_mesh=None):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} does not match axes "
                             f"{tuple(axis_names)}")
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              (int(s) for s in shape)))
        self.rank, self.device, self.backend = rank, device, backend
        self.device_mesh = device_mesh
        self._groups: Dict[Tuple[str, ...], object] = {}

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}"
                + (f", rank={self.rank}" if self.rank is not None else "")
                + ")")

    def coords(self) -> Dict[str, int]:
        """This rank's coordinate on every axis (row-major layout)."""
        if self.rank is None:
            raise ValueError("an abstract mesh has no ranks")
        out, r = {}, self.rank
        for a in reversed(self.axis_names):
            out[a] = r % self.shape[a]
            r //= self.shape[a]
        return out

    def index(self, axes: Sequence[str]) -> int:
        """This rank's linear index over ``axes``, the first axis major: the
        block of a dimension sharded over ``axes`` that this rank holds."""
        c, i = self.coords(), 0
        for a in axes:
            i = i * self.shape[a] + c[a]
        return i

    def group(self, axes: Sequence[str]):
        """The process group of the ranks that share this rank's
        coordinates on every axis but ``axes``, ranked by their index over
        ``axes``."""
        key = tuple(axes)
        if key not in self._groups:
            raise ValueError(f"{self}: no process group over {key}")
        return self._groups[key]


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def make_debug_mesh(*, multi_pod: bool = False) -> Mesh:
    """Small mesh for fast local iteration (8 ranks)."""
    shape = (2, 2, 2) if multi_pod else (2, 4)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def make_device_mesh(shape: Sequence[int], axes: Sequence[str],
                     device: str = "cuda", *, init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     timeout_s: float = 300.0) -> Mesh:
    """A :class:`Mesh` of ``prod(shape)`` real ranks. Joins the default
    process group first when this process has none: ``init_method`` (for
    example ``file:///tmp/store`` or ``tcp://localhost:29500``), ``rank``
    and ``world_size`` are then required; nothing on the machine names a
    cluster. Rank r computes on ``cuda:r % device_count`` under NCCL, on
    ``cuda:0`` when several ranks share one card over gloo, and on the CPU
    for ``device="cpu"``."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    n = prod(shape)
    if not dist.is_initialized():
        if init_method is None or rank is None or world_size is None:
            raise ValueError("make_device_mesh: no process group yet; give "
                             "init_method, rank and world_size")
        # NCCL when every rank has a card of its own, else gloo
        nccl = device == "cuda" and world_size <= torch.cuda.device_count()
        dist.init_process_group("nccl" if nccl else "gloo",
                                init_method=init_method, rank=rank,
                                world_size=world_size,
                                timeout=timedelta(seconds=timeout_s))
    world, me = dist.get_world_size(), dist.get_rank()
    if world != n:
        raise ValueError(f"make_device_mesh: mesh {tuple(shape)} needs {n} "
                         f"ranks, the world has {world}")
    backend = dist.get_backend()
    if device == "cuda":
        dev = torch.device("cuda", me % torch.cuda.device_count()
                           if backend == "nccl" else 0)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    dm = init_device_mesh("cuda" if backend == "nccl" else "cpu",
                          tuple(shape), mesh_dim_names=tuple(axes))
    mesh = Mesh(shape, axes, rank=me, device=dev, backend=backend,
                device_mesh=dm)
    for a in axes:
        mesh._groups[(a,)] = dm.get_group(a)
    # every set of two or more axes, in one order on every rank: a group is
    # a row of the rank grid with those axes moved last
    grid = np.arange(n).reshape(tuple(shape))
    for k in range(2, len(axes) + 1):
        for sub in itertools.combinations(range(len(axes)), k):
            rows = np.moveaxis(grid, sub, range(len(axes) - k, len(axes)))
            mine, _ = dist.new_subgroups_by_enumeration(
                rows.reshape(-1, prod(shape[i] for i in sub)).tolist())
            mesh._groups[tuple(axes[i] for i in sub)] = mine
    return mesh
