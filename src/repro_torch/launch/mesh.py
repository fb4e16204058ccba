"""Device meshes over ``torch.distributed`` (counterpart of
``repro.launch.mesh``).

A ``Mesh`` names the axes of the process group's ranks, row-major over a
``DeviceMesh`` (``init_device_mesh``): ``("data", "model")`` for one pod,
``("pod", "data", "model")`` for two.  The sharding rules
(``runtime.sharding``) read only its ``shape`` (axis name -> size) and
``axis_names``; the train step reduces and gathers through its collectives,
each over the ranks that differ only on the named axes and counted in
``Mesh.collectives``.

The backend follows the device: NCCL for ``cuda``, gloo for ``cpu``.  A
mesh is built only over a process group the caller (or ``launch.train``)
has initialised with that backend and with exactly as many ranks as the
mesh has places; anything else raises.  The constructors are functions,
as in the reference, so importing this module touches no device and no
process group.
"""
from __future__ import annotations

import collections
import itertools
import math
import os
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.device import BACKENDS, check_backend, resolve_device

#: the all-gather / reduce-scatter of one flat tensor: the ``*_single``
#: names where this PyTorch has them (the ``*_tensor`` ones are deprecated
#: there), the same signature either way
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


class Mesh:
    """The ranks of the initialised process group as a named grid."""

    def __init__(self, shape: tuple, axis_names: tuple,
                 device: Optional[str | torch.device] = None):
        self.device = resolve_device(device)
        check_backend(self.device)
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} does not match the axes {axis_names}")
        world = dist.get_world_size()
        if math.prod(shape) != world:
            raise ValueError(
                f"a {'x'.join(map(str, shape))} mesh over {axis_names} needs "
                f"{math.prod(shape)} ranks; the process group has {world}"
            )
        from torch.distributed.device_mesh import init_device_mesh

        self.device_mesh = init_device_mesh(self.device.type, tuple(shape),
                                            mesh_dim_names=tuple(axis_names))
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, shape))
        self.rank = dist.get_rank()
        self.coordinate = dict(zip(self.axis_names, self.device_mesh.get_coordinate()))
        #: collectives issued through this mesh, by kind
        self.collectives: collections.Counter = collections.Counter()
        # a group over several axes, for each such set: every rank takes part
        # in creating every group, in the same order, so they are made here
        self._groups = {(a,): self.device_mesh.get_group(a) for a in self.axis_names}
        ranks = self.device_mesh.mesh
        for n in range(2, len(self.axis_names) + 1):
            for axes in itertools.combinations(self.axis_names, n):
                dims = [self.axis_names.index(a) for a in axes]
                rest = [d for d in range(len(self.axis_names)) if d not in dims]
                rows = ranks.permute(*rest, *dims).reshape(-1, math.prod(shape[d] for d in dims))
                group, _ = dist.new_subgroups_by_enumeration(rows.tolist())
                self._groups[axes] = group

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.device})"

    # ------------------------------------------------------------------
    def axes(self, entry) -> tuple:
        """The mesh axes of one spec entry (``None``, a name or a tuple of
        names), in the mesh's order; names the mesh lacks have size 1 and
        are dropped.  Raises when the entry lists axes out of that order."""
        names = () if entry is None else (entry if isinstance(entry, tuple) else (entry,))
        axes = tuple(a for a in names if a in self.shape)
        if list(axes) != sorted(axes, key=self.axis_names.index):
            raise ValueError(f"axes {names} are not in the mesh's order {self.axis_names}")
        return axes

    def size(self, axes: tuple) -> int:
        return math.prod(self.shape[a] for a in axes)

    def index(self, axes: tuple) -> int:
        """This rank's block along ``axes``: its coordinates on them, row
        major (the rank's place in their group)."""
        idx = 0
        for a in axes:
            idx = idx * self.shape[a] + self.coordinate[a]
        return idx

    def group(self, axes: tuple):
        return self._groups[axes]

    def _check(self, t: torch.Tensor) -> None:
        if t.device.type != self.device.type:
            raise RuntimeError(f"a {t.device.type} tensor on a {self.device.type} mesh "
                               f"({BACKENDS[self.device.type]})")

    # ------------------------------------------------------------------
    def all_reduce(self, t: torch.Tensor, axes: tuple, op: str = "sum") -> torch.Tensor:
        """``t`` reduced IN PLACE over the ranks that differ on ``axes``."""
        self._check(t)
        dist.all_reduce(t, op=_OPS[op], group=self.group(axes))
        self.collectives["all_reduce"] += 1
        return t

    def all_gather(self, t: torch.Tensor, axes: tuple, dim: int) -> torch.Tensor:
        """The blocks of the ranks that differ on ``axes`` concatenated along
        ``dim`` in their row-major order (a new tensor)."""
        self._check(t)
        x = t.movedim(dim, 0).contiguous()
        out = torch.empty((self.size(axes) * x.shape[0], *x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        _all_gather(out, x, group=self.group(axes))
        self.collectives["all_gather"] += 1
        return out.movedim(0, dim)

    def reduce_scatter(self, t: torch.Tensor, axes: tuple, dim: int) -> torch.Tensor:
        """``t`` summed over the ranks that differ on ``axes``, this rank
        keeping its block along ``dim`` (a new tensor)."""
        self._check(t)
        n = self.size(axes)
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split {n} ways")
        x = t.movedim(dim, 0).contiguous()
        out = torch.empty((x.shape[0] // n, *x.shape[1:]), dtype=x.dtype, device=x.device)
        _reduce_scatter(out, x, op=dist.ReduceOp.SUM, group=self.group(axes))
        self.collectives["reduce_scatter"] += 1
        return out.movedim(0, dim)


def make_mesh(shape: tuple, axis_names: tuple, *,
              device: Optional[str | torch.device] = None) -> Mesh:
    """A mesh of ``shape`` over ``axis_names`` (``jax.make_mesh``'s
    arguments) on the initialised process group."""
    return Mesh(tuple(shape), tuple(axis_names), device)


def make_production_mesh(*, multi_pod: bool = False,
                         device: Optional[str | torch.device] = None) -> Mesh:
    """16x16 single pod (256 ranks) or 2x16x16 multi-pod (512 ranks)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def make_dev_mesh(*, data: int = 1, model: int = 1,
                  device: Optional[str | torch.device] = None) -> Mesh:
    """``data`` x ``model`` over the process group's ranks (tests, examples,
    the train CLI)."""
    return make_mesh((data, model), ("data", "model"), device=device)


def init_distributed(device: Optional[str | torch.device] = None) -> bool:
    """Initialise the default process group for ``device`` unless one is:
    from torchrun's environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``;
    each rank on ``cuda:LOCAL_RANK``), else one rank over an in-process
    store.  Returns whether it initialised one (the caller then destroys
    it)."""
    if dist.is_initialized():
        return False
    dev = resolve_device(device)
    backend = BACKENDS[dev.type]
    if "WORLD_SIZE" in os.environ:
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    return True
