"""Process groups, device meshes and placements (counterpart of
``pyxu_tpu/parallel/mesh.py``).

The JAX package shards ``jax.Array``s over a ``jax.sharding.Mesh`` and XLA
inserts the collectives.  Here the program runs SPMD: one process a device,
a ``torch.distributed`` process group between them (NCCL on CUDA, gloo on
the CPU), a ``DeviceMesh`` that names the group's axes as the JAX package
names them, and a ``DTensor`` as the counterpart of a ``NamedSharding``'d
array: a :class:`P` entry that names a mesh axis becomes ``Shard(dim)`` on
that axis, every other mesh axis ``Replicate()``.

SPMD code holds the same global array on every rank before it shards it,
so :func:`shard` and :func:`replicate` cut each rank's part out locally,
with no communication.  A dimension that the mesh axis does not divide is
cut as ``torch.chunk`` cuts it, the convention ``DTensor`` itself keeps: a
part of ``ceil(n / size)`` a rank, the last ones shorter or empty.

The sharded operators of this package take either a ``DTensor`` or a plain
tensor (the global array, the same on every rank) and return ``DTensor``s.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from pyxu_tpu_torch.runtime import resolve_device

__all__ = ["auto_mesh", "shard", "replicate", "P", "init_distributed"]


class P(tuple):
    """PartitionSpec: one entry per tensor axis, the name of the mesh axis
    that shards it (or a tuple of names) or None; missing trailing entries
    are None."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def init_distributed(coordinator_address: str = None,
                     num_processes: int = None, process_id: int = None,
                     device=None, **kwargs) -> int:
    """Start the process group: NCCL when the device is CUDA, gloo on the
    CPU.  Idempotent: a second call returns the size of the group already
    up.  Returns the world size.

    ``coordinator_address``: ``"host:port"`` (TCP), or any
    ``init_method`` URL (``"tcp://..."``, ``"file://..."``); None reads the
    ``MASTER_ADDR``/``MASTER_PORT``/``RANK``/``WORLD_SIZE`` environment.
    ``num_processes`` and ``process_id`` are the world size and this
    process's rank.  ``device`` follows ``runtime.resolve_device``:
    ``cuda`` unless the caller asks for the CPU; on CUDA the process takes
    ``cuda:<rank mod device count>`` unless ``device`` names an index.
    ``kwargs`` go to ``torch.distributed.init_process_group``.
    """
    if dist.is_initialized():
        return dist.get_world_size()
    dev = resolve_device(device)
    init = coordinator_address
    if init is not None and "://" not in init:
        init = f"tcp://{init}"
    if dev.type == "cuda":
        index = dev.index
        if index is None:
            index = (process_id or 0) % torch.cuda.device_count()
        torch.cuda.set_device(index)
    dist.init_process_group(
        backend="nccl" if dev.type == "cuda" else "gloo",
        init_method=init, world_size=-1 if num_processes is None
        else int(num_processes), rank=-1 if process_id is None
        else int(process_id), **kwargs)
    return dist.get_world_size()


def auto_mesh(*axis_sizes, axis_names=None, device=None) -> DeviceMesh:
    """A mesh over the process group's ranks.

    ``auto_mesh()`` -> 1-D mesh ("s",) over every rank;
    ``auto_mesh(2, 4, axis_names=("dp", "sp"))`` -> 2x4 mesh.  The first
    ``prod(axis_sizes)`` ranks make it.  ``device``: as
    :func:`init_distributed`.
    """
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_distributed first")
    world = dist.get_world_size()
    if not axis_sizes:
        axis_sizes = (world,)
    axis_sizes = tuple(int(s) for s in axis_sizes)
    if axis_names is None:
        axis_names = ("s",) if len(axis_sizes) == 1 else \
            tuple(f"ax{i}" for i in range(len(axis_sizes)))
    axis_names = tuple(axis_names)
    if len(axis_names) != len(axis_sizes):
        raise ValueError(f"{len(axis_sizes)} axes, {len(axis_names)} names")
    n = math.prod(axis_sizes)
    if n > world:
        raise ValueError(f"need {n} devices, have {world}")
    ranks = torch.arange(n).reshape(axis_sizes)
    return DeviceMesh(resolve_device(device).type, ranks,
                      mesh_dim_names=axis_names)


# ----------------------------------------------------------- placements --

def axis_index(mesh: DeviceMesh, name: str = None) -> int:
    """Index of the mesh axis ``name`` (default: the first)."""
    if name is None:
        return 0
    names = mesh.mesh_dim_names or ()
    if name not in names:
        raise ValueError(f"mesh has no axis {name!r} (axes {names})")
    return names.index(name)


def placements(mesh: DeviceMesh, spec, ndim: int) -> tuple:
    """The ``DTensor`` placements of the PartitionSpec ``spec`` over a
    tensor of rank ``ndim``: ``Shard(d)`` on each mesh axis that entry d
    names, ``Replicate()`` on the others."""
    spec = tuple(spec) + (None,) * (ndim - len(spec))
    if len(spec) != ndim:
        raise ValueError(f"spec {spec} has more entries than rank {ndim}")
    out = [Replicate()] * mesh.ndim
    for d, entry in enumerate(spec):
        names = entry if isinstance(entry, tuple) else (entry,)
        for name in names:
            if name is not None:
                out[axis_index(mesh, name)] = Shard(d)
    return tuple(out)


def chunk_bounds(size: int, parts: int, i: int) -> tuple:
    """Rows ``[lo, hi)`` of part ``i`` when ``size`` rows are cut into
    ``parts`` as ``torch.chunk`` cuts them."""
    step = -(-size // parts) if size else 0
    lo = min(i * step, size)
    return lo, min(lo + step, size)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def local_part(full: torch.Tensor, mesh: DeviceMesh, plc) -> torch.Tensor:
    """This rank's part of the global tensor ``full`` under ``plc``."""
    coord = mesh.get_coordinate()
    out = full
    for ax, p in enumerate(plc):
        if isinstance(p, Shard):
            lo, hi = chunk_bounds(out.shape[p.dim], mesh.size(ax), coord[ax])
            out = out.narrow(p.dim, lo, hi - lo)
    return out


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= max(int(n), 1)
    return tuple(reversed(stride))


def from_local(local: torch.Tensor, mesh: DeviceMesh, plc,
               shape) -> DTensor:
    """A ``DTensor`` of global ``shape`` whose part on this rank is
    ``local`` (no communication, no check)."""
    return DTensor.from_local(local, mesh, plc, run_check=False,
                              shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def place(full: torch.Tensor, mesh: DeviceMesh, plc) -> DTensor:
    """The global tensor ``full`` (the same on every rank) as a ``DTensor``
    placed by ``plc``: each rank keeps its part."""
    full = full.to(mesh_device(mesh))
    return from_local(local_part(full, mesh, plc).contiguous(), mesh, plc,
                      full.shape)


def to_full(arr) -> torch.Tensor:
    """The global tensor: a ``DTensor`` gathered (``full_tensor``), any
    other array as it is."""
    if isinstance(arr, DTensor):
        return arr.full_tensor()
    return torch.as_tensor(arr)


def to_local(arr, mesh: DeviceMesh, plc) -> torch.Tensor:
    """This rank's part under ``plc`` of ``arr``: a ``DTensor`` is
    redistributed first (a no-op where it is placed so), a plain tensor is
    the global array and is cut locally."""
    if isinstance(arr, DTensor):
        return arr.redistribute(mesh, plc).to_local()
    return local_part(torch.as_tensor(arr).to(mesh_device(mesh)), mesh, plc)


def shard(arr, mesh: DeviceMesh, spec) -> DTensor:
    """``arr`` (numpy or a tensor, the same on every rank) as a ``DTensor``
    sharded by the PartitionSpec ``spec``."""
    t = torch.as_tensor(arr)
    return place(t, mesh, placements(mesh, spec, t.ndim))


def replicate(arr, mesh: DeviceMesh) -> DTensor:
    """``arr`` as a ``DTensor`` replicated over ``mesh``."""
    return shard(arr, mesh, P())
