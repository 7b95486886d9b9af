"""Device mesh construction over ``torch.distributed`` (counterpart of
``rstnet_tpu/parallel/mesh.py``).

The JAX package runs one process a host over all its devices; the port runs
one process a device (a rank), and a mesh names the ranks' axes:

* ``data``   — data parallelism: the batch is split, gradients are summed
               by a bucketed all-reduce (``training/train_step.py``)
* ``pipe``   — pipeline parallelism: each stage holds ``n_layer / P``
               contiguous blocks; microbatches flow stage to stage by
               send/recv (``parallel/pipeline.py``)
* ``seq``    — context parallelism: each rank holds a slice of the time
               axis; attention passes K/V blocks around a ring
               (``ops/context_parallel.py``)
* ``fsdp``   — parameter and optimizer-state sharding: FSDP2's
               ``fully_shard`` over this axis, the batch split as on ``data``
* ``expert`` — MoE expert stacks sharded on their expert axis
* ``tensor`` — tensor parallelism of the backbone's matmuls

Ranks are laid out row-major over ``AXES`` (``tensor`` innermost), as
``init_device_mesh`` lays them out. A mesh of one rank needs no process
group: every axis is 1 and every collective is skipped. ``set_mesh`` makes a
mesh ambient (JAX's ``jax.set_mesh``): the backbone reads the ``seq``, ``pipe``,
``tensor`` and ``expert`` sizes from it, and the losses their batch groups.
"""

from __future__ import annotations

import contextlib
import datetime
import logging
import math
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

AXES = ("data", "pipe", "seq", "fsdp", "expert", "tensor")
# the axes that split the batch: each rank's loss covers its rows (data,
# fsdp) and its time slice (seq), so gradients are summed over them
BATCH_AXES = ("data", "fsdp", "seq")


class Mesh:
    """Named axes over the ranks of the default process group.

    ``shape`` maps every axis of ``axes`` to its size; ``device_mesh`` is the
    ``DeviceMesh`` over all of them (None on one rank), whose sub-meshes carry
    ``DTensor`` and ``fully_shard`` placements."""

    def __init__(self, sizes: Sequence[int], axes: Sequence[str], device_type: str,
                 device_mesh=None):
        self.axes = tuple(axes)
        self.shape = dict(zip(self.axes, (int(s) for s in sizes)))
        self.device_type = device_type
        self.device_mesh = device_mesh
        self.world = math.prod(self.shape.values())
        self.rank = world_rank()

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank {self.rank})"

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def coord(self, axis: str, rank: Optional[int] = None) -> int:
        """``rank``'s (this process's by default) index along ``axis``."""
        if axis not in self.shape:
            return 0
        stride = math.prod(self.shape[a] for a in self.axes[self.axes.index(axis) + 1:])
        return ((self.rank if rank is None else rank) // stride) % self.shape[axis]

    def group(self, axis: str):
        """The process group of this rank's line along ``axis``; None when
        the axis is 1 (no collective to run)."""
        if self.size(axis) <= 1:
            return None
        return self.device_mesh.get_group(axis)

    def sub(self, *axes: str):
        """The ``DeviceMesh`` over ``axes`` through this rank."""
        return self.device_mesh[axes if len(axes) > 1 else axes[0]]

    def peer(self, axis: str, index: int) -> int:
        """The global rank at ``index`` along ``axis`` on this rank's line."""
        stride = math.prod(self.shape[a] for a in self.axes[self.axes.index(axis) + 1:])
        return self.rank + (index - self.coord(axis)) * stride


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def world_rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def make_mesh(shape: Optional[dict[str, int]] = None, *, axes: Sequence[str] = AXES,
              device_type: Optional[str] = None) -> Mesh:
    """A mesh over all ranks of the default group: :func:`mesh_sizes`, and
    a ``DeviceMesh`` of those sizes on ``device_type`` (the group's: CUDA
    under NCCL, else the CPU) when there is more than one rank."""
    n = world_size()
    sizes = mesh_sizes(shape, n, axes)
    if device_type is None:
        device_type = _group_device_type()
    device_mesh = None
    if n > 1:
        from torch.distributed.device_mesh import init_device_mesh

        device_mesh = init_device_mesh(device_type, tuple(sizes), mesh_dim_names=tuple(axes))
    return Mesh(sizes, axes, device_type, device_mesh)


def mesh_sizes(shape: Optional[dict[str, int]], n: int, axes: Sequence[str] = AXES
               ) -> list[int]:
    """The axis sizes of ``shape`` over ``n`` ranks. ``shape`` maps axis
    name -> size; missing axes are 1, and one ``-1`` axis absorbs the
    remaining ranks. With no shape at all everything goes to ``fsdp``. The
    product must equal ``n`` (ValueError, as JAX's ``make_mesh``)."""
    if shape is None:
        shape = {"fsdp": -1}
    sizes = [shape.get(a, 1) for a in axes]
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        if n % known != 0:
            raise ValueError(
                f"mesh shape {shape} needs a multiple of {known} ranks but {n} are running; "
                f"adjust the shape or start more ranks (torchrun --nproc_per_node=<n>)")
        sizes[sizes.index(-1)] = n // known
    if math.prod(sizes) != n:
        raise ValueError(
            f"mesh {dict(zip(axes, sizes))} covers {math.prod(sizes)} devices but {n} are "
            f"visible (ranks of the default process group). Pass a shape whose product equals "
            f"the rank count, use -1 for one axis to absorb the remainder, or start "
            f"<n> ranks (torchrun --nproc_per_node=<n>).")
    return sizes


def _group_device_type() -> str:
    return "cuda" if world_size() > 1 and dist.get_backend() == "nccl" else "cpu"


def choose_backend(device_type: str, local_world_size: int) -> str:
    """NCCL when each local rank has a card of its own; gloo on the CPU, or
    when ranks share a card (NCCL refuses two ranks on one device). gloo
    takes CUDA tensors from the caller but stages them through host memory
    inside each collective: the caller moves nothing itself, and the
    copies are part of the collective's time."""
    if device_type == "cuda" and torch.cuda.device_count() >= local_world_size:
        return "nccl"
    return "gloo"


def local_device(device_type: str) -> torch.device:
    """This rank's device: ``cuda:(LOCAL_RANK mod cards)`` (ranks past the
    card count share cards), or the CPU."""
    if device_type != "cuda":
        return torch.device("cpu")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank() if world_size() > 1 else 0))
    return torch.device("cuda", local % max(1, torch.cuda.device_count()))


def initialize_distributed(init_method: Optional[str] = None, *, rank: Optional[int] = None,
                           world_size: Optional[int] = None, device_type: str = "cpu",
                           timeout_s: float = 600.0) -> None:
    """Join the default process group: torchrun's ``RANK``/``WORLD_SIZE``/
    ``MASTER_ADDR`` (``env://``), or an explicit ``init_method`` (``file://``
    or ``tcp://``) with ``rank`` and ``world_size``. The backend is
    :func:`choose_backend`'s, and logged. A no-op in a single process and
    when the group exists already."""
    if dist.is_initialized():
        return
    world = world_size if world_size is not None else int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return
    rank = rank if rank is not None else int(os.environ["RANK"])
    if init_method is None:
        init_method = "env://"
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    backend = choose_backend(device_type, local_world)
    if device_type == "cuda":
        torch.cuda.set_device(local_device_index(rank))
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    logging.info(f"rank {rank}/{world}: backend {backend} ({device_type}, "
                 f"{torch.cuda.device_count() if device_type == 'cuda' else 0} cards for "
                 f"{local_world} local ranks)")


def local_device_index(rank: int) -> int:
    local = int(os.environ.get("LOCAL_RANK", rank))
    return local % max(1, torch.cuda.device_count())


def host_index() -> tuple[int, int]:
    """(this process's host, the host count): torchrun's ``GROUP_RANK`` and
    ``WORLD_SIZE / LOCAL_WORLD_SIZE``; (0, 1) on one host. The ranks of one
    host read one data stream, as the JAX package's process does."""
    world = world_size()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    return int(os.environ.get("GROUP_RANK", "0")), max(1, world // max(1, local))


_CURRENT: Optional[Mesh] = None


@contextlib.contextmanager
def set_mesh(mesh: Optional[Mesh]):
    """Make ``mesh`` ambient for the block (JAX's ``jax.set_mesh``)."""
    global _CURRENT
    prev, _CURRENT = _CURRENT, mesh
    try:
        yield mesh
    finally:
        _CURRENT = prev


def current_mesh() -> Optional[Mesh]:
    return _CURRENT


def batch_groups(mesh: Optional[Mesh] = None) -> list:
    """The process groups of the given (or ambient) mesh's batch axes that
    are > 1: the groups a loss's sums run over."""
    mesh = mesh if mesh is not None else _CURRENT
    if mesh is None:
        return []
    return [g for g in (mesh.group(a) for a in BATCH_AXES) if g is not None]


def axis_size(axis: str, mesh: Optional[Mesh] = None) -> int:
    """Size of the given (or ambient) mesh's ``axis``; 1 if absent."""
    mesh = mesh if mesh is not None else _CURRENT
    return 1 if mesh is None else mesh.size(axis)
