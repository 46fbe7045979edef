"""Meshes of ranks on ``torch.distributed``: the port of
``repro/launch/mesh.py``.

A JAX mesh lays devices out on named axes inside one process.  Here a
mesh lays out processes, one rank each: a :class:`Mesh` holds its axis
names and shape, this rank's coordinates, and one process group
(``runtime.collectives.Group``) for every set of axes, over the ranks
that share this rank's other coordinates.  Every rank creates every
group, in the same order, as ``torch.distributed.new_group`` requires.
Ranks are laid out row-major over the axes, as JAX lays out devices.

The backend is set by a rule: NCCL when each rank has a card of its own,
gloo on the CPU or when ranks share a card (NCCL refuses two ranks on one
device).  Under gloo, collectives on CUDA tensors stage through host
memory (``Group``).  The process group times out after
``TIMEOUT``, so ranks that diverge fail instead of hanging.

Start N ranks with ``torchrun --nproc-per-node N`` (the mesh then
initializes the default process group from the environment), or
initialize the default group yourself before building a mesh.  A mesh of
one rank with no process group builds a one-rank group of its own, so
``--mesh 1`` runs alone and still goes through the collectives, as JAX's
one-device ``shard_map`` does.  ``make_host_mesh`` alone, in a process
that runs alone, builds no process group at all: its groups are local
(``Group.local``) and shard nothing, which is what the train CLI runs
on one process.

``make_production_mesh`` gives the dry run's meshes (JAX's shapes:
data 16 x model 16, or pod 2 x data 16 x model 16) as an
:class:`AbstractMesh`: axes and sizes seen from rank 0, with no process
group; its groups record their collectives
(``runtime.collectives.RecordingGroup``) and its device is ``meta``.
"""
from __future__ import annotations

import datetime
import itertools
import math
import os
from typing import Dict, Iterator, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..core.device import DeviceLike, resolve_device
from ..runtime.collectives import Group, RecordingGroup

TIMEOUT = datetime.timedelta(minutes=3)


def backend_for(device: torch.device, world_size: int) -> str:
    """NCCL when each of ``world_size`` ranks has a card of its own, else
    gloo (the CPU, or ranks sharing a card)."""
    if device.type == "cuda" and world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(device: DeviceLike, rank: int) -> torch.device:
    """This rank's device: ``device`` as given when it names an index (or
    the CPU), else the card ``LOCAL_RANK`` (or the rank) picks among this
    host's cards."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def init_distributed(device: torch.device, world_size: int) -> None:
    """The default process group of this process, if none exists: from
    ``torchrun``'s environment, or a one-rank group of its own."""
    if dist.is_initialized():
        return
    backend = backend_for(device, world_size)
    if world_size == 1 and "MASTER_ADDR" not in os.environ:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=TIMEOUT)
    else:
        dist.init_process_group(backend, timeout=TIMEOUT)


class Mesh:
    """Named axes over ranks ``0..prod(shape)-1`` of the default process
    group.  ``shape`` maps axis -> size (as a JAX mesh's does),
    ``coords`` axis -> this rank's index, ``device`` is this rank's."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str],
                 device: torch.device, backend: str):
        """``backend`` "local": one rank and no process group."""
        self.axes: Tuple[str, ...] = tuple(axes)
        self.shape: Dict[str, int] = dict(zip(self.axes, shape))
        self.size = math.prod(shape)
        self.device = device
        self.backend = backend
        # ranks on one card (gloo over CUDA tensors): what each builds at
        # once must fit beside the others'
        self.shares_device = device.type == "cuda" and backend == "gloo"
        self._groups: Dict[Tuple[str, ...], Group] = {}
        if backend == "local":
            if self.size != 1:
                raise ValueError(f"a local mesh has one rank, not {shape}")
            self.rank = 0
            self.coords = {a: 0 for a in self.axes}
            for k in range(1, len(self.axes) + 1):
                for sub in itertools.combinations(self.axes, k):
                    self._groups[sub] = Group(None, [0], 0, backend)
            return
        self.rank = dist.get_rank()
        idx = self.rank
        coords = []
        for n in reversed(tuple(shape)):
            coords.append(idx % n)
            idx //= n
        self.coords: Dict[str, int] = dict(zip(self.axes, reversed(coords)))
        # every subset of the axes, each slice of it: all ranks walk the
        # same subsets and slices in the same order
        all_ranks = torch.arange(self.size).reshape(tuple(shape))
        for k in range(1, len(self.axes) + 1):
            for sub in itertools.combinations(range(len(self.axes)), k):
                rest = [i for i in range(len(self.axes)) if i not in sub]
                grid = all_ranks.permute(*rest, *sub).reshape(
                    -1, math.prod(shape[i] for i in sub))
                for ranks in grid.tolist():
                    pg = dist.new_group(ranks, backend=backend,
                                        timeout=TIMEOUT)
                    if self.rank in ranks:
                        self._groups[tuple(self.axes[i] for i in sub)] = \
                            Group(pg, ranks, ranks.index(self.rank), backend)

    def group(self, axes) -> Group:
        """The group over ``axes`` (one name or a tuple, in mesh order)
        that holds this rank."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        key = tuple(a for a in self.axes if a in axes)
        if len(key) != len(axes) or not key:
            raise ValueError(f"mesh axes {self.axes} do not hold {axes}")
        return self._groups[key]

    def __repr__(self) -> str:
        return (f"Mesh(shape={self.shape}, rank={self.rank}, "
                f"coords={self.coords}, device={self.device}, "
                f"backend={self.backend})")


class AbstractMesh(Mesh):
    """A mesh of ``shape`` over ``axes`` with no ranks behind it, seen
    from rank 0 (every coordinate 0): ``MeshRules`` read its sizes, and
    its groups (``RecordingGroup``s over rank 0's slices) record the
    collectives a step asks for.  Its device is ``meta``."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str]):
        shape = tuple(int(n) for n in shape)
        self.axes = tuple(axes)
        self.shape = dict(zip(self.axes, shape))
        self.size = math.prod(shape)
        self.device = torch.device("meta")
        self.backend = "abstract"
        self.shares_device = False
        self.rank = 0
        self.coords = {a: 0 for a in self.axes}
        self._groups = {}
        all_ranks = torch.arange(self.size).reshape(shape)
        for k in range(1, len(self.axes) + 1):
            for sub in itertools.combinations(range(len(self.axes)), k):
                rest = [i for i in range(len(self.axes)) if i not in sub]
                ranks = all_ranks.permute(*rest, *sub).reshape(
                    -1, math.prod(shape[i] for i in sub))[0].tolist()
                self._groups[tuple(self.axes[i] for i in sub)] = \
                    RecordingGroup(ranks)


def make_production_mesh(multi_pod: bool = False) -> AbstractMesh:
    """The dry run's production mesh, JAX's shapes: (data 16, model 16),
    or with ``multi_pod`` (pod 2, data 16, model 16)."""
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              device: DeviceLike = None) -> Mesh:
    """A mesh of ``shape`` over named ``axes`` on ranks
    ``0..prod(shape)-1``; initializes the default process group first
    where none exists (``init_distributed``).  Every rank of the default
    group must call it, and each must be one of the mesh's ranks."""
    shape = tuple(int(n) for n in shape)
    if len(shape) != len(tuple(axes)) or min(shape, default=0) < 1:
        raise ValueError(f"mesh shape {shape} over axes {tuple(axes)}")
    n = math.prod(shape)
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", 1)))
    if n > world:
        raise ValueError(
            f"mesh size {n} exceeds the {world} rank(s) running; start "
            f"{n} ranks with torchrun --nproc-per-node {n}")
    if n != world:
        raise ValueError(f"mesh size {n} != the {world} ranks running: "
                         "every rank must hold a place in the mesh")
    dev = rank_device(device, dist.get_rank() if dist.is_initialized()
                      else int(os.environ.get("RANK", 0)))
    init_distributed(dev, world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(shape, axes, dev, backend_for(dev, world))


def make_serving_mesh(tp: int, *, device: DeviceLike = None) -> Mesh:
    """The tensor-parallel serving mesh (``launch/serve.py --mesh``): one
    ``("model",)`` axis over ranks ``0..tp-1``."""
    if tp < 1:
        raise ValueError(f"mesh size must be >= 1, got {tp}")
    return make_mesh((tp,), ("model",), device=device)


def make_host_mesh(shape=None, axes=("data", "model"), *,
                   device: DeviceLike = None) -> Mesh:
    """A mesh over whatever ranks run (the train CLI, tests): by default
    the largest model axis of 4, 2 or 1 that divides the rank count.  A
    process that runs alone (no process group, no ``torchrun``) gets a
    local one-rank mesh with no process group."""
    n = (dist.get_world_size() if dist.is_initialized()
         else int(os.environ.get("WORLD_SIZE", 1)))
    if shape is None:
        model = next(c for c in (4, 2, 1) if n % c == 0)
        shape = (n // model, model)
    if n == 1 and not dist.is_initialized() \
            and "MASTER_ADDR" not in os.environ:
        shape = tuple(int(c) for c in shape)
        if math.prod(shape) != 1 or len(shape) != len(tuple(axes)):
            raise ValueError(f"mesh shape {shape} over axes {tuple(axes)} "
                             "on the one rank running")
        dev = rank_device(device, 0)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        return Mesh(shape, axes, dev, "local")
    return make_mesh(shape, axes, device=device)


def in_turn(mesh) -> Iterator[None]:
    """Yield once: on ranks that share a card, one rank at a time (each
    waits at the mesh's barrier for the ones before it)."""
    if mesh is None or not mesh.shares_device:
        yield
        return
    group = mesh.group(mesh.axes)
    for rank in range(mesh.size):
        if rank == group.index:
            yield
            torch.cuda.empty_cache()    # the whole model's blocks, freed
        group.barrier()
