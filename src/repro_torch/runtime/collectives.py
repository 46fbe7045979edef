"""The collectives of the port's meshes, on ``torch.distributed``.

A :class:`Group` is one process group of a mesh (``launch/mesh.py``): the
ranks along one axis, or along several, that hold this rank.  Its
collectives are deterministic and give every member the same bits:

* ``all_gather`` concatenates the members' tensors in rank order;
* ``psum`` gathers and adds them one by one in rank order (the order of
  the sum is fixed, so a replicated result is equal on every rank and a
  one-rank group returns its input's bits);
* ``reduce_scatter`` gives member r block r of the members' sum, added
  in rank order (the bits of ``chunk(psum(t))``);
* ``all_to_all`` sends block r of dim 0 to member r;
* ``ppermute`` sends to the next member (``(index + shift) % size``);
* ``broadcast_float`` and ``all_gather_object`` carry host values.

A group without a process group (``pg`` None: the one-rank mesh that
``launch/mesh.make_host_mesh`` builds when one process runs alone) has
one member, and its collectives return their input.  Every collective
that reaches ``torch.distributed`` is counted (``collective_counts``).

A :class:`RecordingGroup` is a group of an abstract mesh
(``launch/mesh.AbstractMesh``, the dry run's production mesh): no
process group and no wire.  It records each collective that would reach
the wire (``recording``) and returns tensors of the result's shape on
the input's device (``meta`` in the dry run).  The composed collectives
keep their composition, so the record holds what the port moves:
``psum`` is an all-gather (then the sum in rank order, done locally),
``reduce_scatter`` a reduce-scatter of the whole buffer (on the wire,
the all-to-all it is composed of).

Which backend a group runs on is the mesh's rule (NCCL when every rank
has a card of its own, gloo on the CPU or when ranks share a card), and
one more rule follows from it: under gloo a CUDA tensor is staged
through host memory, a copy each way, for every collective.

The autograd Functions are the transposes a sharded layer needs
(``models/moe_sharded.py``), written for a loss that every rank computes
alike from replicated values:

* ``all_gather`` of a sharded weight whose users each hold a part of
  its cotangent <-> reduce-scatter (``gather_shards``), and its mirror,
  the members' partial sums reduce-scattered to each member's block <->
  all_gather of the blocks' cotangents (``scatter_sum``: Megatron's
  sequence-parallel pair);
* ``all_to_all`` <-> the reverse all_to_all (``exchange``);
* a replicated tensor cut to this rank's slice <-> all_gather of the
  slices' cotangents (``split``), and the slices' results gathered back
  to a replicated tensor <-> this rank's slice of the cotangent
  (``unsplit``);
* a replicated tensor used on rank-local data <-> psum of the
  cotangent (``broadcast``), and a replicated value every rank computed
  alike <-> the cotangent over the group size (``identical``);
* the mean of the members' values <-> the cotangent over the group size
  (``pmean``), and their sum, one replicated value <-> the cotangent
  itself (``psum``);
* a send to the next member <-> a send of the cotangent back
  (``ppermute``).
"""
from __future__ import annotations

import contextlib
from collections import Counter
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist

# collectives that reached torch.distributed, by name, since the last
# reset_collective_counts()
_COUNTS: Counter = Counter()


def collective_counts() -> Dict[str, int]:
    return dict(_COUNTS)


def reset_collective_counts() -> None:
    _COUNTS.clear()


class Group:
    """The members of one process group, seen from this rank: ``size``
    ranks, this one at ``index`` (its place in the group's rank order)."""

    def __init__(self, pg, ranks: List[int], index: int, backend: str):
        self.pg = pg
        self.ranks = list(ranks)
        self.size = len(ranks)
        self.index = index
        self.backend = backend

    def __repr__(self) -> str:
        return (f"Group(ranks={self.ranks}, index={self.index}, "
                f"backend={self.backend})")

    @property
    def local(self) -> bool:
        """One member and no process group: every collective is the
        identity."""
        return self.pg is None

    def _staged(self, t: torch.Tensor) -> bool:
        """gloo takes host tensors: a CUDA tensor goes through the host."""
        return self.backend == "gloo" and t.is_cuda

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The members' ``t`` (equal shapes) concatenated on ``dim`` in
        rank order."""
        return torch.cat(self._gather(t), dim=dim)

    def _gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        if self.local:
            return [t.detach()]
        _COUNTS["all_gather"] += 1
        src = t.detach().contiguous()
        if self._staged(src):
            src = src.cpu()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.pg)
        return [p.to(t.device) for p in parts]

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """The members' ``t`` added in rank order, in ``t``'s dtype."""
        parts = self._gather(t)
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """Block r of ``t``'s dim 0 (of ``size`` equal blocks) goes to
        member r; block s of the result came from member s."""
        if t.shape[0] % self.size:
            raise ValueError(f"all_to_all: dim 0 of {tuple(t.shape)} does "
                             f"not split into {self.size} blocks")
        if self.local:
            return t.detach()
        _COUNTS["all_to_all"] += 1
        src = t.detach().contiguous()
        if self._staged(src):
            src = src.cpu()
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=self.pg)
        return out.to(t.device)

    def reduce_scatter(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Block ``index`` of ``dim`` of the members' ``t`` added in rank
        order: an all_to_all of the blocks, then the sum of the ``size``
        blocks received, in rank order (``chunk(psum(t), dim)``'s bits,
        without every member holding the whole sum)."""
        if t.shape[dim] % self.size:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                             f"into {self.size} blocks")
        if self.local:
            return t.detach()
        blocks = self.all_to_all(t.movedim(dim, 0)).chunk(self.size, 0)
        out = blocks[0]
        for b in blocks[1:]:
            out = out + b
        return out.movedim(0, dim).contiguous()

    def ppermute(self, t: torch.Tensor, shift: int = 1) -> torch.Tensor:
        """Member ``(index + shift) % size`` receives this member's ``t``
        (equal shapes); returns what member ``(index - shift) % size``
        sent.  One send and one receive a member, posted together."""
        if self.local or self.size == 1:
            return t.detach()
        _COUNTS["ppermute"] += 1
        src = t.detach().contiguous()
        if self._staged(src):
            src = src.cpu()
        out = torch.empty_like(src)
        to = self.ranks[(self.index + shift) % self.size]
        frm = self.ranks[(self.index - shift) % self.size]
        for req in dist.batch_isend_irecv(
                [dist.P2POp(dist.isend, src, to, group=self.pg),
                 dist.P2POp(dist.irecv, out, frm, group=self.pg)]):
            req.wait()
        return out.to(t.device)

    def chunk(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This member's block of ``t``'s ``dim`` (``size`` equal blocks),
        as a contiguous tensor."""
        if t.shape[dim] % self.size:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                             f"into {self.size} blocks")
        n = t.shape[dim] // self.size
        return t.narrow(dim, self.index * n, n).contiguous()

    def broadcast_float(self, x: float, device: torch.device) -> float:
        """Member 0's ``x`` on every member (a host float; NCCL groups
        carry it through ``device``)."""
        if self.local:
            return float(x)
        _COUNTS["broadcast"] += 1
        on = torch.device("cpu") if self.backend == "gloo" else device
        t = torch.tensor([x], dtype=torch.float64, device=on)
        dist.broadcast(t, self.ranks[0], group=self.pg)
        return float(t.item())

    def barrier(self) -> None:
        if not self.local:
            _COUNTS["barrier"] += 1
            dist.barrier(group=self.pg)

    def all_gather_object(self, obj: Any) -> List[Any]:
        """Every member's picklable ``obj``, in rank order."""
        if self.local:
            return [obj]
        _COUNTS["all_gather_object"] += 1
        out: List[Any] = [None] * self.size
        dist.all_gather_object(out, obj, group=self.pg)
        return out


# (op, operand bytes, group size) of each collective a RecordingGroup was
# asked for inside ``recording()``
_records: Optional[List[Tuple[str, int, int]]] = None


@contextlib.contextmanager
def recording() -> Iterator[List[Tuple[str, int, int]]]:
    """The collectives of every ``RecordingGroup`` inside the block, in
    call order: (op, operand bytes, group size) in
    ``roofline.analysis.CollectiveOp``'s convention (an all-gather's
    bytes are its result's)."""
    global _records
    prev, _records = _records, []
    try:
        yield _records
    finally:
        _records = prev


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class RecordingGroup(Group):
    """A group of an abstract mesh, seen from rank 0 (``index`` 0): its
    tensor collectives move nothing, record themselves (``recording``)
    and return new tensors of the result's shape and dtype on the input's
    device; the host-value ones (``broadcast_float``, ``barrier``,
    ``all_gather_object``) have no ranks to reach and are not
    supported.  A one-member group records nothing."""

    def __init__(self, ranks: List[int]):
        super().__init__(None, ranks, 0, "abstract")

    @property
    def local(self) -> bool:
        return self.size == 1

    def _record(self, op: str, nbytes: int) -> None:
        if _records is not None:
            _records.append((op, int(nbytes), self.size))

    def _gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        if self.local:
            return [t.detach()]
        src = t.detach().contiguous()
        self._record("all-gather", _nbytes(src) * self.size)
        return [torch.empty_like(src) for _ in range(self.size)]

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        if t.shape[0] % self.size:
            raise ValueError(f"all_to_all: dim 0 of {tuple(t.shape)} does "
                             f"not split into {self.size} blocks")
        if self.local:
            return t.detach()
        self._record("all-to-all", _nbytes(t))
        return torch.empty_like(t.detach().contiguous())

    def reduce_scatter(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        if t.shape[dim] % self.size:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                             f"into {self.size} blocks")
        if self.local:
            return t.detach()
        self._record("reduce-scatter", _nbytes(t))
        return self.chunk(t.detach(), dim)

    def ppermute(self, t: torch.Tensor, shift: int = 1) -> torch.Tensor:
        if self.local:
            return t.detach()
        self._record("collective-permute", _nbytes(t))
        return torch.empty_like(t.detach().contiguous())


# --------------------------------------------------------------------------
# differentiable collectives
# --------------------------------------------------------------------------

class _GatherShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim = group, dim
        return group.all_gather(t, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.reduce_scatter(g, ctx.dim), None, None


class _ScatterSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim = group, dim
        return group.reduce_scatter(t, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_gather(g, ctx.dim), None, None


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return group.all_to_all(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_to_all(g), None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim = group, dim
        return group.chunk(t, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_gather(g, ctx.dim), None, None


class _Unsplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim = group, dim
        return group.all_gather(t, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.chunk(g, ctx.dim), None, None


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.psum(g), None


class _Scaled(torch.autograd.Function):
    """Forward: the identity (``identical``) or the members' mean
    (``pmean``); backward: the cotangent over the group size."""

    @staticmethod
    def forward(ctx, t, group, mean):
        ctx.size = group.size
        return group.psum(t) / group.size if mean else t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.size, None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        return group.psum(t)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, shift):
        ctx.group, ctx.shift = group, shift
        return group.ppermute(t, shift)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.ppermute(g, -ctx.shift), None, None


def gather_shards(t: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    """all_gather of a sharded tensor on ``dim``; the backward
    reduce-scatters (each member's cotangent is a part of the whole)."""
    return _GatherShards.apply(t, group, dim)


def scatter_sum(t: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    """This member's block on ``dim`` of the members' ``t`` added in rank
    order (``reduce_scatter``: a row-parallel layer's partial sums
    completed into a sequence-striped output); the backward all-gathers
    the blocks' cotangents (every member's part of the sum takes the
    whole cotangent)."""
    return _ScatterSum.apply(t, group, dim)


def exchange(t: torch.Tensor, group: Group) -> torch.Tensor:
    """all_to_all on dim 0; the backward is the reverse all_to_all."""
    return _Exchange.apply(t, group)


def split(t: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    """This member's block of a replicated ``t`` on ``dim``; the backward
    all-gathers the blocks' cotangents."""
    return _Split.apply(t, group, dim)


def unsplit(t: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    """The members' blocks gathered back to a replicated tensor; the
    backward takes this member's block of the (replicated) cotangent."""
    return _Unsplit.apply(t, group, dim)


def broadcast(t: torch.Tensor, group: Group) -> torch.Tensor:
    """A replicated ``t`` used on this member's own data: the identity,
    whose backward adds the members' cotangents (``psum``)."""
    return _Broadcast.apply(t, group)


def identical(t: torch.Tensor, group: Group) -> torch.Tensor:
    """A value every member computed alike, used as one replicated value:
    the identity, whose backward divides the cotangent by the group
    size (each member's copy carries its share)."""
    return _Scaled.apply(t, group, False)


def pmean(t: torch.Tensor, group: Group) -> torch.Tensor:
    """The mean of the members' ``t`` (added in rank order); the backward
    gives each member the cotangent over the group size."""
    return _Scaled.apply(t, group, True)


def psum(t: torch.Tensor, group: Group) -> torch.Tensor:
    """The members' ``t`` added in rank order, used as one replicated
    value; the backward gives each member the cotangent (its part enters
    the sum once)."""
    return _Psum.apply(t, group)


def ppermute(t: torch.Tensor, group: Group, shift: int = 1
             ) -> torch.Tensor:
    """``t`` sent to member ``(index + shift) % size``; the backward sends
    the cotangent back the other way."""
    return _Permute.apply(t, group, shift)
