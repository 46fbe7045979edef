"""The model axis of the sharded train step: how a layer's work splits
over the ranks of ``model`` (Megatron tensor parallelism, with its
sequence-parallel residual) -- the port of what JAX's GSPMD makes of the
params' ``tree_shardings`` and the ``make_constrain`` / ``attn_hook``
constraints (``repro/launch/dryrun.py:70-121``).

Each rank holds the shards ``MeshRules.spec_for`` gives it: q/k/v
columns of its heads (or of its head_dim block where the heads do not
divide the axis), the FFN's hidden columns, the vocabulary rows of the
embedding and the head.  A layer computes on them and nothing is
gathered whole over ``model``.

The residual stream is either replicated over ``model`` (every rank
computes it alike) or, with ``constrain`` set, striped over the sequence
(each rank holds its block of S / m rows: Megatron-SP).  A branch
(mixer or FFN) takes the whole sequence (``branch``), runs what is not
split -- norms, token shifts, mixes -- alike on every rank, and comes
back through ``complete``: its row-parallel partial sums added over the
ranks (``psum``, or ``scatter_sum`` to the rank's block).  A row
product's partials are fp32 sums, rounded once after the addition.

The two layouts transpose differently:

* replicated (the train CLI's): every value a rank holds carries its
  whole cotangent.  A column-parallel product's input gradient is each
  rank's part, summed in fp32 in the product's backward before its one
  rounding (``col``; ``dispatch.matmul``'s ``grad_group``), so a bf16
  step rounds where one process rounds; the replicated leaves'
  gradients are whole on every rank.
* striped: Megatron-SP's pair, an all-gather into the branch whose
  backward reduce-scatters the ranks' parts (``gather_shards``): inside
  a branch a rank's cotangent of a value all ranks hold is its part, so
  a replicated leaf used there gets a part of its gradient, which
  ``TrainSharding.gather`` adds over ``model`` (``partial``).

``local`` cuts a leaf or an alike value to the rank's block in either
(``own``, whose backward gathers the blocks, or a ``narrow`` whose
zeros the sum completes); ``alike`` runs a piece on whole tensors alike
on every rank where the layout needs its parts (the striped one: the
inputs through ``broadcast``, the output through ``identical``).

Attention takes one of JAX's ``attn_hook`` layouts (``attn_layout``):
``heads`` (q/k/v on the rank's heads over the whole sequence), ``seq``
(q on the rank's block of S / m rows with every head, through an
all-to-all, and k/v whole: the flash kernels' query offset; k/v's
gradient is then a part of each rank's, added in its own dtype) or
``whole`` (every rank attends alike).  The expert-parallel MoE routes
the rank's own tokens: its router's gradient is a part a rank, added
over the axis by ``moe_apply_sharded`` (replicated layout) or
``TrainSharding.gather`` (striped).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from . import collectives as coll
from .collectives import Group


def to_seq(t: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    """(B, S, ...) split over the members on ``dim`` -> (B, S / m, ...)
    whole on ``dim``: this member's block of the sequence, by one
    all-to-all (``exchange``; its backward is the reverse one)."""
    m = group.size
    b, sq = t.shape[:2]
    blocks = t.reshape((b, m, sq // m) + t.shape[2:]).movedim(1, 0)
    got = coll.exchange(blocks.contiguous(), group).movedim(0, dim)
    shape = list(got.shape)
    shape[dim:dim + 2] = [shape[dim] * shape[dim + 1]]
    return got.reshape(shape)


def from_seq(t: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    """``to_seq``'s inverse: (B, S / m, ...) whole on ``dim`` -> (B, S,
    ...) with this member's block of ``dim``."""
    m = group.size
    shape = list(t.shape)
    shape[dim:dim + 1] = [m, shape[dim] // m]
    blocks = t.reshape(shape).movedim(dim, 0).contiguous()
    got = coll.exchange(blocks, group).movedim(0, 1)
    return got.reshape((got.shape[0], got.shape[1] * got.shape[2])
                       + got.shape[3:])


class _ColumnProduct(torch.autograd.Function):
    """x @ w (``torch.matmul``) for a column-parallel shard ``w`` of a
    product whose x every member holds alike: the backward's dx is the
    members' fp32 products added (in rank order) before its one
    rounding; dw is the member's own."""

    @staticmethod
    def forward(ctx, x, w, group):
        ctx.save_for_backward(x, w)
        ctx.group = group
        return x @ w

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = ctx.group.psum(g.float() @ w.float().T).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = (x.float().flatten(0, -2).T
                  @ g.float().flatten(0, -2)).to(w.dtype)
        return dx, dw, None


@dataclasses.dataclass(frozen=True)
class ModelSplit:
    """The model axis of one sharded forward: its ``group`` (size m > 1),
    whether the residual stream is striped over the sequence (``seq``),
    and ``attn``, JAX's ``attn_hook``: the spec (``sharding.P``) of a
    (B, S, H, hd) q (``role`` "q") or k/v at attention entry."""
    group: Group
    seq: bool
    attn: Callable[[Tuple[int, ...], str], tuple]
    model_axis: str = "model"
    # complete a branch to the rank's sequence block whatever the layout
    # (the MoE's shared MLP, added to the rank's routed tokens)
    to_tokens: bool = False

    @property
    def partial(self) -> bool:
        """Inside a branch, does a rank's cotangent of a value every rank
        holds carry only its part (the striped layout)?"""
        return self.seq

    @property
    def size(self) -> int:
        return self.group.size

    @property
    def index(self) -> int:
        return self.group.index

    # ------------------------------------------------------------ residual
    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """The stack's input, computed alike on every rank, in the
        residual's layout."""
        return self.own(x, 1) if self.seq else x

    def branch(self, x: torch.Tensor) -> torch.Tensor:
        """A branch's input: the whole sequence, alike on every rank."""
        return self.gather(x, 1) if self.seq else x

    def complete(self, part: torch.Tensor,
                 dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """A row-parallel partial sum over the whole sequence, added over
        the ranks into the residual's layout, then cast to ``dtype``
        (default its own): bf16 products' partials come as fp32 sums and
        are rounded once, after the addition, as one process rounds its
        whole sum."""
        if self.seq or self.to_tokens:
            out = coll.scatter_sum(part, self.group, 1)
        else:
            out = coll.psum(part, self.group)
        return out if dtype is None else out.to(dtype)

    def settle(self, y: torch.Tensor) -> torch.Tensor:
        """A branch output every rank holds whole and alike, in the
        residual's layout."""
        return self.own(y, 1) if self.seq else y

    def untokens(self, y: torch.Tensor) -> torch.Tensor:
        """The MoE's output on the rank's tokens, in the residual's
        layout."""
        return y if self.seq else self.whole(y, 1)

    # ------------------------------------------------------------- pieces
    @property
    def col_group(self) -> Optional[Group]:
        """``dispatch.matmul``'s ``grad_group`` for a column-parallel
        product: the group where its input gradient must be summed there
        (the replicated layout), else None."""
        return None if self.partial else self.group

    def col(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``x @ w`` (``torch.matmul``) for a column-parallel shard ``w``
        of a product whose x every rank holds alike."""
        if self.partial:
            return x @ w
        return _ColumnProduct.apply(x, w, self.group)

    def alike(self, fn: Callable, *inputs: torch.Tensor) -> torch.Tensor:
        """``fn`` of whole ``inputs`` (each the same on every rank, the
        rank's parts of their cotangents summed), run alike on every rank
        (in the striped layout through ``broadcast`` and ``identical``,
        so the replicated leaves it reads get a part each)."""
        if not self.partial:
            return fn(*inputs)
        out = fn(*(coll.broadcast(x, self.group) for x in inputs))
        return coll.identical(out, self.group)

    def whole(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """A tensor split over the ranks on ``dim``, gathered whole for a
        use every rank makes alike (its backward takes the rank's block
        of the whole cotangent)."""
        return coll.unsplit(t, self.group, dim)

    def own(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block on ``dim`` of a tensor (or a replicated leaf)
        every rank holds whole and alike (``split``: its backward gathers
        the blocks' cotangents)."""
        if t.shape[dim] % self.size:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                             f"over the {self.size} model ranks")
        return coll.split(t, self.group, dim)

    def local(self, t: torch.Tensor, dim: int, n: int) -> torch.Tensor:
        """The rank's block of ``n`` on ``dim`` of a leaf (itself where it
        is the rank's shard already) or of a value every rank holds
        alike: ``own``, or in the striped layout a ``narrow``, whose
        gradient is zero off the block (a part, as the layout's are)."""
        if t.shape[dim] == n:
            return t
        if self.partial:
            return t.narrow(dim, self.index * n, n)
        return self.own(t, dim)

    def gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """A tensor split over the ranks on ``dim``, whole, for a use whose
        cotangent is each rank's part (``gather_shards``)."""
        return coll.gather_shards(t, self.group, dim)

    # ---------------------------------------------------------- attention
    def attn_layout(self, shape: Tuple[int, ...], role: str) -> str:
        """``heads``, ``seq`` or ``whole``: where JAX's ``attn_hook`` puts
        a (B, S, H, hd) tensor of ``role``."""
        spec = tuple(self.attn(tuple(shape), role))
        if len(spec) > 2 and spec[2] == self.model_axis:
            return "heads"
        if len(spec) > 1 and spec[1] == self.model_axis:
            return "seq"
        return "whole"

    def to_seq(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        return to_seq(t, self.group, dim)

    def from_seq(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        return from_seq(t, self.group, dim)

    def seq_rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of the sequence (dim 1) of a tensor that
        carries no gradient (positions)."""
        n = t.shape[1] // self.size
        return t.narrow(1, self.index * n, n)
