"""The model axis of the sharded steps: how a layer's work splits over
the ranks of ``model`` (Megatron tensor parallelism, with its
sequence-parallel residual) -- the port of what JAX's GSPMD makes of the
params' ``tree_shardings``, the dense cache's (``kind="cache"``) and the
``make_constrain`` / ``attn_hook`` constraints
(``repro/launch/dryrun.py:70-121, 162-195``): the train step, the
prefill and the one-token dense decode.

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

RWKV's recurrence follows the same hook.  On ``heads`` the WKV runs on
the rank's heads; on ``seq`` r/k/v/lw go to the rank's block of S / m
rows with every head (``to_seq``), the WKV runs on the block from a zero
state, and the state the blocks before it carry in is added outside the
kernel (``carry_in``: each block's state and total decay gathered, summed
in rank order, differentiable, so its gradient crosses the ranks).

The serving steps run under ``torch.no_grad``.  The prefill is the train
step's forward; its logits come from the rank's vocabulary columns,
gathered whole.  A decode step's residual is replicated (S = 1 never
stripes) and its dense cache is laid out by ``MeshRules.cache_spec``,
which ``kv_layout`` reads:

* ``heads``: the rank's kv heads (Hkv divides the axis); q/k/v on the
  rank's heads, B2 over the local cache;
* ``seq`` (Hkv does not divide the axis, the cache length does): rank r
  holds cache slots [r cap / m, (r + 1) cap / m); q/k/v are gathered
  whole (one all-gather), the slot's owner writes the new k/v, B2 runs
  over the rank's block and returns its log-sum-exp, and the ranks'
  (out, lse) are gathered and merged in fp32 in rank order
  (``merge_stripes``, flash-decoding's merge);
* ``whole``: every rank holds the whole cache and attends alike.

The RWKV state and the RG-LRU state sit on the rank's heads or channels,
so their recurrences run on the rank's own; the token-shift and conv
buffers hold the rank's channels and are gathered where a mix reads them
whole.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

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


def merge_stripes(outs: torch.Tensor, lses: torch.Tensor) -> torch.Tensor:
    """Attention over m key blocks from each block's own: ``outs`` (m, B,
    H, hd) and ``lses`` (m, B, H) (``-inf`` for a block with no live key)
    -> (B, H, hd) fp32, sum_r exp(lse_r - LSE) out_r with LSE the blocks'
    log-sum-exp, every sum in fp32 in block order."""
    outs, lses = outs.float(), lses.float()
    top = lses.amax(0)
    top = torch.where(torch.isfinite(top), top, 0.0)
    total = torch.zeros_like(top)
    for r in range(lses.shape[0]):
        total = total + torch.exp(lses[r] - top)
    log_total = top + torch.log(total)
    merged = torch.zeros_like(outs[0])
    for r in range(lses.shape[0]):
        merged = merged + torch.exp(lses[r] - log_total)[..., None] * outs[r]
    return merged


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

    def rows_use(self, t: torch.Tensor) -> torch.Tensor:
        """A whole leaf every rank holds alike, used on the rank's block
        of the sequence only, so its cotangent there is the rank's part:
        in the replicated layout through ``broadcast`` (its backward adds
        the parts); in the striped one ``TrainSharding.gather`` adds
        them."""
        return t if self.partial else coll.broadcast(t, self.group)

    # ------------------------------------------------------------ serving
    def gather_whole(self, *parts: Tuple[torch.Tensor, int]
                     ) -> List[torch.Tensor]:
        """(block, dim) pairs, each this rank's block of a tensor split
        over the ranks on ``dim``: the whole tensors, by one all-gather of
        them all (not differentiable: the serving steps').  Mixed float
        types travel as fp32, which each converts back to exactly."""
        dtypes = {t.dtype for t, _ in parts}
        common = dtypes.pop() if len(dtypes) == 1 else torch.float32
        flat = torch.cat([t.reshape(-1).to(common) for t, _ in parts])
        got = self.group.all_gather(flat[None], 0)
        out, at = [], 0
        for t, dim in parts:
            n = t.numel()
            blocks = got[:, at:at + n].reshape((self.size,) + t.shape)
            out.append(torch.cat(blocks.unbind(0), dim=dim).to(t.dtype))
            at += n
        return out

    def kv_layout(self, spec) -> str:
        """``heads``, ``seq`` or ``whole``: where ``MeshRules.cache_spec``
        (``spec``, of a (B, cap, Hkv, hd) cache) puts the model axis."""
        if spec[2] == self.model_axis:
            return "heads"
        if spec[1] == self.model_axis:
            return "seq"
        return "whole"

    def stripe(self, pos: int, cap_loc: int, layout: str
               ) -> Tuple[int, int]:
        """(first slot, live slots) of this rank's block of a dense cache
        of ``cap_loc`` slots a rank in ``layout`` at decode position
        ``pos`` (the new entry counted): the valid slots are the first
        min(pos + 1, cap) of the whole buffer, a prefix."""
        if layout != "seq":
            return 0, min(pos + 1, cap_loc)
        first = self.index * cap_loc
        cap = cap_loc * self.size
        return first, min(max(min(pos + 1, cap) - first, 0), cap_loc)

    def merge_stripes(self, out: torch.Tensor, lse: torch.Tensor
                      ) -> torch.Tensor:
        """One decode attention over the ranks' key blocks: each rank's
        (B, H, hd) fp32 ``out`` and (B, H) ``lse`` (``-inf`` for a block
        with no live key), gathered in one all-gather and merged in fp32 in
        rank order: out = sum_r exp(lse_r - LSE) out_r."""
        hd = out.shape[-1]
        both = torch.cat([out.float(), lse.float()[..., None]], dim=-1)
        got = self.group.all_gather(both[None], 0)
        return merge_stripes(got[..., :hd], got[..., hd])

    def carry_in(self, state: torch.Tensor, decay: torch.Tensor
                 ) -> torch.Tensor:
        """The recurrent state entering this rank's block of a striped
        sequence: each rank's block ``state`` S_j (B, H, k, v), its own
        from a zero state, and its total log-decay L_j (B, H, k), gathered
        (``gather_shards``: the backward reduce-scatters the parts) and
        summed in rank order, S_in(r) = sum_{j<r} e^(L_{j+1} + ... +
        L_{r-1}) S_j, the decay acting on the k rows.  Every exponent is
        <= 0.  Every rank's result depends on every block but the last
        (the later ones with weight 0), so every rank runs the gather's
        backward."""
        both = coll.gather_shards(
            torch.cat([state, decay[..., None]], dim=-1)[None], self.group,
            0)
        carried = torch.zeros_like(state)
        for j in range(self.size - 1):
            keep = float(j < self.index)
            step = torch.exp(both[j, ..., -1])[..., None] * carried \
                + both[j, ..., :-1]
            carried = keep * step + (1.0 - keep) * carried
        return carried
