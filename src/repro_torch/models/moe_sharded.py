"""Expert-parallel MoE with an explicit all-to-all: the port of
``repro/models/moe_sharded.py``.

Every rank of a mesh (``launch/mesh.py``) is a processing element:

1. it routes its own share of the tokens: the batch split over the data
   axes and the sequence over the model axis (when it divides and is
   longer than one token; else every model rank routes the same tokens);
2. it builds a send buffer per expert with capacity masks;
3. an all_to_all over the expert-parallel axes moves the payloads to the
   ranks that own the experts;
4. each rank runs its E/n_ep experts on ``dispatch.grouped_matmul``
   (B1's grouped route on the card) over every source's slots, their
   weights stored sharded (experts over the EP axes, d_expert over
   ``data``, ZeRO-3) and all-gathered over ``data`` for the layer;
5. the reverse all_to_all returns the outputs, and each rank combines its
   own tokens with their gates.

Capacity is per (rank, expert): ``max(8, ceil8(t_dev * k * cf / E))``
for the t_dev tokens a rank routes.  Experts pad to a multiple of the
EP axes' size; the dummies' router logits are -1e30, so no slot of
theirs fills.

The JAX body runs under ``shard_map`` on global arrays.  Here every rank
calls ``moe_apply_sharded`` with the replicated input and its own expert
shards, and gets the replicated output back: the token split and the
output gather are differentiable collectives
(``runtime/collectives.py``) whose transposes give every rank the
gradient of a loss that all ranks compute alike: this rank's expert
shards' gradient (the ``data`` gather reduce-scattering it), the
replicated router's and input's in full.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..core.memory import DtypePolicy
from ..kernels import dispatch
from ..runtime import collectives as coll
from ..runtime import tp
from .layers import mlp_apply
from .moe import MoESpec, _act

Params = Dict[str, torch.Tensor]
DATA_AXIS = "data"


def moe_pspecs(tree, ep_axes: Tuple[str, ...] = ("model",),
               data_axis: str = DATA_AXIS):
    """The spec tree (``runtime/tp.py``'s form) of a params tree under
    ``moe_apply_sharded``: every MoE layer's ``wg`` / ``wu`` (E, d, f)
    and ``wd`` (E, f, d) shard E over ``ep_axes`` and f over
    ``data_axis``, dims counted from the trailing end (a stacked period
    axis in front does not move them); the router, the shared MLP and
    every other leaf replicate.  A bare MoE layer's params: pass
    ``{"moe": p}``."""
    ep = tuple(ep_axes)

    def spec(names, leaf):
        name = names[-1] if names else ""
        if "moe" not in names or "shared" in names \
                or name not in ("wg", "wu", "wd"):
            return ()
        out = [None] * leaf.dim()
        out[leaf.dim() - 3] = ep
        out[leaf.dim() - (2 if name == "wd" else 1)] = data_axis
        return tuple(out)
    return tp.map_named(spec, tree)


def _local_dispatch(tokens: torch.Tensor, logits: torch.Tensor, s: MoESpec,
                    cap: int):
    """Route t_dev local tokens (T, d) by fp32 ``logits`` (T, E_pad):
    the (E_pad, cap, d) send buffer and what the combine needs (each
    assignment's buffer row, whether it was kept, its gate, its token,
    in ascending expert order) and the top-1 expert of each token."""
    t_dev, d = tokens.shape
    e_pad = logits.shape[1]
    probs = torch.softmax(logits, dim=-1)
    # ties go to the lower expert id, as jax.lax.top_k breaks them
    gate, eidx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, eidx = gate[:, :s.top_k], eidx[:, :s.top_k]
    if s.norm_topk:
        gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    tk = t_dev * s.top_k
    flat_e = eidx.reshape(tk)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    st = order // s.top_k
    sg = gate.reshape(tk)[order]
    counts = torch.zeros(e_pad, dtype=torch.long, device=tokens.device) \
        .scatter_add_(0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(tk, device=tokens.device) - starts[se]
    keep = rank < cap
    rows = e_pad * cap
    slot = se * cap + torch.clamp(rank, max=cap - 1)
    buf = torch.zeros((rows + 1, d), dtype=tokens.dtype,
                      device=tokens.device)
    buf = buf.index_put((torch.where(keep, slot, rows),), tokens[st])
    return (buf[:rows].view(e_pad, cap, d), slot, keep, sg, order, eidx,
            probs)


def moe_apply_sharded(p: Params, s: MoESpec, x: torch.Tensor,
                      dt: DtypePolicy, *, mesh, dp_axes: Tuple[str, ...],
                      model_axis: str = "model",
                      ep_axes: Tuple[str, ...] = ("model",),
                      batch_local: bool = False, split=None,
                      shared_split=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d), replicated on every rank -> (out (B, S, d)
    replicated, aux loss fp32 scalar).  ``p`` holds this rank's shards:
    ``wg``/``wu`` (E_pad / n_ep, d, f / n_data), ``wd`` (E_pad / n_ep,
    f / n_data, d); the router (d, E or E_pad) and the
    shared MLP whole (``moe_pspecs``).  Every rank of ``mesh`` must call
    it, on the same x.

    ``batch_local`` (the sharded train step): x is already this rank's
    rows of a batch split over ``dp_axes``, and so is the output; the aux
    loss still comes from the means over every rank's tokens, and the
    router's gradient is added over the other axes only (the caller adds
    it over ``dp_axes``).

    ``split`` (the sharded train step's ``model_axis.ModelSplit``, with
    ``batch_local``): x is already this rank's tokens over the model axis
    too (its sequence block), the output stays so, the shared MLP is left
    to the caller, which runs it on the model axis's shards over the
    whole sequence, and in the striped layout (``split.partial``) the
    router's gradient is added over the model axis by the caller too.

    ``shared_split`` (a sharded decode step's ``ModelSplit``, x alike on
    every model rank): the shared MLP's leaves are the rank's shards on
    the model axis, and it runs on them, its row-parallel sum
    completed."""
    cdt = dt.compute
    n_model = mesh.shape[model_axis]
    ep = mesh.group(ep_axes)
    n_ep, e_pad = ep.size, s.e_pad
    if e_pad % n_ep:
        raise ValueError(f"{e_pad} experts (padded) do not split over "
                         f"{n_ep} expert-parallel ranks; set pad_to")
    e_loc = e_pad // n_ep
    b, sq, d = x.shape
    dp_size = math.prod(mesh.shape[a] for a in dp_axes)
    batch_split = bool(dp_axes) and (batch_local or b % dp_size == 0)
    seq_split = split is not None or (sq % n_model == 0 and sq > 1)
    t_dev = b * sq if split is not None else (b * sq) // (
        (dp_size if batch_split and not batch_local else 1)
        * (n_model if seq_split else 1))
    cap = math.ceil(t_dev * s.top_k * s.capacity_factor / s.n_experts)
    cap = max(8, -(-cap // 8) * 8)

    # the axes that split the tokens, and those whose ranks route the
    # same tokens (a replicated use: psum of the cotangents back, and a
    # share of the output's)
    model_split, split = split, []
    if batch_split:
        split.append((dp_axes, 0))
    if seq_split:
        split.append(((model_axis,), 1))
    dup = [a for a in mesh.axes
           if not any(a in axes for axes, _ in split)]
    # the axes whose split happens here (not already the caller's)
    here = split[1:] if batch_local and batch_split else split
    if model_split is not None:
        here = []
    xl = x
    for axes, dim in here:
        xl = coll.split(xl, mesh.group(axes), dim)
    if dup:
        xl = coll.broadcast(xl, mesh.group(dup))
    inner = [a for a in mesh.axes
             if not (batch_local and a in dp_axes)
             and not (model_split is not None and model_split.partial
                      and a == model_axis)]
    router = coll.broadcast(p["router"], mesh.group(inner)) if inner \
        else p["router"]

    # ZeRO-3: gather the f-striped expert weights over data for the
    # layer; their gradients reduce-scatter back
    wg, wu, wd = p["wg"], p["wu"], p["wd"]
    if DATA_AXIS in mesh.shape and mesh.shape[DATA_AXIS] > 1:
        data = mesh.group(DATA_AXIS)
        wg = coll.gather_shards(wg, data, 2)
        wu = coll.gather_shards(wu, data, 2)
        wd = coll.gather_shards(wd, data, 1)

    bl, sl, _ = xl.shape
    tokens = xl.reshape(bl * sl, d)
    logits = dispatch.matmul(tokens.float(), router.float())
    if logits.shape[1] < e_pad:
        logits = F.pad(logits, (0, e_pad - logits.shape[1]))
    if e_pad != s.n_experts:        # dummy experts: never routed
        logits = logits.clone()
        logits[:, s.n_experts:] = -1e30
    buf, slot, keep, sg, order, eidx, probs = _local_dispatch(
        tokens.to(cdt), logits, s, cap)

    # load-balancing aux loss over the true experts, from the means over
    # every rank's tokens
    me = probs[:, :s.n_experts].mean(dim=0)
    ce = F.one_hot(eidx[:, 0], e_pad)[:, :s.n_experts].float().mean(dim=0)
    for axes, _ in split:
        me = coll.pmean(me, mesh.group(axes))
        ce = coll.pmean(ce, mesh.group(axes))
    if dup:
        me = coll.identical(me, mesh.group(dup))
    aux = s.aux_loss_coef * s.n_experts * torch.sum(me * ce)

    # dispatch all_to_all over the EP axes: (n_ep, e_loc, cap, d) out,
    # (source, e_loc, cap, d) in -> each local expert's rows of every
    # source
    recv = coll.exchange(buf.reshape(n_ep * e_loc, cap, d), ep)
    recv = recv.view(n_ep, e_loc, cap, d).transpose(0, 1) \
        .reshape(e_loc, n_ep * cap, d)
    g = dispatch.grouped_matmul(recv, wg.to(cdt))
    if s.activation in ("swiglu", "geglu"):
        h = _act(g, s.activation) * dispatch.grouped_matmul(recv,
                                                            wu.to(cdt))
    else:
        h = _act(g, s.activation)
    out = dispatch.grouped_matmul(h, wd.to(cdt))

    # return all_to_all and the local combine: each token's gate-weighted
    # outputs added in ascending expert order
    back = out.view(e_loc, n_ep, cap, d).transpose(0, 1) \
        .reshape(n_ep * e_loc, cap, d)
    back = coll.exchange(back, ep).reshape(e_pad * cap, d)[slot]
    back = torch.where(keep[:, None], back, 0.0) * sg[:, None].to(cdt)
    tk = order.numel()
    pos = torch.empty_like(order)
    pos[order] = torch.arange(tk, device=x.device)
    mine = back[pos.view(bl * sl, s.top_k).sort(dim=1).values]
    combined = torch.zeros((bl * sl, d), dtype=cdt, device=x.device)
    for j in range(s.top_k):
        combined = combined + mine[:, j]
    combined = combined.reshape(bl, sl, d)

    if dup:
        combined = coll.identical(combined, mesh.group(dup))
    for axes, dim in reversed(here):
        combined = coll.unsplit(combined, mesh.group(axes), dim)
    if s.n_shared_experts and model_split is None:
        combined = combined + mlp_apply(p["shared"], x.to(cdt),
                                        s.activation, dt, tagged=False,
                                        split=shared_split)
    return combined, aux
