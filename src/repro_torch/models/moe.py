"""Mixture-of-Experts with sort-based capacity dispatch: the port of
``repro/models/moe.py`` (``MoESpec``, ``moe_init``, ``moe_apply``,
``moe_param_count``).

Routing runs in fp32 through ``dispatch.matmul`` (B1's fp32 route on the
card); a stable sort of the flat expert ids ranks each (token, k)
assignment within its expert, assignments past the capacity are dropped,
and the kept ones are written into a dense (E, C, d) buffer that the
three expert contractions take through ``dispatch.grouped_matmul`` (B1's
grouped route: one launch for all experts).  The combine adds each
token's gate-weighted expert outputs in ascending expert order in the
compute dtype, the order of the JAX package's scatter-add, without
atomics, so a rerun gives the same bits.

The batch shape is part of the function: the capacity is ``capacity(B x
S)`` and ranks go in flat (token, k) order, so padding tokens and idle
slots take capacity too.  Callers hand ``moe_apply`` exactly the (B, S)
the JAX package's callers do.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..core.memory import DtypePolicy
from ..kernels import dispatch
from .layers import dense_init, mlp_apply, mlp_init

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class MoESpec:
    d_model: int
    n_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN width
    n_shared_experts: int = 0
    shared_d_expert: int = 0      # width of the fused shared-expert MLP
    capacity_factor: float = 1.25
    activation: str = "swiglu"
    aux_loss_coef: float = 0.001
    norm_topk: bool = True
    # experts padded to a multiple of this (dummies never routed)
    pad_to: int = 1

    @property
    def e_pad(self) -> int:
        return -(-self.n_experts // self.pad_to) * self.pad_to

    def capacity(self, n_tokens: int) -> int:
        c = math.ceil(n_tokens * self.top_k * self.capacity_factor
                      / self.n_experts)
        return max(8, -(-c // 8) * 8)     # a multiple of 8


def moe_init(gen: torch.Generator, s: MoESpec, lead=(),
             dtype: torch.dtype = torch.float32) -> Params:
    """The router (d, E), the experts' stacked weights (E, d, f) and
    (E, f, d), and the fused shared MLP; ``lead`` = (n_periods,) stacks a
    period.  Each leaf is cast to ``dtype`` as soon as it is drawn, so a
    full-width stack never holds all its experts in fp32 at once."""
    lead = tuple(lead)
    e, d, f = s.e_pad, s.d_model, s.d_expert
    p = {"router": dense_init(gen, lead + (d, e), d).to(dtype)}
    for name, shape, fan_in in (("wg", (e, d, f), d), ("wu", (e, d, f), d),
                                ("wd", (e, f, d), f)):
        p[name] = dense_init(gen, lead + shape, fan_in).to(dtype)
    if s.n_shared_experts:
        width = s.shared_d_expert or s.n_shared_experts * s.d_expert
        p["shared"] = {k: v.to(dtype) for k, v in mlp_init(
            gen, d, width, s.activation, lead).items()}
    return p


def _act(x: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "swiglu":
        return F.silu(x)
    if activation == "geglu":
        return F.gelu(x, approximate="tanh")
    return F.relu(x)


def route(p: Params, s: MoESpec, tokens: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """fp32 routing of tokens (T, d): (gates (T, K), expert ids (T, K),
    probabilities (T, E)).  Ties go to the lower expert id, as
    ``jax.lax.top_k`` breaks them (a stable descending sort)."""
    logits = dispatch.matmul(tokens.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)
    gate, eidx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, eidx = gate[:, :s.top_k], eidx[:, :s.top_k]
    if s.norm_topk:
        gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return gate, eidx, probs


def moe_apply(p: Params, s: MoESpec, x: torch.Tensor, dt: DtypePolicy
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d), aux loss fp32 scalar)."""
    b, sq, d = x.shape
    n_tok = b * sq
    cap = s.capacity(n_tok)
    tokens = x.reshape(n_tok, d)
    gate, eidx, probs = route(p, s, tokens)

    # ---- load-balancing aux loss (Switch-style) ----
    me = probs.mean(dim=0)
    ce = F.one_hot(eidx[:, 0], s.n_experts).float().mean(dim=0)
    aux = s.aux_loss_coef * s.n_experts * torch.sum(me * ce)

    # ---- sort-based dispatch: rank of each assignment within its expert
    tk = n_tok * s.top_k
    flat_e = eidx.reshape(tk)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    st = order // s.top_k                     # the token of each assignment
    sg = gate.reshape(tk)[order]
    # a bincount without its device-to-host read of the largest id
    counts = torch.zeros(s.e_pad, dtype=torch.long, device=x.device) \
        .scatter_add_(0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(tk, device=x.device) - starts[se]
    keep = rank < cap                         # capacity drop

    # ---- masked write into the dense (E, C, d) buffer: one row past the
    # buffer takes every dropped assignment (never read)
    cdt = dt.compute
    rows = s.e_pad * cap
    slot = se * cap + torch.clamp(rank, max=cap - 1)
    buf = torch.zeros((rows + 1, d), dtype=cdt, device=x.device)
    buf = buf.index_put((torch.where(keep, slot, rows),),
                        tokens[st].to(cdt))
    disp = buf[:rows].view(s.e_pad, cap, d)

    # ---- expert FFN: (E, C, d) x (E, d, f), one launch each on the card
    g = dispatch.grouped_matmul(disp, p["wg"].to(cdt))
    if s.activation in ("swiglu", "geglu"):
        u = dispatch.grouped_matmul(disp, p["wu"].to(cdt))
        h = _act(g, s.activation) * u
    else:
        h = _act(g, s.activation)
    expert_out = dispatch.grouped_matmul(h, p["wd"].to(cdt))

    # ---- combine: gather back, weight by gate, sum each token's K
    # contributions in ascending expert order (the sorted order)
    back = expert_out.reshape(rows, d)[slot]
    back = torch.where(keep[:, None], back, 0.0)
    back = back * sg[:, None].to(cdt)
    pos = torch.empty_like(order)
    pos[order] = torch.arange(tk, device=x.device)
    mine = back[pos.view(n_tok, s.top_k).sort(dim=1).values]   # (T, K, d)
    out = torch.zeros((n_tok, d), dtype=cdt, device=x.device)
    for j in range(s.top_k):
        out = out + mine[:, j]

    if s.n_shared_experts:
        out = out + mlp_apply(p["shared"], tokens.to(cdt), s.activation, dt,
                              tagged=False)
    return out.reshape(b, sq, d), aux


def moe_param_count(s: MoESpec) -> Tuple[int, int]:
    """(total, active-per-token) parameter counts."""
    glu = 3 if s.activation in ("swiglu", "geglu") else 2
    per_expert = glu * s.d_model * s.d_expert
    shared_width = (s.shared_d_expert or s.n_shared_experts * s.d_expert) \
        if s.n_shared_experts else 0
    shared = glu * s.d_model * shared_width
    router = s.d_model * s.n_experts
    total = s.n_experts * per_expert + shared + router
    active = s.top_k * per_expert + shared + router
    return total, active
