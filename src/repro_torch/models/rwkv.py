"""RWKV6's chunked WKV recurrence -- the port of ``wkv_chunked`` and its
two intra-chunk forms from ``repro/models/rwkv.py``.

Per (batch, head), with data-dependent log-decays lw <= 0 and bonus u,

    S_t = diag(exp(lw_t)) S_{t-1} + k_t v_t^T,
    o_t = r_t (S_{t-1} + diag(u) k_t v_t^T),

strip-mined into chunks of c tokens: within a chunk every interaction is
a product, and only the (hd, hd) state crosses from one chunk to the
next.  Every decay factor is the exponential of a non-positive log-sum,
so nothing overflows.  This is the plain version of the WKV kernel
(``kernels/wkv``), as ``repro/kernels/wkv/ref.py`` makes it the oracle of
the TPU kernel.

The RWKV block: the time mix (token-shift lerp, r/k/v/g projections, the
data-dependent decay from its LoRA in fp32, the per-head group norm and
the output gate) and the channel mix over its own token shift.  Its
projections are plain products, as in the JAX package (no Pallas kernel
runs there).  Over a whole sequence (``time_mix_apply``) the recurrence
is the model's WKV op, ``kernels.dispatch.wkv``: the WKV kernel and its
backward kernel on the card, ``wkv_chunked`` and its autograd on the
CPU.  The decode runs it one token at a time over a carried (B, H, hd,
hd) fp32 state.  On the model axis of the sharded steps (``split``) the
whole-sequence recurrence runs on the rank's heads or on its block of a
striped sequence (``time_mix_split``), and the decode on the rank's
heads of the state (``time_mix_decode``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import dispatch
from ..runtime import collectives as coll

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class RwkvSpec:
    """The RWKV block's widths and the chunking of its whole-sequence
    WKV, as the JAX spec's."""
    d_model: int
    head_dim: int = 64
    decay_lora: int = 64
    chunk: int = 64
    d_ff: int = 0                # channel-mix width
    # intra-chunk form of the CPU route ("direct" or "matmul", sub-chunks
    # of ``subchunk`` rows); the card's WKV kernel computes the sub-chunked
    # form at ``subchunk``
    intra: str = "direct"
    subchunk: int = 16

    @property
    def n_heads(self) -> int:
        return self.d_model // self.head_dim


# --------------------------------------------------------------------------
# time mix
# --------------------------------------------------------------------------

def time_mix_init(gen: torch.Generator, s: RwkvSpec, lead=()) -> Params:
    """The JAX ``time_mix_init`` distributions; ``lead`` = (n_periods,)
    stacks a period."""
    # imported here: layers imports the kernels, whose WKV module imports
    # this one
    from .layers import dense_init
    lead, d, dev = tuple(lead), s.d_model, gen.device

    def full(shape, value):
        return torch.full(lead + shape, value, dtype=torch.float32,
                          device=dev)
    p = {"mu": full((5, d), 0.5)}        # shift-lerp for r, k, v, g, w
    for name in ("wr", "wk", "wv", "wg", "wo"):
        p[name] = dense_init(gen, lead + (d, d), d)
    p["w0"] = full((d,), -6.0)           # base log-log decay
    p["wa"] = dense_init(gen, lead + (d, s.decay_lora), d)
    p["wb"] = 0.01 * dense_init(gen, lead + (s.decay_lora, d), s.decay_lora)
    p["u"] = full((s.n_heads, s.head_dim), 0.0)        # bonus
    p["ln_scale"] = full((d,), 1.0)      # group norm on the output
    p["ln_bias"] = full((d,), 0.0)
    return p


def _token_shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """A delay buffer of depth one: x_{t-1}, seeded by ``prev`` (B, d)."""
    return torch.cat([prev[:, None, :].to(x.dtype), x[:, :-1, :]], dim=1)


def _rkvgw(p: Params, s: RwkvSpec, x: torch.Tensor, x_prev: torch.Tensor,
           cdt: torch.dtype, col=torch.matmul):
    """r, k, v, g in the compute dtype and the log-decay lw <= 0 in fp32
    (the decay LoRA runs in fp32), each (B, S, d).  ``col``: the product
    of the column-parallel weights (wr/wk/wv/wg, wb)."""
    xx = _token_shift(x, x_prev)
    mix = [x + (xx - x) * p["mu"][i].to(x.dtype) for i in range(5)]
    r, k, v, g = (col(m, p[name].to(cdt)) for m, name in zip(
        mix, ("wr", "wk", "wv", "wg")))
    f32 = torch.float32
    lw = -torch.exp(p["w0"].to(f32) + col(torch.tanh(
        mix[4].to(f32) @ p["wa"].to(f32)), p["wb"].to(f32)))
    return r, k, v, g, lw


def _heads(x: torch.Tensor, s: RwkvSpec) -> torch.Tensor:
    b, sq, _ = x.shape
    return x.reshape(b, sq, s.n_heads, s.head_dim)


def _group_norm(p: Params, o: torch.Tensor, s: RwkvSpec,
                eps: float = 1e-5) -> torch.Tensor:
    """Per-head layer norm (RWKV's GroupNorm(n_heads)) of o (B, S, H, hd),
    with the population variance, as ``jnp.var``; -> (B, S, H * hd)."""
    b, sq, h, hd = o.shape
    mean = o.mean(dim=-1, keepdim=True)
    var = o.var(dim=-1, keepdim=True, correction=0)
    o = ((o - mean) * torch.rsqrt(var + eps)).reshape(b, sq, h * hd)
    return o * p["ln_scale"] + p["ln_bias"]


def time_mix_apply(p: Params, s: RwkvSpec, x: torch.Tensor,
                   cdt: torch.dtype, split=None) -> torch.Tensor:
    """The time mix of whole sequences x (B, S, d), token-shifted against
    zeros: the WKV recurrence from a zero state through
    ``dispatch.wkv`` (its final state is dropped), then the group norm
    in fp32 and the output gate.  Returns (B, S, d).  With ``split``
    (``time_mix_split``) it runs on the model axis's shards."""
    if split is not None:
        return time_mix_split(p, s, x, cdt, split)
    r, k, v, g, lw = _rkvgw(p, s, x, x.new_zeros((x.shape[0], s.d_model)),
                            cdt)
    o = dispatch.wkv(*(_heads(t, s) for t in (r, k, v, lw)), p["u"],
                     chunk=s.chunk, intra=s.intra, subchunk=s.subchunk)
    o = _group_norm(p, o, s).to(cdt)
    o = o * F.silu(g)
    return o @ p["wo"].to(cdt)


def time_mix_split(p: Params, s: RwkvSpec, x: torch.Tensor,
                   cdt: torch.dtype, split) -> torch.Tensor:
    """The time mix on the model axis's shards (x whole, from
    ``split.branch``): ``wr/wk/wv/wg`` and ``wb`` give the rank's d / m
    channels (column-parallel), ``wo`` takes them (row-parallel, completed
    into the residual's layout), ``mu``, ``w0``, ``wa`` and the group
    norm's scale and bias are replicated (``w0`` and the norm's cut to the
    rank's channels).  The WKV takes the layout JAX's ``attn_hook`` gives
    r/k/v (``split.attn_layout``):

    * ``heads`` (H divides the axis): B8 and its backward on the rank's
      H / m heads;
    * ``seq`` (``attn_prefer_seq``, or the heads do not divide the axis
      and the sequence does): r/k/v/lw go to the rank's S / m rows with
      every head (``split.to_seq``), B8 runs on the block from a zero
      state, and the state the earlier blocks carry in
      (``split.carry_in``) adds r_t e^(c_{t-1}) S_in to each row, c the
      block's inclusive cumsum of lw; the group norm runs on the rank's
      rows, and the output returns to the rank's channels
      (``split.from_seq``);
    * ``whole`` (neither divides): r/k/v/lw gathered whole, the WKV and
      the group norm alike on every rank, each keeping its channels."""
    d_loc = p["wr"].shape[-1]
    local = dict(p, w0=split.local(p["w0"], 0, d_loc))
    r, k, v, g, lw = _rkvgw(local, s, x,
                            x.new_zeros((x.shape[0], s.d_model)), cdt,
                            split.col)
    b, sq, _ = r.shape
    layout = split.attn_layout((b, sq, s.n_heads, s.head_dim), "q")
    if layout == "heads":
        ls = dataclasses.replace(s, d_model=d_loc)
        o = dispatch.wkv(*(_heads(t, ls) for t in (r, k, v, lw)), p["u"],
                         chunk=s.chunk, intra=s.intra, subchunk=s.subchunk)
        norm = {k_: split.local(p[k_], 0, d_loc)
                for k_ in ("ln_scale", "ln_bias")}
        o = _group_norm(norm, o, ls).to(cdt)
    elif layout == "seq":
        o = _striped_wkv(p, s, r, k, v, lw, cdt, split)
    else:
        def whole_mix(r, k, v, lw, *u):
            o = dispatch.wkv(*(_heads(t, s) for t in (r, k, v, lw)),
                             u[0] if u else p["u"], chunk=s.chunk,
                             intra=s.intra, subchunk=s.subchunk)
            return _group_norm(p, o, s)
        whole = [split.whole(t, 2) for t in (r, k, v, lw)]
        if p["u"].shape[0] < s.n_heads:    # a shard: the rank's heads
            whole.append(split.whole(p["u"], 0))
        o = split.own(split.alike(whole_mix, *whole), 2).to(cdt)
    o = o * F.silu(g)
    # the row-parallel partials as fp32 sums, rounded once after the
    # model axis adds them
    return split.complete((o.float() @ p["wo"].to(cdt).float()), cdt)


def _striped_wkv(p: Params, s: RwkvSpec, r, k, v, lw, cdt: torch.dtype,
                 split) -> torch.Tensor:
    """``time_mix_split``'s ``seq`` layout: r/k/v/lw (B, S, d / m) on the
    rank's channels -> the group-normed WKV output (B, S, d / m) in
    ``cdt``, computed on the rank's block of S / m rows of every head."""
    f32 = torch.float32
    rb, kb, vb, lwb = (_heads(split.to_seq(t, 2), s) for t in (r, k, v, lw))
    u = p["u"]
    u = split.gather(u, 0) if u.shape[0] < s.n_heads else split.rows_use(u)
    o = dispatch.wkv(rb, kb, vb, lwb, u, chunk=s.chunk, intra=s.intra,
                     subchunk=s.subchunk)
    # the block's own state from zero and its total decay, then the
    # earlier blocks' state carried in (plain differentiable products)
    cum = torch.cumsum(lwb, dim=1)                      # inclusive
    total = cum[:, -1]                                  # (B, H, hd)
    kf, vf = kb.to(f32), vb.to(f32)
    own = torch.einsum("bthk,bthv->bhkv", kf * torch.exp(total[:, None]
                                                         - cum), vf)
    carried = split.carry_in(own, total)
    o = o + torch.einsum("bthk,bhkv->bthv",
                         rb.to(f32) * torch.exp(cum - lwb), carried)
    norm = {k_: split.rows_use(p[k_]) for k_ in ("ln_scale", "ln_bias")}
    o = _group_norm(norm, o, s).to(cdt)
    return split.from_seq(o, 2)


def _wkv_token(s: RwkvSpec, r, k, v, lw, u,
               state: torch.Tensor) -> torch.Tensor:
    """One token of the WKV recurrence over ``state`` (B, H, hd, hd) fp32,
    written in place: r/k/v/lw (B, 1, H * hd), u (H, hd) -> o (B, H,
    hd) fp32."""
    f32 = torch.float32
    rh, kh, vh = (_heads(t, s)[:, 0].to(f32) for t in (r, k, v))
    w = torch.exp(_heads(lw, s)[:, 0])                       # (B, H, hd)
    o = torch.einsum("bhk,bhkv->bhv", rh, state) \
        + torch.einsum("bhk,hk,bhk->bh", rh, u.to(f32),
                       kh)[..., None] * vh
    state.copy_(w[..., None] * state
                + torch.einsum("bhk,bhv->bhkv", kh, vh))
    return o


def time_mix_decode(p: Params, s: RwkvSpec, x: torch.Tensor,
                    cache: Dict[str, torch.Tensor],
                    cdt: torch.dtype, split=None,
                    x_prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One token of the time mix.  x: (B, 1, d); cache: ``state`` (B, H,
    hd, hd) fp32 and ``xprev`` (B, d), both written in place.  Returns
    (B, 1, d).  With ``split`` (``time_mix_decode_split``) it runs on the
    model axis's shards, ``x_prev`` the whole token shift."""
    if split is not None:
        return time_mix_decode_split(p, s, x, cache, cdt, split, x_prev)
    r, k, v, g, lw = _rkvgw(p, s, x, cache["xprev"], cdt)
    o = _wkv_token(s, r, k, v, lw, p["u"], cache["state"])
    cache["xprev"].copy_(x[:, 0])
    o = _group_norm(p, o[:, None], s).to(cdt)
    o = o * F.silu(g)
    return o @ p["wo"].to(cdt)


def time_mix_decode_split(p: Params, s: RwkvSpec, x: torch.Tensor,
                          cache: Dict[str, torch.Tensor], cdt: torch.dtype,
                          split, x_prev: torch.Tensor) -> torch.Tensor:
    """One token of the time mix on the model axis's shards (x (B, 1, d)
    alike on every rank, ``x_prev`` the whole (B, d) token shift; under
    ``torch.no_grad``): ``wr/wk/wv/wg`` give the rank's d / m channels,
    ``wo`` takes them (row-parallel, completed).  The cache is in
    ``MeshRules.cache_spec``'s layout: ``xprev`` the rank's channels,
    ``state`` its heads, where the axis divides them; the recurrence and
    the group norm run on the rank's heads.  Where the state is whole
    (the heads do not divide the axis), r/k/v/lw are gathered whole and
    the recurrence runs alike on every rank, each keeping its channels."""
    d_loc = p["wr"].shape[-1]
    local = dict(p, w0=split.local(p["w0"], 0, d_loc))
    r, k, v, g, lw = _rkvgw(local, s, x, x_prev, cdt)
    state = cache["state"]
    if state.shape[1] * s.head_dim == d_loc:        # the rank's heads
        ls = dataclasses.replace(s, d_model=d_loc)
        o = _wkv_token(ls, r, k, v, lw, p["u"], state)
        norm = {k_: split.local(p[k_], 0, d_loc)
                for k_ in ("ln_scale", "ln_bias")}
        o = _group_norm(norm, o[:, None], ls).to(cdt)
    else:
        r, k, v, lw = split.gather_whole(*((t, 2) for t in (r, k, v, lw)))
        o = _wkv_token(s, r, k, v, lw, p["u"], state)
        o = split.local(_group_norm(p, o[:, None], s), 2, d_loc).to(cdt)
    xprev = cache["xprev"]
    xprev.copy_(split.local(x[:, 0], 1, xprev.shape[1]))
    o = o * F.silu(g)
    return split.complete(o.float() @ p["wo"].to(cdt).float(), cdt)


# --------------------------------------------------------------------------
# channel mix
# --------------------------------------------------------------------------

def channel_mix_init(gen: torch.Generator, s: RwkvSpec, lead=()) -> Params:
    from .layers import dense_init
    lead, d, ff = tuple(lead), s.d_model, s.d_ff
    return {"mu": torch.full(lead + (2, d), 0.5, dtype=torch.float32,
                             device=gen.device),
            "wk": dense_init(gen, lead + (d, ff), d),
            "wv": dense_init(gen, lead + (ff, d), ff),
            "wr": dense_init(gen, lead + (d, d), d)}


def channel_mix_apply(p: Params, s: RwkvSpec, x: torch.Tensor,
                      cdt: torch.dtype,
                      x_prev: Optional[torch.Tensor] = None,
                      split=None) -> torch.Tensor:
    """The channel mix of x (B, S, d), token-shifted against ``x_prev``
    (B, d; zeros when None).  With ``split`` (x whole, from
    ``split.branch``) ``wk`` gives the rank's d_ff columns and ``wv`` takes
    them, its partial sums completed (``psum``) before the gate; ``wr``
    gives the rank's d / m channels of the gate, which take their
    channels of the completed product; the gated channels are gathered
    and settled into the residual's layout."""
    prev = x_prev if x_prev is not None else x.new_zeros(
        (x.shape[0], s.d_model))
    xx = _token_shift(x, prev)
    xk = x + (xx - x) * p["mu"][0].to(x.dtype)
    xr = x + (xx - x) * p["mu"][1].to(x.dtype)
    col = torch.matmul if split is None else split.col
    k = torch.square(F.relu(col(xk, p["wk"].to(cdt))))
    r = torch.sigmoid(col(xr, p["wr"].to(cdt)))
    if split is None:
        return r * (k @ p["wv"].to(cdt))
    kv = coll.psum(k.float() @ p["wv"].to(cdt).float(), split.group)
    kv = split.own(kv.to(cdt), 2)
    return split.settle(split.whole(r * kv, 2))


def rwkv_cache_init(b: int, s: RwkvSpec, dtype: torch.dtype, device,
                    lead=()) -> Dict[str, torch.Tensor]:
    """Zero decode state: the fp32 (B, H, hd, hd) WKV state and the time
    and channel mixes' (B, d) token-shift buffers in ``dtype``."""
    lead = tuple(lead)
    return {"state": torch.zeros(lead + (b, s.n_heads, s.head_dim,
                                         s.head_dim),
                                 dtype=torch.float32, device=device),
            "xprev": torch.zeros(lead + (b, s.d_model), dtype=dtype,
                                 device=device),
            "cm_xprev": torch.zeros(lead + (b, s.d_model), dtype=dtype,
                                    device=device)}


def chunk_len(s: int, chunk: int) -> int:
    """The chunk length of a sequence of ``s`` tokens: ``min(chunk, s)``,
    halved until it divides ``s`` (``repro/models/rwkv.py:181-183``)."""
    c = min(chunk, s)
    while c > 1 and s % c:
        c //= 2
    return c


def _decay_weights(ecum_rows: torch.Tensor,
                   cum_cols: torch.Tensor) -> torch.Tensor:
    """exp(ecum_i - cum_j) for j < i, clamped at -60, zero elsewhere:
    (b, n, h, hd) x (b, n, h, hd) -> (b, n, n, h, hd).  The exponents
    above the diagonal (positive, up to the chunk's whole decay) are
    masked to -inf before the exponential, as the JAX package masks
    them, so none overflows: an overflow there would be dropped by the
    forward but turn its gradient into 0 * inf = nan."""
    n = ecum_rows.shape[1]
    below = torch.tril(torch.ones(n, n, dtype=torch.bool,
                                  device=ecum_rows.device),
                       diagonal=-1)[None, :, :, None, None]
    expo = torch.where(below, ecum_rows[:, :, None] - cum_cols[:, None],
                       float("-inf"))
    return torch.exp(torch.clamp(expo, min=-60.0)) * below


def _intra_direct(rj, kj, vj, cum, ecum):
    """Direct per-channel form: materializes the (c, c, hd) decay tensor."""
    a = torch.einsum("bchk,bdhk,bcdhk->bcdh", rj, kj,
                     _decay_weights(ecum, cum))
    return torch.einsum("bcdh,bdhv->bchv", a, vj)


def _intra_matmul(rj, kj, vj, cum, ecum, c: int, sc: int):
    """Sub-chunked matmul form.  Off-diagonal (a > b) sub-blocks factor
    the decay as exp(ecum_i - m_a') * exp(m_a' - m_b) * exp(m_b - cum_j),
    with m_x the cumsum at sub-chunk x's end and a' = a - 1: every
    exponent is <= 0 and the contraction over channels is a product.
    Diagonal blocks use the direct form at (sc, sc, hd)."""
    b_, _, h, hd = rj.shape
    nsc = c // sc

    def split(x):
        return x.reshape(b_, nsc, sc, h, hd)

    cum_s, ecum_s = split(cum), split(ecum)
    r_s, k_s, v_s = split(rj), split(kj), split(vj)
    m = cum_s[:, :, -1]                                      # (b,nsc,h,hd)
    m_prev = torch.cat([torch.zeros_like(m[:, :1]), m[:, :-1]], dim=1)
    ra = r_s * torch.exp(ecum_s - m_prev[:, :, None])
    kb = k_s * torch.exp(m[:, :, None] - cum_s)
    outs = []
    for a in range(nsc):
        o_a = torch.zeros(b_, sc, h, hd, dtype=rj.dtype, device=rj.device)
        for b in range(a):
            gap = torch.exp(m_prev[:, a] - m[:, b])          # (b_,h,hd)
            att = torch.einsum("bchk,bdhk->bcdh", ra[:, a],
                               kb[:, b] * gap[:, None])
            o_a = o_a + torch.einsum("bcdh,bdhv->bchv", att, v_s[:, b])
        att_d = torch.einsum("bchk,bdhk,bcdhk->bcdh", r_s[:, a], k_s[:, a],
                             _decay_weights(ecum_s[:, a], cum_s[:, a]))
        o_a = o_a + torch.einsum("bcdh,bdhv->bchv", att_d, v_s[:, a])
        outs.append(o_a)
    return torch.cat(outs, dim=1)


def wkv_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                lw: torch.Tensor, u: torch.Tensor, *, chunk: int,
                state: Optional[torch.Tensor] = None, intra: str = "direct",
                subchunk: int = 16) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked WKV recurrence.

    r, k, v: (B, S, H, hd) compute dtype; lw: (B, S, H, hd) fp32 log-decay
    (<= 0); u: (H, hd) bonus; ``state``: an optional (B, H, hd, hd) fp32
    initial state.  Returns (o (B, S, H, hd) fp32, final state
    (B, H, hd, hd) fp32).  ``intra`` selects the intra-chunk form,
    "direct" or "matmul" (sub-chunks of ``subchunk`` rows); both compute
    the same function.  The chunk loop is a Python loop (JAX's scan).
    fp64 inputs are computed, and returned, in fp64 (for gradient
    checks); every other type in fp32."""
    if intra not in ("direct", "matmul"):
        raise ValueError(f"wkv_chunked: intra must be 'direct' or "
                         f"'matmul', got {intra!r}")
    b, sq, h, hd = r.shape
    c = chunk_len(sq, chunk)
    sc = min(subchunk, c)
    use_matmul = intra == "matmul" and c % sc == 0 and c > sc
    acc = torch.promote_types(r.dtype, torch.float32)
    if state is None:
        state = torch.zeros(b, h, hd, hd, dtype=acc, device=r.device)
    uf = u.to(acc)
    S = state
    outs = []
    for s0 in range(0, sq, c):
        rj, kj, vj = (x[:, s0:s0 + c].to(acc) for x in (r, k, v))
        lwj = lw[:, s0:s0 + c].to(acc)
        cum = torch.cumsum(lwj, dim=1)           # inclusive, (b,c,h,hd)
        ecum = cum - lwj                         # exclusive
        total = cum[:, -1]                       # (b,h,hd)
        o_inter = torch.einsum("bchk,bhkv->bchv", rj * torch.exp(ecum), S)
        if use_matmul:
            o_intra = _intra_matmul(rj, kj, vj, cum, ecum, c, sc)
        else:
            o_intra = _intra_direct(rj, kj, vj, cum, ecum)
        diag = torch.einsum("bchk,hk,bchk->bch", rj, uf, kj)
        k_dec = kj * torch.exp(total[:, None] - cum)
        S = torch.exp(total)[..., None] * S \
            + torch.einsum("bchk,bchv->bhkv", k_dec, vj)
        outs.append(o_inter + o_intra + diag[..., None] * vj)
    return torch.cat(outs, dim=1), S
