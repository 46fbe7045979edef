"""Core layers: norms, rotary embeddings, dense and paged attention,
MLPs, losses -- the port of ``repro/models/layers.py``.

Every matmul and attention contraction routes through
``kernels.dispatch``, which picks the CUDA kernel for CUDA tensors and the
plain PyTorch version for CPU tensors.  Tensor layouts are the JAX
package's: activations (B, S, d), heads (B, S, H, hd), weights (K, ...).

In the sharded steps the whole-sequence layers and the dense decode take
a ``split`` (``runtime/model_axis.ModelSplit``): their weights are this
rank's shards on the model axis (column-parallel q/k/v and up
projections, row-parallel output and down projections, the vocabulary
rows of the embedding and the head), their input the residual stream in
its layout, and their output the branch completed back into it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from ..core import quant
from ..core.memory import DtypePolicy
from ..kernels import dispatch
from ..runtime import collectives as coll

Params = Dict[str, torch.Tensor]
# an int8 projection weight: {"q": int8 of the float weight's shape,
# "scale": fp32 of its output dims} (see ``quantize_weight``)
Weight = Union[torch.Tensor, Dict[str, torch.Tensor]]


# --------------------------------------------------------------------------
# initializers: the JAX package's distributions, drawn from a seeded
# torch.Generator (same distributions, different numbers)
# --------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape: Sequence[int],
               in_axis_size: Optional[int] = None) -> torch.Tensor:
    """Truncated normal in [-2, 2] scaled by 1/sqrt(fan_in), fp32.  A
    leading stacked-layer axis in ``shape`` needs ``in_axis_size``."""
    fan_in = in_axis_size if in_axis_size is not None else shape[0]
    t = torch.empty(tuple(shape), dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(1.0 / math.sqrt(max(fan_in, 1)))


def embed_init(gen: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                       device=gen.device)


# --------------------------------------------------------------------------
# normalization
# --------------------------------------------------------------------------

def rmsnorm_init(d: int, lead=(), device=None) -> Params:
    return {"scale": torch.zeros(tuple(lead) + (d,), dtype=torch.float32,
                                 device=device)}


def rmsnorm(p: Params, x: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """(1 + scale) RMSNorm: variance in fp32, the normalize/scale
    multiplies in the input dtype."""
    dt = x.dtype
    var = x.float().square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(dt)
    return x * inv * (1.0 + p["scale"]).to(dt)


# --------------------------------------------------------------------------
# rotary position embeddings (half-split layout)
# --------------------------------------------------------------------------

def _rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               theta: float = 1e4,
               mrope_sections: Tuple[int, ...] = ()) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) int, or (B, S, 3) for M-RoPE.
    Angles in fp32; the first and second halves of hd are the rotated
    pairs.

    M-RoPE (qwen2-vl): the hd/2 frequency slots are split into
    ``mrope_sections`` groups, each rotated by its own position stream
    (temporal / height / width)."""
    hd = x.shape[-1]
    freqs = _rope_freqs(hd, theta, x.device)
    if mrope_sections:
        if positions.dim() != 3 or positions.shape[-1] != len(
                mrope_sections) or sum(mrope_sections) != hd // 2:
            raise ValueError(f"M-RoPE sections {mrope_sections} need "
                             f"positions (B, S, {len(mrope_sections)}) and "
                             f"hd/2 = {hd // 2} slots; got positions "
                             f"{tuple(positions.shape)}")
        # pos[b, s, f] = positions[b, s, section of f], by slices on the
        # device: an index list copied from the host would wait for the
        # card at every call
        b, sq = positions.shape[:2]
        pos = torch.cat([positions[..., i, None].expand(b, sq, n)
                         for i, n in enumerate(mrope_sections)], dim=-1)
        angle = pos.float() * freqs                           # (B, S, hd/2)
    else:
        angle = positions.float()[..., None] * freqs          # (B, S, hd/2)
    sin = torch.sin(angle)[:, :, None, :]
    cos = torch.cos(angle)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnSpec:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    window: int = 0              # 0 = global causal; >0 = sliding window
    rope_theta: float = 1e4
    qkv_bias: bool = False
    # "" = float weight GEMMs (dispatch.matmul); "int8" = per-channel
    # quantized projections through dispatch.quantized_matmul (§4.4),
    # copied from ArchConfig.weights_dtype by the model
    weights_dtype: str = ""
    # M-RoPE frequency sections (qwen2-vl); () = plain RoPE
    mrope_sections: Tuple[int, ...] = ()


def quantize_weight(w: torch.Tensor, n_lead: int,
                    n_out: int) -> Dict[str, torch.Tensor]:
    """Quantize a projection weight per output channel, once: the weight
    ``project`` would quantize at every call in the JAX package.

    w (*lead, *K dims, *out dims) in the compute dtype: ``n_lead`` leading
    axes (a stacked period axis) quantize independently, the last
    ``n_out`` axes are the output channels, the rest the contraction.
    Returns ``{"q": int8 of w's shape, "scale": fp32 (*lead, *out
    dims)}``: ``quantize_channelwise`` of the (K, N) matrix ``project``
    contracts, so the ints and scales are the JAX package's bit for bit."""
    lead = w.shape[:n_lead]
    out_dims = w.shape[w.dim() - n_out:]
    q, scale = quant.quantize_channelwise(
        w.reshape(lead + (-1, math.prod(out_dims))))
    return {"q": q.reshape(w.shape), "scale": scale.reshape(lead + out_dims)}


def project(x: torch.Tensor, w: Weight, weights_dtype: str = "", *,
            tp: Optional[str] = None, saveable: bool = True,
            out_dtype: Optional[torch.dtype] = None,
            grad_group=None) -> torch.Tensor:
    """Contract x (..., K) with a weight (K, ...) at the configured weight
    dtype.  ``"int8"`` takes a ``quantize_weight`` dict and routes through
    ``dispatch.quantized_matmul`` (the fp32 result cast back to x's
    dtype, as the JAX package does); "" takes a float weight.  ``tp``
    names the op's tensor-parallel contract ("col"/"row"), inert outside
    a ``dispatch.tp_scope``; a "row" shard's int8 partials are summed in
    fp32, before the cast.  ``saveable``, ``out_dtype`` and ``grad_group``
    (float weights) as in ``dispatch.matmul``."""
    if weights_dtype == "int8":
        if not isinstance(w, dict):
            raise TypeError("weights_dtype='int8' needs weights quantized "
                            "by Model.bind_params (quantize_weight)")
        k = x.shape[-1]
        out = dispatch.quantized_matmul(x, w["q"].reshape(k, -1),
                                        w["scale"].reshape(-1), tp=tp)
        return out.reshape(x.shape[:-1] + w["scale"].shape).to(x.dtype)
    if weights_dtype:
        raise ValueError(f"weights_dtype {weights_dtype!r} is not supported "
                         "(float '' or 'int8')")
    return dispatch.matmul(x, w, tp=tp, saveable=saveable,
                           out_dtype=out_dtype, grad_group=grad_group)


def _cast(w: Weight, dtype: torch.dtype) -> Weight:
    """A float weight in the compute dtype; quantized weights as they
    are."""
    return w if isinstance(w, dict) else w.to(dtype)


def attention_init(gen: torch.Generator, s: AttnSpec, lead=()) -> Params:
    lead = tuple(lead)
    p = {
        "wq": dense_init(gen, lead + (s.d_model, s.n_heads, s.head_dim),
                         s.d_model),
        "wk": dense_init(gen, lead + (s.d_model, s.n_kv_heads, s.head_dim),
                         s.d_model),
        "wv": dense_init(gen, lead + (s.d_model, s.n_kv_heads, s.head_dim),
                         s.d_model),
        "wo": dense_init(gen, lead + (s.n_heads, s.head_dim, s.d_model),
                         s.n_heads * s.head_dim),
    }
    if s.qkv_bias:
        for name, heads in (("bq", s.n_heads), ("bk", s.n_kv_heads),
                            ("bv", s.n_kv_heads)):
            p[name] = torch.zeros(lead + (heads, s.head_dim),
                                  dtype=torch.float32, device=gen.device)
    return p


def _qkv(p: Params, s: AttnSpec, x: torch.Tensor, positions: torch.Tensor,
         dt: DtypePolicy):
    cdt = dt.compute
    # (b,s,d) x (d,h,k) -> (b,s,h,k): dispatch contracts last-vs-first.
    # q/k/v are column-parallel under tensor parallelism (a shard's heads;
    # MQA's replicated k/v take the same tag and need no collective)
    q = project(x, _cast(p["wq"], cdt), s.weights_dtype, tp="col")
    k = project(x, _cast(p["wk"], cdt), s.weights_dtype, tp="col")
    v = project(x, _cast(p["wv"], cdt), s.weights_dtype, tp="col")
    if s.qkv_bias:
        q = q + p["bq"].to(cdt)
        k = k + p["bk"].to(cdt)
        v = v + p["bv"].to(cdt)
    q = apply_rope(q, positions, theta=s.rope_theta,
                   mrope_sections=s.mrope_sections)
    k = apply_rope(k, positions, theta=s.rope_theta,
                   mrope_sections=s.mrope_sections)
    return q, k, v


def _out_proj(p: Params, s: AttnSpec, out: torch.Tensor,
              dt: DtypePolicy) -> torch.Tensor:
    """(B, S, H, hd) -> (B, S, d) via wo (H, hd, d)."""
    b, sq = out.shape[:2]
    wo = _cast(p["wo"], dt.compute)
    if not isinstance(wo, dict):
        wo = wo.reshape(s.n_heads * s.head_dim, s.d_model)
    return project(out.reshape(b, sq, s.n_heads * s.head_dim), wo,
                   s.weights_dtype)


def _expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """GQA: (B, S, Hkv, hd) -> (B, S, H, hd) by group broadcast; autograd
    sums the gradients of a kv head's query heads back through it."""
    b, sq, hkv, hd = k.shape
    g = n_heads // hkv
    if g == 1:
        return k
    return k[:, :, :, None, :].expand(b, sq, hkv, g, hd) \
        .reshape(b, sq, n_heads, hd)


def attention_blockwise(p: Params, s: AttnSpec, x: torch.Tensor,
                        positions: torch.Tensor, dt: DtypePolicy, *,
                        block_q: int = 512, block_kv: int = 512,
                        split=None) -> torch.Tensor:
    """Causal (sliding-window when ``s.window``) self-attention of a whole
    sequence through ``dispatch.attention``: the flash kernel and its
    fused backward on the card, the dense plain versions on the CPU.
    x: (B, S, d); positions (B, S).  The kernels keep their own tile
    geometry, so ``block_q`` / ``block_kv`` (the JAX reference lowering's
    tiles) do not change the result.  Returns (B, S, d).

    With ``split`` (the sharded train step's model axis) ``p`` holds this
    rank's shards, x is the whole sequence from ``split.branch``, and the
    result is completed into the residual's layout
    (``attention_split``)."""
    del block_q, block_kv
    if split is not None:
        return attention_split(p, s, x, positions, dt, split)
    q, k, v = _qkv(p, s, x, positions, dt)
    out = dispatch.attention(q, _expand_kv(k, s.n_heads),
                             _expand_kv(v, s.n_heads), causal=True,
                             window=s.window, out_dtype=dt.compute)
    return _out_proj(p, s, out, dt)


def _local_bias(split, b: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A (H, hd) bias cut to a projection's local (heads, hd) block: a
    shard already, or this rank's block of a replicated leaf."""
    for dim in (0, 1):
        b = split.local(b, dim, like.shape[2 + dim])
    return b


def attention_split(p: Params, s: AttnSpec, x: torch.Tensor,
                    positions: torch.Tensor, dt: DtypePolicy, split
                    ) -> torch.Tensor:
    """Attention on the model axis's shards (Megatron): x (B, S, d) whole
    (``split.branch``'s); q/k/v projected column-parallel -- the rank's
    heads, or its head_dim block where the heads do not divide the axis
    (MQA/GQA k/v, whose head_dim is gathered before RoPE, which rotates
    its halves) -- then laid out as JAX's ``attn_hook`` says
    (``split.attn_layout``):

    * ``heads``: the rank's q heads over the whole sequence, k/v its kv
      heads (or all of them, alike, expanded to every q head and cut to
      its own);
    * ``seq``: q on the rank's block of S / m rows with every head (an
      all-to-all), at key offset rank x S / m, k/v whole: B6/B7 at a
      query offset, whose dk/dv are this block's part;
    * ``whole``: every rank attends alike on whole q/k/v.

    The output returns to wo's layout (heads or head_dim) and the
    row-parallel product is completed into the residual's
    (``split.complete``)."""
    cdt = dt.compute
    b, sq, _ = x.shape
    h, hkv, hd = s.n_heads, s.n_kv_heads, s.head_dim

    def proj(name):
        t = project(x, _cast(p[name], cdt), s.weights_dtype,
                    grad_group=split.col_group)
        bias = "b" + name[1]
        if s.qkv_bias:
            t = t + _local_bias(split, p[bias], t).to(cdt)
        return t
    q, k, v = proj("wq"), proj("wk"), proj("wv")
    q_lay = split.attn_layout((b, sq, h, hd), "q")
    kv_lay = split.attn_layout((b, sq, hkv, hd), "k")

    def rope(t, pos):
        return apply_rope(t, pos, theta=s.rope_theta,
                          mrope_sections=s.mrope_sections)

    # k/v: the rank's kv heads ("heads"), else whole (every head): its
    # head_dim gathered before RoPE
    if kv_lay == "heads" and q_lay == "heads":
        kv_heads = k.shape[2]
    else:
        kv_heads = hkv
        dim = 2 if k.shape[2] < hkv else 3
        # a rank's use holds a part of the cotangent (its query rows, or
        # in the striped layout its heads); else every rank's use is
        # alike and each keeps its block's
        parts = q_lay == "seq" or (q_lay == "heads" and split.partial)
        k, v = ((split.gather if parts else split.whole)(t, dim)
                for t in (k, v))
    k = rope(k, positions)
    q_heads = h * kv_heads // hkv
    k, v = _expand_kv(k, q_heads), _expand_kv(v, q_heads)

    q_dim = 2 if q.shape[2] < h else 3     # where q is split
    offset = 0
    if q_lay == "heads":
        q = rope(q, positions)
        if k.shape[2] != q.shape[2]:   # every q head's k/v: the rank's
            k, v = (split.local(t, 2, q.shape[2]) for t in (k, v))
    elif q_lay == "seq":
        q = rope(split.to_seq(q, q_dim), split.seq_rows(positions))
        offset = split.index * (sq // split.size)
    else:
        q = rope(split.whole(q, q_dim), positions)
    out = dispatch.attention(q, k, v, causal=True, window=s.window,
                             out_dtype=cdt, q_offset=offset)

    # back to wo's layout: its heads, or its head_dim block
    wo = _cast(p["wo"], cdt)
    wo_dim = 2 if wo.shape[0] < h else 3
    if q_lay == "seq":
        out = split.from_seq(out, wo_dim)
    elif q_lay == "whole":
        out = split.own(out, wo_dim)
    bo, so = out.shape[:2]
    part = project(out.reshape(bo, so, -1), wo.reshape(-1, s.d_model),
                   s.weights_dtype, out_dtype=torch.float32)
    return split.complete(part, cdt)


def attention_naive(p: Params, s: AttnSpec, x: torch.Tensor,
                    positions: torch.Tensor, dt: DtypePolicy
                    ) -> torch.Tensor:
    """The JAX package's T0/T1 lowering, which materializes (S, S).  The
    port routes by device alone, so this is ``attention_blockwise``:
    the plain version on the CPU is the dense one."""
    return attention_blockwise(p, s, x, positions, dt)


def dense_page(cap: int) -> int:
    """The page a dense (B, cap, Hkv, hd) cache is viewed in by
    ``attention_decode``: 64 where it divides ``cap``, else the largest
    divisor of ``cap`` up to 64."""
    return next(d for d in range(min(64, cap), 0, -1) if cap % d == 0)


def dense_pages(batch: int, cap: int, pos: int, device
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(table (B, cap / page), lengths (B,)), both int32, that read
    ``batch`` dense (cap, Hkv, hd) caches at position ``pos`` as pages of
    ``dense_page(cap)``: slot b's table is its own run of pages, every
    length ``min(pos + 1, cap)`` (``attention_decode``; a rank's block of
    a striped cache passes its live slots less one,
    ``ModelSplit.stripe``)."""
    n_pages = cap // dense_page(cap)
    table = torch.arange(batch * n_pages, dtype=torch.int32,
                         device=device).view(batch, n_pages)
    lengths = torch.full((batch,), min(pos + 1, cap), dtype=torch.int32,
                         device=device)
    return table, lengths


def attention_decode(p: Params, s: AttnSpec, x: torch.Tensor, pos: int,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     dt: DtypePolicy,
                     pages: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                     positions: Optional[torch.Tensor] = None, *,
                     split=None, kv: str = "whole") -> torch.Tensor:
    """One-token decode against a dense KV cache, written in place.

    x: (B, 1, d).  pos: the current position, shared by every slot.
    caches: (B, cap, Hkv, hd) with cap = S_max (global layers) or
    min(window, S_max) (rolling: the delay-buffer §2.2 layout, slot =
    pos mod cap).  Returns (B, 1, d).

    The JAX package masks the cache with the rolling-buffer validity mask
    (``age < window`` and ``pos - age >= 0``, or ``idx <= pos`` for
    global layers) and takes its masked reference attention.  With cap <=
    window every age is below the window, so the valid entries are the
    buffer's first ``min(pos + 1, cap)``: a prefix.  Keys carry RoPE from
    before the write and softmax does not depend on key order, so this is
    ragged decode over that prefix: the cache is viewed, without a copy,
    as a (B * cap / page, page, Hkv, hd) pool, slot b's table is its own
    run of pages, every length is ``min(pos + 1, cap)`` and the window 0
    (``dispatch.decode_attention``: the decode kernel on the card, its
    plain version on the CPU).  As in the JAX package the mask does not
    depend on occupancy: a request admitted into a recycled slot attends
    to the previous occupant's entries too.  ``pages`` = ``dense_pages(B,
    cap, pos)``, built once a step for all layers of one cap, or here.
    ``positions`` (B, 1, 3) replaces ``pos`` in an M-RoPE arch's rotation
    (the cache slot stays ``pos``'s).  With ``split`` (the sharded decode)
    the weights and the cache are the rank's, the cache in ``kv``'s layout
    (``attention_decode_split``)."""
    if split is not None:
        return attention_decode_split(p, s, x, pos, k_cache, v_cache, dt,
                                      pages, positions, split, kv)
    b, cap, hkv, hd = k_cache.shape
    if positions is None:
        positions = torch.full((b, 1), pos, dtype=torch.int32,
                               device=x.device)
    q, k, v = _qkv(p, s, x, positions, dt)
    slot = pos % cap if s.window > 0 else pos
    k_cache[:, slot] = k[:, 0].to(k_cache.dtype)
    v_cache[:, slot] = v[:, 0].to(v_cache.dtype)
    page = dense_page(cap)
    n_pages = cap // page
    table, lengths = (pages if pages is not None
                      else dense_pages(b, cap, pos, x.device))
    out = dispatch.decode_attention(
        q[:, 0], k_cache.view(b * n_pages, page, hkv, hd),
        v_cache.view(b * n_pages, page, hkv, hd), table, lengths,
        out_dtype=dt.compute)
    return _out_proj(p, s, out[:, None], dt)


def attention_decode_split(p: Params, s: AttnSpec, x: torch.Tensor,
                           pos: int, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, dt: DtypePolicy,
                           pages: Optional[Tuple[torch.Tensor, torch.Tensor]],
                           positions: Optional[torch.Tensor], split,
                           kv: str) -> torch.Tensor:
    """``attention_decode`` on the model axis's shards (x (B, 1, d) alike
    on every rank; under ``torch.no_grad``): q/k/v projected
    column-parallel -- the rank's heads, or its head_dim block -- and the
    cache in ``MeshRules.cache_spec``'s layout ``kv``
    (``ModelSplit.kv_layout``):

    * ``heads``: the rank's q and kv heads; B2 over the local cache;
    * ``seq``: q/k/v gathered whole (one all-gather; k/v's head_dim
      before RoPE); the rank that holds slot ``pos`` (mod cap for a
      rolling buffer) writes it; B2 runs over the rank's block, whose
      live slots are its part of the valid prefix
      (``ModelSplit.stripe``), with its log-sum-exp, and the ranks'
      results merge (``ModelSplit.merge_stripes``);
    * ``whole``: q/k/v whole, every rank writes and attends alike.

    The output is cut to wo's layout (its heads or head_dim block) and
    the row-parallel product completed over the ranks.  ``pages``: the
    rank's ``dense_pages`` of this cap, or built here."""
    cdt = dt.compute
    b, cap_loc, hkv_loc, _ = k_cache.shape
    h, hkv, hd = s.n_heads, s.n_kv_heads, s.head_dim
    if positions is None:
        positions = torch.full((b, 1), pos, dtype=torch.int32,
                               device=x.device)

    def proj(name):
        t = project(x, _cast(p[name], cdt), s.weights_dtype)
        if s.qkv_bias:
            t = t + _local_bias(split, p["b" + name[1]], t).to(cdt)
        return t
    qkv = [proj("wq"), proj("wk"), proj("wv")]
    if kv != "heads":
        # every head whole: each projection split on its heads or its
        # head_dim (a leaf the axis does not divide is whole already)
        parts = [(i, 2 if t.shape[2] < n else 3) for i, (t, n) in
                 enumerate(zip(qkv, (h, hkv, hkv)))
                 if t.shape[2] < n or t.shape[3] < hd]
        if parts:
            got = split.gather_whole(*((qkv[i], d) for i, d in parts))
            for (i, _), t in zip(parts, got):
                qkv[i] = t
    q, k, v = qkv
    q = apply_rope(q, positions, theta=s.rope_theta,
                   mrope_sections=s.mrope_sections)
    k = apply_rope(k, positions, theta=s.rope_theta,
                   mrope_sections=s.mrope_sections)
    cap = cap_loc * split.size if kv == "seq" else cap_loc
    slot = pos % cap if s.window > 0 else pos
    first, live = split.stripe(pos, cap_loc, kv)
    if first <= slot < first + cap_loc:
        k_cache[:, slot - first] = k[:, 0].to(k_cache.dtype)
        v_cache[:, slot - first] = v[:, 0].to(v_cache.dtype)
    page = dense_page(cap_loc)
    n_pages = cap_loc // page
    table, lengths = (pages if pages is not None else dense_pages(
        b, cap_loc, live - 1, x.device))
    views = (k_cache.view(b * n_pages, page, hkv_loc, hd),
             v_cache.view(b * n_pages, page, hkv_loc, hd))
    if kv == "seq":
        out, lse = dispatch.decode_attention(
            q[:, 0], *views, table, lengths, out_dtype=torch.float32,
            return_lse=True)
        out = split.merge_stripes(out, lse).to(cdt)
    else:
        out = dispatch.decode_attention(q[:, 0], *views, table, lengths,
                                        out_dtype=cdt)
    # to wo's layout: its heads, or its head_dim block
    wo = _cast(p["wo"], cdt)
    if kv != "heads":
        dim = 1 if wo.shape[0] < h else 2
        out = split.local(out, dim, wo.shape[dim - 1])
    part = project(out.reshape(b, 1, -1), wo.reshape(-1, s.d_model),
                   s.weights_dtype, out_dtype=torch.float32)
    return split.complete(part, cdt)


def attention_decode_paged(p: Params, s: AttnSpec, x: torch.Tensor,
                           lengths: torch.Tensor, table: torch.Tensor,
                           k_pages: torch.Tensor, v_pages: torch.Tensor,
                           dt: DtypePolicy,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None,
                           positions: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """One-token ragged decode against the paged KV cache.

    x: (B, 1, d).  lengths: (B,) int32 tokens already cached per slot --
    the new token lands at position ``lengths[b]`` (inactive slots point
    at the trash page 0).  table: (B, n_pages) int32 page ids into the
    shared (P, page, Hkv, hd) pools, which are written in place.  int8
    pools carry ``k_scale`` / ``v_scale`` (P, Hkv) fp32, also written in
    place: the append runs the running-max requantize of ``core.quant``.
    ``positions`` (B, 1, 3) replaces ``lengths`` in an M-RoPE arch's
    rotation.  Returns (B, 1, d)."""
    b = x.shape[0]
    page = k_pages.shape[1]
    q, k, v = _qkv(p, s, x, lengths[:, None] if positions is None
                   else positions, dt)
    pid = table[torch.arange(b, device=x.device), lengths // page].long()
    off = (lengths % page).long()
    # in-place pool writes (the JAX package's donated .at[].set); inactive
    # slots all hit the never-read trash page, so their duplicate indices
    # are harmless
    if k_scale is not None:
        # gather the B target pages, append with the running-max rescale,
        # scatter pages and scales back
        for pages, scale, new in ((k_pages, k_scale, k), (v_pages, v_scale,
                                                          v)):
            pq, sc = quant.append_token_quantized(pages[pid], scale[pid],
                                                  new[:, 0], off)
            pages.index_copy_(0, pid, pq)
            scale.index_copy_(0, pid, sc)
    else:
        k_pages.index_put_((pid, off), k[:, 0].to(k_pages.dtype))
        v_pages.index_put_((pid, off), v[:, 0].to(v_pages.dtype))
    out = dispatch.decode_attention(q[:, 0], k_pages, v_pages, table,
                                    lengths + 1, k_scale, v_scale,
                                    window=s.window, out_dtype=dt.compute)
    return _out_proj(p, s, out[:, None], dt)


def attention_prefill_paged(p: Params, s: AttnSpec, x: torch.Tensor,
                            starts: torch.Tensor, tables: torch.Tensor,
                            k_pages: torch.Tensor, v_pages: torch.Tensor,
                            dt: DtypePolicy,
                            k_scale: Optional[torch.Tensor] = None,
                            v_scale: Optional[torch.Tensor] = None,
                            positions: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Chunked prefill: one page-aligned chunk each from B distinct slots.

    x: (B, C, d) with C == page size (the caller pads final partial
    chunks; padded positions are never read back).  starts: (B,) int32
    page-aligned chunk offsets; tables: (B, n_pages) each slot's page ids.
    Chunk b's queries sit at ``starts[b] + [0, C)`` and attend causally
    over that slot's cached history plus the chunk itself.  The pools are
    written in place; int8 pools get a clean abs-max scale per page
    (``quant.quantize_pages`` over the whole padded chunk, as in the JAX
    package).  ``positions`` (B, C, 3) replaces ``starts[b] + t`` in an
    M-RoPE arch's rotation.  Returns (B, C, d)."""
    b, c, _ = x.shape
    page = k_pages.shape[1]
    if positions is None:
        positions = starts[:, None] + torch.arange(
            c, device=x.device, dtype=starts.dtype)[None, :]
    q, k, v = _qkv(p, s, x, positions, dt)
    pid = tables[torch.arange(b, device=x.device), starts // page].long()
    # in-place whole-page writes (the JAX package's donated .at[].set)
    if k_scale is not None:
        for pages, scale, new in ((k_pages, k_scale, k), (v_pages, v_scale,
                                                          v)):
            pq, sc = quant.quantize_pages(new)
            pages.index_copy_(0, pid, pq)
            scale.index_copy_(0, pid, sc)
    else:
        k_pages.index_copy_(0, pid, k.to(k_pages.dtype))
        v_pages.index_copy_(0, pid, v.to(v_pages.dtype))
    out = dispatch.prefill_attention(q, k_pages, v_pages, tables, starts,
                                     k_scale, v_scale, window=s.window,
                                     out_dtype=dt.compute)
    return _out_proj(p, s, out, dt)


def attention_verify_paged(p: Params, s: AttnSpec, x: torch.Tensor,
                           lengths: torch.Tensor, table: torch.Tensor,
                           k_pages: torch.Tensor, v_pages: torch.Tensor,
                           dt: DtypePolicy,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None,
                           positions: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Speculative verify: score W candidate tokens per slot in one pass.

    x: (B, W, d) -- slot b's candidates sit at positions ``lengths[b] +
    [0, W)``, which are not page-aligned, so they append token by token
    as decode does (W is small).  A padded row past the slot's last
    logical page writes to trash page 0 (a clamped table read would land
    in the slot's last real page).  int8 pools take the running-max
    append.  The ragged prefill attention then scores all W queries
    causally against history plus the window itself: its mask is position
    arithmetic, so a mid-page start is legal.  Rejected drafts are rolled
    back by the host not advancing ``lengths``; their K/V (and any int8
    scale growth) stays in the pool behind every later read's length.
    The pools are written in place.  ``positions`` (B, W, 3) replaces
    ``lengths[b] + t`` in an M-RoPE arch's rotation.  Returns (B, W, d)."""
    b, w, _ = x.shape
    page = k_pages.shape[1]
    if positions is None:
        positions = lengths[:, None] + torch.arange(
            w, device=x.device, dtype=lengths.dtype)[None, :]
    q, k, v = _qkv(p, s, x, positions, dt)
    n_logical = table.shape[1]
    rows = torch.arange(b, device=x.device)
    for t in range(w):
        pos = (lengths + t).long()
        idx = pos // page
        pid = torch.where(idx < n_logical,
                          table[rows, idx.clamp(max=n_logical - 1)].long(),
                          0)
        off = pos % page
        # inactive slots and padded rows past the table all hit the
        # never-read trash page, so their duplicate indices are harmless
        if k_scale is not None:
            for pages, scale, new in ((k_pages, k_scale, k),
                                      (v_pages, v_scale, v)):
                pq, sc = quant.append_token_quantized(
                    pages[pid], scale[pid], new[:, t], off)
                pages.index_copy_(0, pid, pq)
                scale.index_copy_(0, pid, sc)
        else:
            k_pages.index_put_((pid, off), k[:, t].to(k_pages.dtype))
            v_pages.index_put_((pid, off), v[:, t].to(v_pages.dtype))
    out = dispatch.prefill_attention(q, k_pages, v_pages, table, lengths,
                                     k_scale, v_scale, window=s.window,
                                     out_dtype=dt.compute)
    return _out_proj(p, s, out, dt)


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------

def mlp_init(gen: torch.Generator, d: int, ff: int, activation: str,
             lead=()) -> Params:
    lead = tuple(lead)
    if activation in ("swiglu", "geglu"):
        return {"wg": dense_init(gen, lead + (d, ff), d),
                "wu": dense_init(gen, lead + (d, ff), d),
                "wd": dense_init(gen, lead + (ff, d), ff)}
    return {"wi": dense_init(gen, lead + (d, ff), d),
            "wd": dense_init(gen, lead + (ff, d), ff)}


def mlp_apply(p: Params, x: torch.Tensor, activation: str,
              dt: DtypePolicy, weights_dtype: str = "", *,
              tagged: bool = True, split=None) -> torch.Tensor:
    """The dense MLP.  Its projections carry Megatron's tensor-parallel
    tags: the up projections column-parallel (no collective), the down
    projection row-parallel (the block's psum).  A MoE layer's shared MLP
    stays replicated under tensor parallelism and passes ``tagged=False``
    (the JAX package tags it too, so its sharded serving would sum the
    replicated shared MLP once a shard).  The down projection's output
    only enters a sum, so a ``dots`` remat does not keep it.

    With ``split`` (the sharded train step) the weights are the rank's
    hidden columns and rows, x the whole sequence, and the down
    projection's partial sums are completed into the residual's layout
    (``split.complete``)."""
    cdt = dt.compute

    def mm(h, name, tp="col"):
        # a split's partial sums in fp32, added over the model axis before
        # their one rounding: the row-parallel output's, the
        # column-parallel input gradient's
        row = split is not None and tp == "row"
        col = split is not None and tp == "col"
        return project(h, _cast(p[name], cdt), weights_dtype,
                       tp=tp if tagged else None, saveable=name != "wd",
                       out_dtype=torch.float32 if row else None,
                       grad_group=split.col_group if col else None)
    if activation in ("swiglu", "geglu"):
        g = mm(x, "wg")
        u = mm(x, "wu")
        act = F.silu(g) if activation == "swiglu" \
            else F.gelu(g, approximate="tanh")
        out = mm(act * u, "wd", "row")
    else:
        h = mm(x, "wi")
        h = F.relu(h) if activation == "relu" \
            else F.gelu(h, approximate="tanh")
        out = mm(h, "wd", "row")
    return out if split is None else split.complete(out, cdt)


# output axes of each projection weight: q/k/v (d, heads, hd) end in
# (heads, hd); wo (H, hd, d) and the MLP weights end in one axis
OUT_DIMS = {"wq": 2, "wk": 2, "wv": 2, "wo": 1, "wg": 1, "wu": 1, "wi": 1,
            "wd": 1}


def quantize_layer_weights(p: Params, cdt: torch.dtype,
                           n_lead: int) -> Params:
    """A layer's params with every projection and MLP weight (cast to the
    compute dtype, as ``project`` sees it) replaced by its
    ``quantize_weight`` dict; norms and biases stay as they are."""
    out: Params = {}
    for key, sub in p.items():
        if key in ("attn", "mlp"):
            sub = {name: quantize_weight(w.to(cdt), n_lead, OUT_DIMS[name])
                   if name in OUT_DIMS else w for name, w in sub.items()}
        out[key] = sub
    return out


# --------------------------------------------------------------------------
# cross entropy
# --------------------------------------------------------------------------

def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy.  logits (..., V); labels (...) int."""
    logits = logits.float()
    m = logits.amax(dim=-1, keepdim=True).detach()
    shifted = logits - m
    lse = torch.log(torch.exp(shifted).sum(dim=-1))
    label_logit = torch.gather(shifted, -1, labels.long()[..., None])[..., 0]
    return (lse - label_logit).mean()


def _xent_chunk(x_c: torch.Tensor, head: torch.Tensor,
                l_c: torch.Tensor) -> torch.Tensor:
    logits = dispatch.matmul(x_c, head).float()
    m = logits.amax(dim=-1, keepdim=True).detach()
    shifted = logits - m
    lse = torch.log(torch.exp(shifted).sum(dim=-1))
    label_logit = torch.gather(shifted, -1, l_c.long()[..., None])[..., 0]
    return (lse - label_logit).sum()


def _xent_chunk_split(x_c: torch.Tensor, head: torch.Tensor,
                      l_c: torch.Tensor, split) -> torch.Tensor:
    """``_xent_chunk`` on the rank's vocabulary columns of the head
    (Megatron's vocab-parallel cross entropy): the max and the sum of
    exps over every rank's columns, the label's logit from the rank that
    holds it.  The head's columns are a column-parallel product: x's
    gradient is added over the ranks in fp32."""
    logits = dispatch.matmul(x_c, head, grad_group=split.col_group).float()
    v_loc = logits.shape[-1]
    m = split.group.all_gather(logits.amax(dim=-1, keepdim=True).detach(),
                               -1).amax(dim=-1, keepdim=True)
    shifted = logits - m
    lse = torch.log(coll.psum(torch.exp(shifted).sum(dim=-1), split.group))
    label = l_c.long() - split.index * v_loc
    inside = (label >= 0) & (label < v_loc)
    picked = torch.gather(shifted, -1, label.clamp(0, v_loc - 1)[..., None])
    label_logit = coll.psum(torch.where(inside, picked[..., 0], 0.0),
                            split.group)
    return (lse - label_logit).sum()


def chunked_xent(x: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
                 *, n_chunks: int, remat: bool = True,
                 split=None) -> torch.Tensor:
    """Head matmul + cross entropy, tiled over the sequence (§3.4): only
    one (B, S/n_chunks, V) logits tile is alive at a time, and with
    ``remat`` each tile is recomputed in the backward
    (``torch.utils.checkpoint``, as JAX's ``jax.checkpoint(chunk)``).
    x: (B, S, d) post-final-norm; head (d, V).  Returns the mean.  With
    ``split`` the head is the rank's (d, V / m) vocabulary columns and the
    mean is the whole vocabulary's, equal on every rank."""
    b, sq, _ = x.shape
    while n_chunks > 1 and sq % n_chunks != 0:
        n_chunks //= 2
    c = sq // n_chunks
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    fn = _xent_chunk if split is None \
        else lambda x_c, w, l_c: _xent_chunk_split(x_c, w, l_c, split)
    for i in range(n_chunks):
        x_c, l_c = x[:, i * c:(i + 1) * c], labels[:, i * c:(i + 1) * c]
        if remat:
            total = total + torch.utils.checkpoint.checkpoint(
                fn, x_c, head, l_c, use_reentrant=False)
        else:
            total = total + fn(x_c, head, l_c)
    return total / (b * sq)


def embed_split(table: torch.Tensor, tokens: torch.Tensor, split
                ) -> torch.Tensor:
    """The embedding rows of ``tokens`` (B, S) from the rank's vocabulary
    rows ``table`` (V / m, d): the rows it holds, zeros for the others,
    added over the model axis into the residual's layout (each token's
    row comes from one rank, so the sum is that row's bits)."""
    v_loc = table.shape[0]
    ids = tokens.long() - split.index * v_loc
    inside = ((ids >= 0) & (ids < v_loc))[..., None]
    rows = torch.where(inside, table[ids.clamp(0, v_loc - 1)], 0.0)
    return split.complete(rows.to(table.dtype))
