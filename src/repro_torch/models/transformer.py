"""The decoder LM -- the port of ``repro/models/transformer.py``: the
whole-sequence forward and the training loss (with the MoE layers'
load-balancing aux loss) of every arch; for attention stacks with dense
MLP or MoE FFNs, the serving forwards over a paged or a dense KV cache
and the speculative verify forward; for the recurrent archs (RWKV6 time
and channel mixes, Griffin's RG-LRU blocks beside local attention), the
decode step over the dense cache, which is their whole serving path, as
in the JAX package.

Layer stacking keeps the JAX package's layout (paper §2.5 loop
flattening): ``prefix`` layers, ``n_periods`` repetitions of the layer
*pattern* stored with a leading period axis, and a ``tail``.  JAX scans
over the period axis; here a Python loop walks it.  Serving gives each
layer views of the stacked params and pools, so pool writes land in
place; training takes the period slices with one ``unbind(0)`` per
forward, whose backward stacks each leaf's gradient once (indexing the
stack per layer would build a zero tensor of the whole stack for every
slice's gradient).

Params are a nested dict with the JAX tree's keys and nesting
(``embed``, ``final_norm/scale``, ``prefix``/``stack``/``tail`` lists of
``{"ln1", "ln2", "attn" / "tm" / "rec", "mlp" / "moe" / "cm"}``), so
``convert.params_from_jax`` maps a JAX tree one to one.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import math
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch
import torch.utils.checkpoint

from ..configs.base import ArchConfig, LayerKind
from ..core import tree as tree_mod
from ..core.device import DeviceLike, resolve_device
from ..core.memory import BF16_POLICY, DtypePolicy
from ..core.quant import kv_dtype_of
from ..kernels import dispatch
from . import griffin, layers, moe, moe_sharded, rwkv
from .layers import Params


@dataclasses.dataclass(frozen=True)
class ExecOptions:
    """How the forwards run (the JAX ``ExecOptions`` fields the port
    has)."""
    block_q: int = 512
    block_kv: int = 512
    remat: bool = True
    # "full" recomputes every layer in the backward (JAX's
    # nothing_saveable); "dots" keeps the outputs of the layer's
    # dispatch.matmul products that its backward reads and recomputes the
    # rest (JAX's dots_with_no_batch_dims_saveable; dispatch.RematTape)
    remat_policy: str = "full"
    attn_impl: str = "blockwise"   # blockwise | naive
    # sequence tiles for the head matmul + xent (§3.4)
    xent_chunks: int = 8
    # expert-parallel MoE: a mesh (launch/mesh.Mesh) and its data axes
    # route every MoE layer through moe_sharded.moe_apply_sharded, whose
    # params hold this rank's expert shards; the experts pad to a
    # multiple of expert_pad (the EP axes' size)
    moe_mesh: Optional[Any] = None
    moe_dp_axes: Tuple[str, ...] = ()
    moe_ep_axes: Tuple[str, ...] = ("model",)
    expert_pad: int = 1
    # sharded training (runtime/sharding.TrainSharding): the params are
    # this rank's shards and the batch its rows; every leaf is gathered
    # over the batch axes at its use (a layer's inside its remat
    # recompute) and used as its shard on the model axis, whose ranks
    # split each layer's work (runtime/model_axis.py); the loss is the
    # mean over the batch axes, and a MoE layer (with moe_mesh) routes
    # the rank's own tokens, its experts kept as shards
    sharding: Optional[Any] = None
    # the residual stream's layout (JAX's make_constrain: a (B, S, d)
    # shape's spec; S on the model axis is Megatron-SP striping) and the
    # q/k/v layout at attention entry (JAX's attn_hook: a (B, S, H, hd)
    # shape's spec by role), read by the sharded train step; None: the
    # residual replicated over the model axis, attention by
    # MeshRules.attn_spec
    constrain: Optional[Any] = None
    attn_constrain: Optional[Any] = None


@dataclasses.dataclass(frozen=True)
class Layout:
    prefix: Tuple[LayerKind, ...]
    period: Tuple[LayerKind, ...]
    n_periods: int
    tail: Tuple[LayerKind, ...]


def make_layout(cfg: ArchConfig) -> Layout:
    kinds = cfg.layer_kinds()
    pre = tuple(cfg.prefix)
    rest = kinds[len(pre):]
    if cfg.pattern and len(rest) >= len(cfg.pattern):
        p = len(cfg.pattern)
        n_periods = len(rest) // p
        tail = rest[n_periods * p:]
        return Layout(pre, tuple(cfg.pattern), n_periods, tail)
    return Layout(kinds, (), 0, ())


def _attn_spec(cfg: ArchConfig, mixer: str) -> layers.AttnSpec:
    return layers.AttnSpec(
        d_model=cfg.d_model, n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
        window=cfg.window if mixer == "swa" else 0,
        rope_theta=cfg.rope_theta, qkv_bias=cfg.qkv_bias,
        weights_dtype=cfg.weights_dtype,
        mrope_sections=cfg.mrope_sections)


def _moe_spec(cfg: ArchConfig, pad_to: int = 1) -> moe.MoESpec:
    return moe.MoESpec(
        d_model=cfg.d_model, n_experts=cfg.n_experts, top_k=cfg.top_k,
        d_expert=cfg.d_expert, n_shared_experts=cfg.n_shared_experts,
        shared_d_expert=cfg.shared_d_expert,
        capacity_factor=cfg.capacity_factor, activation=cfg.activation,
        pad_to=pad_to)


def _rwkv_spec(cfg: ArchConfig) -> rwkv.RwkvSpec:
    return rwkv.RwkvSpec(d_model=cfg.d_model, head_dim=cfg.rwkv_head_dim,
                         chunk=cfg.rwkv_chunk, d_ff=cfg.d_ff,
                         intra=cfg.rwkv_intra)


def _griffin_spec(cfg: ArchConfig) -> griffin.GriffinSpec:
    width = cfg.lru_width or cfg.d_model
    return griffin.GriffinSpec(d_model=cfg.d_model, lru_width=width,
                               conv_width=cfg.conv_width,
                               block_width=min(256, width))


def paged_supported(cfg: ArchConfig) -> bool:
    """Can this arch serve from a paged KV cache?  Every mixer must be
    attention-family and every FFN stateless, a dense MLP or MoE (chunked
    prefill has no carried-state scan for recurrent layers)."""
    return all(m in ("attn", "swa") and f in ("mlp", "moe")
               for m, f in cfg.layer_kinds())


def _require_paged(cfg: ArchConfig) -> None:
    """The paged entry points' refusal of recurrent archs, in the JAX
    scheduler's words."""
    if not paged_supported(cfg):
        raise ValueError(
            f"arch {cfg.name} has recurrent/stateful layers; paged serving "
            "requires attention-family stacks (use --cache dense)")


# --------------------------------------------------------------------------
# layer init / prefill / decode
# --------------------------------------------------------------------------

def layer_init(gen: torch.Generator, cfg: ArchConfig, kind: LayerKind,
               lead=(), dtype: torch.dtype = torch.float32,
               expert_pad: int = 1) -> Params:
    """One layer's params in ``dtype``, the mixer cast before the FFN is
    drawn; ``lead`` = (n_periods,) stacks a period; a MoE layer's experts
    pad to a multiple of ``expert_pad``."""
    mixer, ffn = kind
    p = {"ln1": layers.rmsnorm_init(cfg.d_model, lead, gen.device),
         "ln2": layers.rmsnorm_init(cfg.d_model, lead, gen.device)}
    if mixer in ("attn", "swa"):
        p["attn"] = layers.attention_init(gen, _attn_spec(cfg, mixer), lead)
    elif mixer == "rwkv":
        p["tm"] = rwkv.time_mix_init(gen, _rwkv_spec(cfg), lead)
    elif mixer == "rglru":
        p["rec"] = griffin.rglru_block_init(gen, _griffin_spec(cfg), lead)
    else:
        raise ValueError(f"mixer {mixer!r}")
    p = _cast(p, dtype)
    if ffn == "mlp":
        p["mlp"] = layers.mlp_init(gen, cfg.d_model, cfg.d_ff,
                                   cfg.activation, lead)
    elif ffn == "moe":
        # cast leaf by leaf: the experts are most of a MoE model
        p["moe"] = moe.moe_init(gen, _moe_spec(cfg, expert_pad), lead,
                                dtype)
    elif ffn == "rwkv_cm":
        p["cm"] = rwkv.channel_mix_init(gen, _rwkv_spec(cfg), lead)
    else:
        raise ValueError(f"ffn {ffn!r}")
    return _cast(p, dtype)


def _ffn(p: Params, cfg: ArchConfig, kind: LayerKind, h: torch.Tensor,
         dt: DtypePolicy, opts: Optional[ExecOptions] = None
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """A layer's FFN on h (B, S, d): (out, aux loss, None for an MLP).
    MoE layers route every token of the (B, S) they are given and keep
    float weights under ``weights_dtype="int8"``, as the JAX package's
    do; with ``opts.moe_mesh`` set they run expert-parallel
    (``moe_sharded.moe_apply_sharded``) on this rank's expert shards."""
    if kind[1] == "moe":
        spec = _moe_spec(cfg, opts.expert_pad if opts else 1)
        if opts is not None and opts.moe_mesh is not None:
            local = opts.sharding is not None
            return moe_sharded.moe_apply_sharded(
                p["moe"], spec, h, dt, mesh=opts.moe_mesh,
                dp_axes=opts.sharding.batch if local else opts.moe_dp_axes,
                ep_axes=opts.moe_ep_axes, batch_local=local)
        return moe.moe_apply(p["moe"], spec, h, dt)
    return layers.mlp_apply(p["mlp"], h, cfg.activation, dt,
                            cfg.weights_dtype), None


def layer_cache_init_paged(cfg: ArchConfig, total_pages: int, page_size: int,
                           dtype: torch.dtype, device,
                           lead=()) -> Dict[str, torch.Tensor]:
    """Shared (P, page, Hkv, hd) K/V page pools of one attention layer;
    int8 pools add zeroed (P, Hkv) fp32 ``k_scale`` / ``v_scale`` (a zero
    scale marks a clean page: the running-max append wipes any stale
    payload on its first write)."""
    lead = tuple(lead)
    shape = lead + (total_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
    cache = {"k_pages": torch.zeros(shape, dtype=dtype, device=device),
             "v_pages": torch.zeros(shape, dtype=dtype, device=device)}
    if dtype == torch.int8:
        for name in ("k_scale", "v_scale"):
            cache[name] = torch.zeros(lead + (total_pages, cfg.n_kv_heads),
                                      dtype=torch.float32, device=device)
    return cache


def layer_prefill_paged(p: Params, cfg: ArchConfig, kind: LayerKind,
                        x: torch.Tensor, cache: Dict[str, torch.Tensor],
                        starts: torch.Tensor, tables: torch.Tensor,
                        dt: DtypePolicy,
                        positions: Optional[torch.Tensor] = None,
                        opts: Optional[ExecOptions] = None
                        ) -> torch.Tensor:
    """One page-aligned prompt chunk each of B distinct slots through one
    layer (x (B, C, d), starts (B,), tables (B, n_pages); ``positions``
    (B, C, 3) for an M-RoPE arch)."""
    h = layers.rmsnorm(p["ln1"], x)
    h = layers.attention_prefill_paged(
        p["attn"], _attn_spec(cfg, kind[0]), h, starts, tables,
        cache["k_pages"], cache["v_pages"], dt, cache.get("k_scale"),
        cache.get("v_scale"), positions=positions)
    x = x + h
    return x + _ffn(p, cfg, kind, layers.rmsnorm(p["ln2"], x), dt, opts)[0]


def layer_cache_init(cfg: ArchConfig, kind: LayerKind, batch: int,
                     max_len: int, dtype: torch.dtype, device,
                     lead=()) -> Dict[str, torch.Tensor]:
    """One layer's dense decode state.  Attention: (B, cap, Hkv, hd) K/V,
    cap = max_len for global layers, min(window, max_len) for windowed
    ones (a rolling buffer, slot = pos mod cap).  RWKV: the fp32 WKV
    ``state`` and the ``xprev`` / ``cm_xprev`` token shifts; RG-LRU: the
    fp32 ``h`` and the ``conv`` delay buffer (``dtype`` for all but the
    fp32 leaves)."""
    mixer, ffn = kind
    lead = tuple(lead)
    cache: Dict[str, torch.Tensor] = {}
    if mixer in ("attn", "swa"):
        cap = min(cfg.window, max_len) if mixer == "swa" else max_len
        shape = lead + (batch, cap, cfg.n_kv_heads, cfg.head_dim)
        cache["k"] = torch.zeros(shape, dtype=dtype, device=device)
        cache["v"] = torch.zeros(shape, dtype=dtype, device=device)
    elif mixer == "rwkv":
        cache.update(rwkv.rwkv_cache_init(batch, _rwkv_spec(cfg), dtype,
                                          device, lead))
    elif mixer == "rglru":
        cache.update(griffin.griffin_cache_init(
            batch, _griffin_spec(cfg), dtype, device, lead))
    if ffn == "rwkv_cm" and "cm_xprev" not in cache:
        cache["cm_xprev"] = torch.zeros(lead + (batch, cfg.d_model),
                                        dtype=dtype, device=device)
    return cache


def layer_decode(p: Params, cfg: ArchConfig, kind: LayerKind,
                 x: torch.Tensor, cache: Dict[str, torch.Tensor],
                 dt: DtypePolicy, *, pos: Optional[int] = None,
                 paged: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 pages: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 positions: Optional[torch.Tensor] = None,
                 opts: Optional[ExecOptions] = None, split=None,
                 kv: str = "whole") -> torch.Tensor:
    """One decode token per slot through one layer.  ``paged`` = (lengths,
    table) takes the paged ragged path (every slot at its own length);
    otherwise every slot decodes at the shared ``pos`` against its dense
    cache, read as ``pages`` (``layers.dense_pages``) where given.
    ``positions`` (B, 1, 3) rotates an M-RoPE arch's q and k.  Recurrent
    mixers and the channel mix carry their state in the same cache tree
    (dense only).  The caches are written in place.  With ``split``
    (``layer_decode_split``) the layer runs on the model axis's shards."""
    if split is not None:
        return layer_decode_split(p, cfg, kind, x, cache, dt, pos, pages,
                                  positions, opts, split, kv)
    mixer, ffn = kind
    cdt = dt.compute
    h = layers.rmsnorm(p["ln1"], x)
    if mixer == "rwkv":
        h = rwkv.time_mix_decode(p["tm"], _rwkv_spec(cfg), h, cache, cdt)
    elif mixer == "rglru":
        h = griffin.rglru_block_decode(p["rec"], _griffin_spec(cfg), h,
                                       cache, cdt)
    elif paged is not None:
        lengths, table = paged
        h = layers.attention_decode_paged(
            p["attn"], _attn_spec(cfg, mixer), h, lengths, table,
            cache["k_pages"], cache["v_pages"], dt, cache.get("k_scale"),
            cache.get("v_scale"), positions=positions)
    else:
        h = layers.attention_decode(p["attn"], _attn_spec(cfg, mixer), h,
                                    pos, cache["k"], cache["v"], dt, pages,
                                    positions=positions)
    x = x + h
    if ffn == "rwkv_cm":
        # the shift runs the normed input against the residual stream the
        # previous token left after its time mix: the JAX package's decode
        # stores x, where its forward shifts normed against normed
        h = rwkv.channel_mix_apply(p["cm"], _rwkv_spec(cfg),
                                   layers.rmsnorm(p["ln2"], x), cdt,
                                   x_prev=cache["cm_xprev"])
        cache["cm_xprev"].copy_(x[:, 0])
        return x + h
    return x + _ffn(p, cfg, kind, layers.rmsnorm(p["ln2"], x), dt, opts)[0]


def layer_decode_split(p: Params, cfg: ArchConfig, kind: LayerKind,
                       x: torch.Tensor, cache: Dict[str, torch.Tensor],
                       dt: DtypePolicy, pos: int,
                       pages: Optional[Tuple[torch.Tensor, torch.Tensor]],
                       positions: Optional[torch.Tensor],
                       opts: ExecOptions, split, kv: str) -> torch.Tensor:
    """``layer_decode`` on the model axis's shards: x (B, 1, d) alike on
    every rank (the residual replicated), the params the rank's shards
    and the dense cache its block in ``MeshRules.cache_spec``'s layout
    (``kv``: an attention layer's, ``ModelSplit.kv_layout``).  Attention
    as ``layers.attention_decode_split``; RWKV's mixes and the RG-LRU on
    the rank's heads and channels, the token shifts they read whole
    gathered in one all-gather; the MLP column- then row-parallel; a MoE
    FFN routes the same tokens on every model rank over its expert
    shards, its shared MLP on the rank's shards."""
    mixer, ffn = kind
    cdt = dt.compute
    h = layers.rmsnorm(p["ln1"], x)
    shifts = {n: cache[n] for n in ("xprev", "cm_xprev") if n in cache}
    parted = [n for n, t in shifts.items() if t.shape[-1] < cfg.d_model]
    if parted:
        shifts.update(zip(parted, split.gather_whole(
            *((shifts[n], 1) for n in parted))))
    if mixer == "rwkv":
        h = rwkv.time_mix_decode(p["tm"], _rwkv_spec(cfg), h, cache, cdt,
                                 split, shifts["xprev"])
    elif mixer == "rglru":
        h = griffin.rglru_block_decode(p["rec"], _griffin_spec(cfg), h,
                                       cache, cdt, split)
    else:
        h = layers.attention_decode(p["attn"], _attn_spec(cfg, mixer), h,
                                    pos, cache["k"], cache["v"], dt, pages,
                                    positions=positions, split=split, kv=kv)
    x = x + h
    h = layers.rmsnorm(p["ln2"], x)
    if ffn == "rwkv_cm":
        h = rwkv.channel_mix_apply(p["cm"], _rwkv_spec(cfg), h, cdt,
                                   x_prev=shifts["cm_xprev"], split=split)
        prev = cache["cm_xprev"]
        prev.copy_(split.local(x[:, 0], 1, prev.shape[1]))
        return x + h
    if ffn == "moe":
        out, _ = moe_sharded.moe_apply_sharded(
            p["moe"], _moe_spec(cfg, opts.expert_pad), h, dt,
            mesh=opts.moe_mesh, dp_axes=opts.sharding.batch,
            ep_axes=opts.moe_ep_axes, batch_local=True, shared_split=split)
        return x + out
    return x + layers.mlp_apply(p["mlp"], h, cfg.activation, dt,
                                cfg.weights_dtype, split=split)


def layer_verify_paged(p: Params, cfg: ArchConfig, kind: LayerKind,
                       x: torch.Tensor, cache: Dict[str, torch.Tensor],
                       lengths: torch.Tensor, tables: torch.Tensor,
                       dt: DtypePolicy,
                       positions: Optional[torch.Tensor] = None,
                       opts: Optional[ExecOptions] = None
                       ) -> torch.Tensor:
    """One speculative verify window of B distinct slots through one layer
    (x (B, W, d), lengths (B,), tables (B, n_pages); ``positions`` (B, W,
    3) for an M-RoPE arch)."""
    h = layers.rmsnorm(p["ln1"], x)
    h = layers.attention_verify_paged(
        p["attn"], _attn_spec(cfg, kind[0]), h, lengths, tables,
        cache["k_pages"], cache["v_pages"], dt, cache.get("k_scale"),
        cache.get("v_scale"), positions=positions)
    x = x + h
    return x + _ffn(p, cfg, kind, layers.rmsnorm(p["ln2"], x), dt, opts)[0]


def layer_apply(p: Params, cfg: ArchConfig, kind: LayerKind,
                x: torch.Tensor, positions: torch.Tensor, dt: DtypePolicy,
                opts: ExecOptions, split=None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One layer of the training / dense forward over whole sequences:
    x (B, S, d) -> ((B, S, d), the FFN's aux loss or None).  The
    recurrent mixers and the channel mix start from a zero state, as the
    JAX package's do.  With ``split`` (``layer_apply_split``) the layer
    runs on the model axis's shards."""
    if split is not None:
        return layer_apply_split(p, cfg, kind, x, positions, dt, opts,
                                 split)
    mixer, ffn = kind
    cdt = dt.compute
    h = layers.rmsnorm(p["ln1"], x)
    if mixer == "rwkv":
        h = rwkv.time_mix_apply(p["tm"], _rwkv_spec(cfg), h, cdt)
    elif mixer == "rglru":
        h = griffin.rglru_block_apply(p["rec"], _griffin_spec(cfg), h, cdt)
    elif opts.attn_impl == "naive":
        h = layers.attention_naive(p["attn"], _attn_spec(cfg, mixer), h,
                                   positions, dt)
    else:
        h = layers.attention_blockwise(p["attn"], _attn_spec(cfg, mixer), h,
                                       positions, dt, block_q=opts.block_q,
                                       block_kv=opts.block_kv)
    x = x + h
    h = layers.rmsnorm(p["ln2"], x)
    if ffn == "rwkv_cm":
        return x + rwkv.channel_mix_apply(p["cm"], _rwkv_spec(cfg), h,
                                          cdt), None
    h, aux = _ffn(p, cfg, kind, h, dt, opts)
    return x + h, aux


def layer_apply_split(p: Params, cfg: ArchConfig, kind: LayerKind,
                      x: torch.Tensor, positions: torch.Tensor,
                      dt: DtypePolicy, opts: ExecOptions, split
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``layer_apply`` on the model axis's shards: x in the residual's
    layout (``split``); each branch takes the whole sequence
    (``split.branch``; the norm runs on it alike on every rank) and comes
    back completed into that layout, as JAX constrains the branch outputs
    inside the remat boundary (``repro/models/transformer.py:158-192``).
    A MoE FFN routes the rank's own tokens and runs its shared MLP on the
    shards over the whole sequence."""
    mixer, ffn = kind
    cdt = dt.compute
    h = layers.rmsnorm(p["ln1"], split.branch(x))
    if mixer == "rwkv":
        h = rwkv.time_mix_apply(p["tm"], _rwkv_spec(cfg), h, cdt,
                                split=split)
    elif mixer == "rglru":
        h = griffin.rglru_block_apply(p["rec"], _griffin_spec(cfg), h, cdt,
                                      split=split)
    else:
        h = layers.attention_blockwise(p["attn"], _attn_spec(cfg, mixer), h,
                                       positions, dt, split=split)
    x = x + h
    if ffn == "moe":
        # the rank's own tokens: its block of the striped residual, or of
        # the whole normed stream
        if split.seq:
            tokens = layers.rmsnorm(p["ln2"], x)
            h = split.gather(tokens, 1)
        else:
            h = layers.rmsnorm(p["ln2"], x)
            tokens = split.own(h, 1)
        spec = _moe_spec(cfg, opts.expert_pad)
        out, aux = moe_sharded.moe_apply_sharded(
            p["moe"], spec, tokens, dt, mesh=opts.moe_mesh,
            dp_axes=opts.sharding.batch, ep_axes=opts.moe_ep_axes,
            batch_local=True, split=split)
        if spec.n_shared_experts:
            # the shared MLP on the model axis's shards over the whole
            # sequence, its partial sums reduce-scattered to the rank's
            # tokens
            out = out + layers.mlp_apply(
                p["moe"]["shared"], h, cfg.activation, dt, tagged=False,
                split=dataclasses.replace(split, to_tokens=True))
        return x + split.untokens(out), aux
    h = layers.rmsnorm(p["ln2"], split.branch(x))
    if ffn == "rwkv_cm":
        return x + rwkv.channel_mix_apply(p["cm"], _rwkv_spec(cfg), h, cdt,
                                          split=split), None
    return x + layers.mlp_apply(p["mlp"], h, cfg.activation, dt,
                                cfg.weights_dtype, split=split), None


def _gathered_layer(p: Params, specs, cfg: ArchConfig, kind: LayerKind,
                    x: torch.Tensor, positions: torch.Tensor,
                    dt: DtypePolicy, opts: ExecOptions, split=None
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``layer_apply`` on a layer's shards, gathered here over the batch
    axes (so a remat recompute gathers them again, and the gathered
    weights live only while the layer runs); on the model axis each
    stays the rank's shard (``split``)."""
    p = opts.sharding.gather_tree(p, specs,
                                  keep_experts=opts.moe_mesh is not None,
                                  partial=split is not None and split.partial)
    return layer_apply(p, cfg, kind, x, positions, dt, opts, split)


def _unstacked(specs):
    """A stacked subtree's specs without the period axis."""
    if isinstance(specs, dict):
        return {k: _unstacked(v) for k, v in specs.items()}
    return type(specs)(*specs[1:])


def _unbind(tree) -> List[Any]:
    """The period slices of a stacked subtree, one ``unbind(0)`` per
    leaf."""
    if isinstance(tree, dict):
        parts = {k: _unbind(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return list(tree.unbind(0))


def _index(tree, i: int):
    """Period ``i`` of a stacked subtree, as views."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

class Model:
    """Serving forwards (paged and dense caches, speculative verify) and
    the training loss of one arch, on one device.

    An arch with ``input_mode="embeddings"`` (musicgen-large, qwen2-vl-2b:
    the frontend is a stub) takes ``batch["embeddings"]`` (B, S, d) in
    place of tokens, and an M-RoPE arch ``batch["positions"]`` (B, S, 3),
    in ``loss_fn``, ``forward`` and ``prefill``, and (B, 1, d) and (B, 1,
    3) in ``decode_step``; the paged prefill and verify forwards embed
    tokens, as the JAX package's do.

    The recurrent archs (rwkv6-7b, recurrentgemma-9b) run the
    whole-sequence forwards (``loss_fn``, ``forward``, ``prefill``) and
    serve through ``decode_step`` on the dense cache only, as in the JAX
    package.

    ``device`` defaults to the CUDA card and raises without one; pass
    ``device="cpu"`` to run the plain PyTorch versions on the CPU."""

    def __init__(self, cfg: ArchConfig, dt: DtypePolicy = BF16_POLICY,
                 device: DeviceLike = None,
                 opts: ExecOptions = ExecOptions()):
        if cfg.input_mode not in ("tokens", "embeddings"):
            raise ValueError(f"input_mode {cfg.input_mode!r} is not "
                             "supported (tokens or embeddings)")
        if cfg.weights_dtype not in ("", "int8"):
            raise ValueError(f"weights_dtype {cfg.weights_dtype!r} is not "
                             "supported (float '' or 'int8')")
        self.cfg = cfg
        self.dt = dt
        if opts.remat_policy not in ("full", "dots"):
            raise ValueError(f"remat_policy {opts.remat_policy!r}")
        if opts.attn_impl not in ("blockwise", "naive"):
            raise ValueError(f"attn_impl {opts.attn_impl!r}")
        self.device = resolve_device(device)
        self.layout = make_layout(cfg)
        self.opts = opts

    # ------------------------------ init ------------------------------
    def init(self, seed: int) -> Params:
        """Random params from a seeded ``torch.Generator`` on the model's
        device, in the policy's param dtype (each layer cast as it is
        drawn, so the fp32 draws of a whole model never coexist); the
        final norm stays fp32, as in the JAX package."""
        return self._init_tree(
            torch.Generator(device=self.device).manual_seed(seed))

    def param_specs(self) -> Params:
        """The params tree on ``meta``: ``init``'s keys, nesting, shapes
        and dtypes, with nothing allocated and nothing drawn (JAX's
        ``jax.eval_shape(init)``)."""
        return Model(self.cfg, self.dt, "meta", self.opts)._init_tree(
            _ShapeGenerator())

    def _init_tree(self, gen: torch.Generator) -> Params:
        cfg, lay, pdt = self.cfg, self.layout, self.dt.param
        params: Params = {
            "embed": layers.embed_init(
                gen, (cfg.vocab_size, cfg.d_model)).to(pdt),
            "final_norm": layers.rmsnorm_init(cfg.d_model, (), gen.device),
        }
        if not cfg.tie_embeddings:
            params["head"] = layers.dense_init(
                gen, (cfg.d_model, cfg.vocab_size), cfg.d_model).to(pdt)

        def init(kind, lead=()):
            return layer_init(gen, cfg, kind, lead, pdt,
                              self.opts.expert_pad)
        params["prefix"] = [init(k) for k in lay.prefix]
        params["stack"] = [init(k, (lay.n_periods,))
                           for k in lay.period] if lay.n_periods else []
        params["tail"] = [init(k) for k in lay.tail]
        return params

    def bind_params(self, params: Params) -> Params:
        """The params the paged forwards run on.  With
        ``weights_dtype="int8"`` every projection and MLP weight is
        quantized per output channel here, once, from its compute-dtype
        cast (the JAX package quantizes the same input at every call, so
        the ints and scales are its own); the embedding, the head, the
        norms and the MoE layers (router, experts and shared MLP, which
        the JAX package runs in float) stay float.  Float weights are
        returned as they are."""
        if self.cfg.weights_dtype != "int8":
            return params
        cdt = self.dt.compute
        out = dict(params)
        for group, n_lead in (("prefix", 0), ("stack", 1), ("tail", 0)):
            out[group] = [layers.quantize_layer_weights(p, cdt, n_lead)
                          for p in params[group]]
        return out

    # ------------------------------ pieces -----------------------------
    def _embed(self, params: Params, batch: Dict[str, torch.Tensor],
               split=None) -> torch.Tensor:
        """The (B, S, d) input of the stack in the compute dtype:
        ``batch["embeddings"]`` for an embedding-input arch, else the
        embedding rows of ``batch["tokens"]``; then the ``embed_scale``.
        With ``split`` the input is in the residual's layout: the
        embeddings cut to the rank's block, the rows looked up
        vocab-parallel (``layers.embed_split``)."""
        cdt = self.dt.compute
        if self.cfg.input_mode == "embeddings":
            x = batch["embeddings"].to(cdt)
            if split is not None:
                x = split.enter(x)
        elif split is not None:
            x = layers.embed_split(params["embed"].to(cdt), batch["tokens"],
                                   split)
        else:
            x = params["embed"].to(cdt)[batch["tokens"].long()]
        if self.cfg.embed_scale:
            # sqrt(d) rounded to the compute dtype first, as the JAX
            # package multiplies by jnp.asarray(sqrt(d), compute)
            x = x * torch.tensor(self.cfg.d_model ** 0.5, dtype=cdt).item()
        return x

    def _logits(self, params: Params, x: torch.Tensor,
                split=None) -> torch.Tensor:
        """The final norm and the head of x (B, S, d).  With ``split``
        (the sharded serving steps, x whole on every rank) the head is the
        rank's vocabulary columns and the logits are gathered whole over
        the model axis, in rank order."""
        x = layers.rmsnorm(params["final_norm"], x)
        # the tied head is a transposed view; the matmul kernel reads it
        # through its strides, so no 256000-row copy is made per call
        head = params["embed"].T if self.cfg.tie_embeddings \
            else params["head"]
        logits = dispatch.matmul(x, head.to(self.dt.compute))
        if split is not None and head.shape[-1] < self.cfg.vocab_size:
            logits = split.gather_whole((logits, logits.dim() - 1))[0]
        return logits

    def _walk(self, tree) -> Iterator[Any]:
        """The per-layer subtrees of a params or cache tree in execution
        order (views into stacked periods)."""
        lay = self.layout
        yield from tree["prefix"]
        for i in range(lay.n_periods):
            for j in range(len(lay.period)):
                yield _index(tree["stack"][j], i)
        yield from tree["tail"]

    def _layers(self, params: Params, cache
                ) -> Iterator[Tuple[Params, LayerKind, Dict[str, Any]]]:
        """(layer params, kind, layer caches) in execution order."""
        return zip(self._walk(params), self.cfg.layer_kinds(),
                   self._walk(cache))

    def _layer_specs(self, specs) -> Iterator[Any]:
        """Each layer's subtree of the spec tree ``specs`` (of the params or
        of the dense cache) in execution order, a stacked period's without
        its period axis; None for every layer where ``specs`` is None."""
        lay = self.layout
        if specs is None:
            yield from itertools.repeat(None, self.cfg.n_layers)
            return
        yield from specs["prefix"]
        for _ in range(lay.n_periods):
            for j in range(len(lay.period)):
                yield _unstacked(specs["stack"][j])
        yield from specs["tail"]

    def _require_tokens(self, what: str) -> None:
        """The paged prefill and verify forwards' refusal of
        embedding-input archs: the JAX package embeds their tokens."""
        if self.cfg.input_mode != "tokens":
            raise ValueError(f"{what}: arch {self.cfg.name} takes "
                             f"{self.cfg.input_mode}; this forward embeds "
                             "tokens, as the JAX package's does")

    def _mrope_override(self, offsets: torch.Tensor, width: int
                        ) -> Optional[torch.Tensor]:
        """The JAX package's M-RoPE positions for a token-fed paged
        forward: ``offsets[b] + t`` on every axis, (B, width, 3); None for
        an arch without M-RoPE."""
        if not self.cfg.mrope_sections:
            return None
        pos = offsets[:, None].to(torch.int32) + torch.arange(
            width, dtype=torch.int32, device=offsets.device)[None, :]
        return pos[:, :, None].expand(
            -1, -1, len(self.cfg.mrope_sections))

    # ------------------------------ training / dense forward ---------
    def _positions(self, batch: Dict[str, torch.Tensor], b: int, s: int
                   ) -> torch.Tensor:
        """``batch["positions"]`` (B, S, 3) for an M-RoPE arch, else
        0..S-1 for every row (B, S)."""
        if self.cfg.mrope_sections:
            return batch["positions"]
        return torch.arange(s, dtype=torch.int32,
                            device=self.device)[None, :].expand(b, s)

    def _run_stack(self, params: Params, x: torch.Tensor,
                   positions: torch.Tensor, split=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Every layer in order; with ``opts.remat`` each layer is
        recomputed in the backward (``torch.utils.checkpoint``, as the
        JAX package's per-layer ``jax.checkpoint``); under
        ``remat_policy="dots"`` the recompute takes the layer's saved
        products from its ``dispatch.RematTape``.  ``split``: the model
        axis of the sharded train step (x in the residual's layout).
        Returns (x, the layers' aux losses summed in layer order)."""
        cfg, dt, opts, lay = self.cfg, self.dt, self.opts, self.layout

        auxes = []
        sharded = opts.sharding is not None
        specs = opts.sharding.specs if sharded else None
        extra = {"context_fn": dispatch.remat_contexts} \
            if opts.remat_policy == "dots" else {}

        def one(p, kind, x, spec):
            fn, args = layer_apply, (p, cfg, kind, x, positions, dt, opts,
                                     split)
            if sharded:
                fn, args = _gathered_layer, (p, spec) + args[1:]
            if opts.remat:
                x, aux = torch.utils.checkpoint.checkpoint(
                    fn, *args, use_reentrant=False, **extra)
            else:
                x, aux = fn(*args)
            if aux is not None:
                auxes.append(aux)
            return x

        def spec_of(group, i, stacked=False):
            if not sharded:
                return None
            return _unstacked(specs[group][i]) if stacked \
                else specs[group][i]

        for i, (p, kind) in enumerate(zip(params["prefix"], lay.prefix)):
            x = one(p, kind, x, spec_of("prefix", i))
        if lay.n_periods:
            periods = [_unbind(sub) for sub in params["stack"]]
            for i in range(lay.n_periods):
                for j, kind in enumerate(lay.period):
                    x = one(periods[j][i], kind, x,
                            spec_of("stack", j, stacked=True))
        for i, (p, kind) in enumerate(zip(params["tail"], lay.tail)):
            x = one(p, kind, x, spec_of("tail", i))
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for aux in auxes:
            aux_total = aux_total + aux
        return x, aux_total

    def _gather_top(self, params: Params, split=None) -> Params:
        """Under ``opts.sharding``: ``params`` with ``embed``, ``head`` and
        ``final_norm`` gathered over the batch axes, once (the tied
        ``embed`` serves the input and the head); the embedding and the
        head stay the rank's vocabulary rows on the model axis.  The
        layers are gathered at their use."""
        shd = self.opts.sharding
        if shd is None:
            return params
        out = dict(params)
        for k in ("embed", "head", "final_norm"):
            if k in params:
                out[k] = shd.gather_tree(
                    params[k], shd.specs[k],
                    partial=split is not None and split.partial)
        return out

    def _split(self, batch: Dict[str, torch.Tensor]):
        """The model axis of a forward over ``batch`` under
        ``opts.sharding`` (``TrainSharding.model_split``), or None."""
        shd = self.opts.sharding
        if shd is None:
            return None
        given = batch["embeddings"] if self.cfg.input_mode == "embeddings" \
            else batch["tokens"]
        shape = tuple(given.shape[:2]) + (self.cfg.d_model,)
        return shd.model_split(shape, self.opts.constrain,
                               self.opts.attn_constrain)

    def _head(self, params: Params) -> torch.Tensor:
        head = params["embed"].T if self.cfg.tie_embeddings \
            else params["head"]
        return head.to(self.dt.compute)

    def loss_fn(self, params: Params, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Mean next-token cross entropy of ``batch`` ("tokens" or
        "embeddings", "positions" for an M-RoPE arch, and "labels" (B, S)
        int) plus the MoE layers' load-balancing aux loss (0 without MoE
        layers).  Returns (loss, {"loss", "xent", "aux"}).  Under
        ``opts.sharding`` the xent is the mean over the ranks' rows, equal
        on every rank; a model axis of two or more ranks splits each
        layer's work (``layer_apply_split``), the lookup and the xent
        vocab-parallel."""
        split = self._split(batch)
        params = self._gather_top(params, split)
        x = self._embed(params, batch, split)
        b, s = batch["labels"].shape
        x, aux = self._run_stack(params, x, self._positions(batch, b, s),
                                 split)
        if split is not None:
            x = split.branch(x)
        x = layers.rmsnorm(params["final_norm"], x)
        xent = layers.chunked_xent(x, self._head(params), batch["labels"],
                                   n_chunks=min(self.opts.xent_chunks, s),
                                   split=split)
        if self.opts.sharding is not None:
            xent = self.opts.sharding.mean(xent)
        loss = xent + aux
        return loss, {"loss": loss, "xent": xent, "aux": aux}

    def _stack_out(self, params: Params, batch: Dict[str, torch.Tensor]):
        """(the stack's output, the model axis's split or None) of a
        forward over ``batch``; under ``opts.sharding`` each layer splits
        its work over the model axis as in ``loss_fn``, and the output is
        in the residual's layout."""
        split = self._split(batch)
        params = self._gather_top(params, split)
        x = self._embed(params, batch, split)
        given = batch["embeddings"] if self.cfg.input_mode == "embeddings" \
            else batch["tokens"]
        b, s = given.shape[:2]
        x, _ = self._run_stack(params, x, self._positions(batch, b, s),
                               split)
        return params, x, split

    def forward(self, params: Params, batch: Dict[str, torch.Tensor]
                ) -> torch.Tensor:
        """Full logits (B, S, V) of ``batch`` (its "tokens" or
        "embeddings", and "positions" for an M-RoPE arch; small-scale eval
        and tests)."""
        params, x, split = self._stack_out(params, batch)
        if split is not None:
            x = split.branch(x)
        return self._logits(params, x, split)

    def prefill(self, params: Params, batch: Dict[str, torch.Tensor],
                last_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Run the stack over the prompt and return only the last
        position's logits (B, V), or with ``last_idx`` (B,) those of
        position ``last_idx[b]`` of each row (the final norm and the head
        run on those rows alone).  Under ``opts.sharding`` (the dry run's
        prefill cell) ``params`` are this rank's shards and ``batch`` its
        rows: each layer splits its work over the model axis, as in
        ``loss_fn``, and the head runs on the rank's vocabulary columns,
        the logits gathered whole."""
        params, x, split = self._stack_out(params, batch)
        if split is not None and split.seq and last_idx is None:
            # the last row of the sequence: rank m - 1's block's last
            x = split.gather_whole((x[:, -1:], 1))[0]
        elif split is not None:
            x = split.branch(x)
        b, s = x.shape[:2]
        if last_idx is None:
            return self._logits(params, x[:, s - 1:], split)[:, 0]
        rows = torch.arange(b, device=x.device)
        return self._logits(params, x[rows, last_idx.long()][:, None],
                            split)[:, 0]

    # ------------------------------ paged serving ---------------------
    def init_paged_cache(self, slots: int, max_len: int, page_size: int,
                         total_pages: Optional[int] = None
                         ) -> Dict[str, Any]:
        """Per-attention-layer (P, page, Hkv, hd) pools of
        ``cfg.kv_dtype`` ("" = the compute dtype; "int8" adds (P, Hkv)
        fp32 scale leaves); stacked periods carry a leading period axis.  Physical page 0 is the TRASH page:
        the scheduler points inactive slots' tables at it, so their
        (masked, discarded) writes never land in a live sequence."""
        _require_paged(self.cfg)
        cfg, lay = self.cfg, self.layout
        dtype = kv_dtype_of(cfg.kv_dtype, self.dt.compute)
        if total_pages is None:
            total_pages = 1 + slots * (-(-max_len // page_size))

        def pools(lead=()):
            return layer_cache_init_paged(cfg, total_pages, page_size, dtype,
                                          self.device, lead)
        return {"prefix": [pools() for _ in lay.prefix],
                "stack": [pools((lay.n_periods,)) for _ in lay.period]
                if lay.n_periods else [],
                "tail": [pools() for _ in lay.tail]}

    def prefill_step_paged(self, params: Params, cache,
                           tokens: torch.Tensor, starts: torch.Tensor,
                           tables: torch.Tensor,
                           last_idx: torch.Tensor) -> torch.Tensor:
        """One page-aligned prompt chunk each of B DISTINCT slots through
        the stack, writing the chunks' K/V into ``cache`` in place.

        tokens: (B, C) with C == page size; starts: (B,) int32 chunk
        offsets; tables: (B, n_pages) int32; last_idx: (B,) index of the
        last REAL prompt token of each chunk.  Returns logits (B, V) at
        last_idx.  An M-RoPE arch rotates position ``starts[b] + t`` on
        every axis, as the JAX package does."""
        _require_paged(self.cfg)
        self._require_tokens("prefill_step_paged")
        x = self._embed(params, {"tokens": tokens})
        positions = self._mrope_override(starts, tokens.shape[1])
        for p, kind, c in self._layers(params, cache):
            x = layer_prefill_paged(p, self.cfg, kind, x, c, starts, tables,
                                    self.dt, positions, self.opts)
        rows = torch.arange(x.shape[0], device=x.device)
        x_last = x[rows, last_idx.long()][:, None]
        return self._logits(params, x_last)[:, 0]

    def decode_step(self, params: Params, cache,
                    tokens: Optional[torch.Tensor] = None, *,
                    pos: Optional[int] = None,
                    paged: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    embeddings: Optional[torch.Tensor] = None,
                    positions: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
        """One token for every slot; the caches are written in place.
        tokens: (B, 1), or for an embedding-input arch ``embeddings`` (B,
        1, d).  Returns logits (B, V).

        ``paged`` = (lengths (B,), table (B, n_pages)), both int32: every
        slot decodes at its own length against the shared page pools
        (``init_paged_cache``; attention stacks only).  Otherwise ``pos``
        is the position every slot decodes at, against the dense caches
        of ``init_cache`` (the recurrent archs' one layout).

        ``positions`` (B, 1, 3) int are an M-RoPE arch's rotary positions
        (ignored by other archs, as in the JAX package).  Left out, every
        axis takes the slot's decode position: what the JAX package's
        servers feed.

        Under ``opts.sharding`` (the dry run's layout) ``params`` are this
        rank's shards, gathered over the batch axes at their use, and the
        dense cache is this rank's block in ``MeshRules.cache_spec``'s
        layout (``TrainSharding.cache``): a model axis of two or more
        ranks splits each layer's work (``layer_decode_split``), the
        lookup and the head vocab-parallel, the logits gathered whole."""
        if (paged is None) == (pos is None):
            raise ValueError("decode_step takes pos= (dense cache) or "
                             "paged= (page pools), exactly one")
        if paged is not None:
            _require_paged(self.cfg)
        cfg = self.cfg
        given = embeddings if cfg.input_mode == "embeddings" else tokens
        if given is None:
            raise ValueError(f"decode_step: arch {cfg.name} takes "
                             f"{cfg.input_mode}")
        shd = self.opts.sharding
        split = self._split({cfg.input_mode: given})
        if split is not None and (paged is not None or shd.cache is None):
            raise ValueError("decode_step on a model axis takes the dense "
                             "cache laid out by TrainSharding.cache "
                             "(train_sharding(..., cache=))")
        params = self._gather_top(params, split)
        x = self._embed(params, {cfg.input_mode: given}, split)
        if not cfg.mrope_sections:
            positions = None
        elif positions is None:
            at = paged[0] if paged is not None else torch.full(
                (x.shape[0],), int(pos), dtype=torch.int32, device=x.device)
            positions = self._mrope_override(at, 1)
        # the dense caches' page tables, one a (cap, layout) a step
        views = {}
        for (p, kind, c), spec, c_spec in zip(
                self._layers(params, cache),
                self._layer_specs(shd.specs if shd else None),
                self._layer_specs(shd.cache if split else None)):
            if spec is not None:
                p = shd.gather_tree(
                    p, spec, keep_experts=self.opts.moe_mesh is not None)
            pages, kv = None, "whole"
            if paged is None and "k" in c:
                b, cap = c["k"].shape[:2]
                at = int(pos)
                if split is not None:
                    # the rank's block: its live slots, less one
                    kv = split.kv_layout(c_spec["k"])
                    at = split.stripe(at, cap, kv)[1] - 1
                if (cap, kv) not in views:
                    views[cap, kv] = layers.dense_pages(b, cap, at,
                                                        x.device)
                pages = views[cap, kv]
            x = layer_decode(p, cfg, kind, x, c, self.dt,
                             pos=None if pos is None else int(pos),
                             paged=paged, pages=pages, positions=positions,
                             opts=self.opts, split=split, kv=kv)
        return self._logits(params, x, split)[:, 0]

    def verify_step_paged(self, params: Params, cache, tokens: torch.Tensor,
                          lengths: torch.Tensor,
                          tables: torch.Tensor) -> torch.Tensor:
        """Score W candidate tokens each of B distinct slots: the
        speculative-decoding verify forward, writing their K/V into
        ``cache`` in place.

        tokens: (B, W) -- slot b's window ``[last_emitted, d1..d_{W-1}]``
        occupies positions ``lengths[b] + [0, W)`` (not page-aligned; the
        scheduler holds pages for the span).  Row t predicts the token at
        position ``lengths + t + 1``, so the caller needs logits at every
        row.  Returns logits (B, W, V).  An M-RoPE arch rotates position
        ``lengths[b] + t`` on every axis, as the JAX package does."""
        _require_paged(self.cfg)
        self._require_tokens("verify_step_paged")
        x = self._embed(params, {"tokens": tokens})
        positions = self._mrope_override(lengths, tokens.shape[1])
        for p, kind, c in self._layers(params, cache):
            x = layer_verify_paged(p, self.cfg, kind, x, c, lengths, tables,
                                   self.dt, positions, self.opts)
        return self._logits(params, x)

    # ------------------------------ dense serving ---------------------
    def init_cache(self, batch: int, max_len: int) -> Dict[str, Any]:
        """Dense per-layer decode state (``layer_cache_init``): K/V
        caches and token-shift and conv buffers in the compute dtype, the
        recurrent states in fp32; stacked periods carry a leading period
        axis."""
        cfg, lay = self.cfg, self.layout

        def caches(kind, lead=()):
            return layer_cache_init(cfg, kind, batch, max_len,
                                    self.dt.compute, self.device, lead)
        return {"prefix": [caches(k) for k in lay.prefix],
                "stack": [caches(k, (lay.n_periods,)) for k in lay.period]
                if lay.n_periods else [],
                "tail": [caches(k) for k in lay.tail]}

    def cache_specs(self, batch: int, max_len: int) -> Dict[str, Any]:
        """``init_cache``'s tree on ``meta`` (JAX's
        ``jax.eval_shape(init_cache)``)."""
        return Model(self.cfg, self.dt, "meta", self.opts).init_cache(
            batch, max_len)

    def leading_layers(self, params: Params, n: int) -> List[Params]:
        """The params of the first ``n`` layers in execution order (views
        into stacked periods)."""
        if n > self.cfg.n_layers:
            raise ValueError(f"{self.cfg.name} has {self.cfg.n_layers} "
                             f"layers, not {n}")
        return list(itertools.islice(self._walk(params), n))


class _ShapeGenerator(torch.Generator):
    """A generator that says it lives on ``meta``: the init functions
    allocate on ``gen.device`` and draw with ``gen``, and a draw into a
    ``meta`` tensor records its shape and draws nothing."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


# --------------------------------------------------------------------------
# parameter accounting
# --------------------------------------------------------------------------

def param_counts(cfg: ArchConfig) -> Dict[str, float]:
    """Exact counts from the ``meta`` param tree, with the JAX package's
    MODEL_FLOPS conventions: ``n_flops`` (N of 6*N*D) leaves out the
    gather-only input table and counts the LM head's matmul once, even
    when tied; ``n_active`` leaves out the experts a token does not
    reach."""
    return dict(_param_counts(cfg))


@functools.lru_cache(maxsize=None)
def _param_counts(cfg: ArchConfig) -> Dict[str, float]:
    specs = Model(cfg, device="meta").param_specs()
    total = sum(math.prod(leaf.shape) for leaf in tree_mod.leaves(specs))
    embed = cfg.vocab_size * cfg.d_model
    n_flops = total - (0 if cfg.tie_embeddings else embed)
    n_active = n_flops
    if cfg.n_experts:
        per_total, per_active = moe.moe_param_count(_moe_spec(cfg))
        n_moe_layers = sum(1 for k in cfg.layer_kinds() if k[1] == "moe")
        n_active = n_flops - n_moe_layers * (per_total - per_active)
    return {"total": total, "embed": embed,
            "n_flops": n_flops, "n_active": n_active}


def _cast(tree, dtype: torch.dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, dtype) for v in tree]
    return tree.to(dtype)
