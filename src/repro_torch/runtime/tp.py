"""Tensor-parallel paged serving: the port of ``repro/runtime/tp.py``.

The split is Megatron's, on the paged decode and prefill steps:

* q/k/v are column-parallel: each rank holds a contiguous block of heads
  (``wq`` sharded on its head axis), so the paged attention kernels run
  unchanged on a rank's heads against its slice of the KV page pools,
  and their outputs are all-gathered back to every head; ``wo`` stays
  replicated.
* The MLP's up projections are column-parallel; the down projection
  ``wd`` is row-parallel with one psum (int8 ``wd`` shards carry scales
  of their own K slice: they are quantized after sharding).
* The embedding, the norms, the head and the MoE layers stay replicated.
* MQA (``n_kv_heads == 1``): the pools and ``wk``/``wv`` replicate and
  only the q heads shard.

The ops declare these contracts in ``kernels/registry.py`` (their
``OpSpec.tp``, which ``dispatch.TP_CONTRACTS`` reads); the layers tag
their calls, and the tags act only
inside ``dispatch.tp_scope``, which ``sharded_paged_fns`` opens around
the model's steps.  JAX runs the step under ``shard_map`` (through its
``runtime/compat.py`` shim); here each rank runs it on its own shards,
so there is no counterpart of that shim.  The host's page metadata
(allocator, tables, prefix trie) is the same on every rank; pages never
cross ranks.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from ..kernels import dispatch

AXIS = "model"


def tp_error(cfg, tp: int) -> Optional[str]:
    """Why this arch cannot serve at tensor-parallel degree ``tp`` (None:
    it can).  tp == 1 is always supported (the degenerate mesh)."""
    if tp <= 1:
        return None
    from ..models.transformer import paged_supported
    if not paged_supported(cfg):
        return f"{cfg.name}: paged serving requires attention-only stacks"
    if cfg.n_heads % tp:
        return f"{cfg.name}: n_heads={cfg.n_heads} not divisible by tp={tp}"
    if cfg.n_kv_heads != 1 and cfg.n_kv_heads % tp:
        return (f"{cfg.name}: n_kv_heads={cfg.n_kv_heads} not divisible by "
                f"tp={tp} (only MQA n_kv_heads=1 replicates)")
    if any(f == "mlp" for _, f in cfg.layer_kinds()) and cfg.d_ff % tp:
        return f"{cfg.name}: d_ff={cfg.d_ff} not divisible by tp={tp}"
    return None


def kv_sharded(cfg, tp: int) -> bool:
    """Do the KV page pools shard over the mesh (False: MQA replicates)?"""
    return tp > 1 and cfg.n_kv_heads % tp == 0


# --------------------------------------------------------------------------
# shard plans: a tree of specs, each a tuple with the axis name at the
# sharded dim and None elsewhere, or () for a replicated leaf (JAX's
# PartitionSpec); dims count from the trailing end, so a stacked period
# axis in front does not move them
# --------------------------------------------------------------------------

def _dim_spec(ndim: int, d: int, axis: str) -> Tuple:
    spec = [None] * ndim
    spec[d] = axis
    return tuple(spec)


def map_named(fn, tree, names=()):
    """``fn(dict keys on the path, leaf)`` over a tree of dicts and lists
    (list indices are not names, as JAX's ``DictKey`` paths skip them)."""
    if isinstance(tree, dict):
        return {k: map_named(fn, v, names + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_named(fn, v, names) for v in tree]
    return fn(names, tree)


def param_pspecs(params, cfg, tp: int, *, axis: str = AXIS):
    """The spec tree of a ``Model.init`` params tree: ``wq`` (d, H, hd)
    and its bias (H, hd) shard ndim-2 (and ``wk``/``wv``/``bk``/``bv``
    when the pools shard); ``wg``/``wu``/``wi`` (d, ff) ndim-1; ``wd``
    (ff, d) ndim-2.  Everything else replicates."""
    kv = kv_sharded(cfg, tp)

    def spec(names, leaf):
        name = names[-1] if names else ""
        if "attn" in names:
            if name in ("wq", "bq") or (kv and name in ("wk", "wv", "bk",
                                                        "bv")):
                return _dim_spec(leaf.dim(), leaf.dim() - 2, axis)
            return ()
        if "mlp" in names:
            if name in ("wg", "wu", "wi"):
                return _dim_spec(leaf.dim(), leaf.dim() - 1, axis)
            if name == "wd":
                return _dim_spec(leaf.dim(), leaf.dim() - 2, axis)
        return ()
    return map_named(spec, params)


def cache_pspecs(cache, cfg, tp: int, *, axis: str = AXIS):
    """The spec tree of a ``Model.init_paged_cache`` tree: pools (P, page,
    Hkv, hd) shard ndim-2, scales (P, Hkv) ndim-1, or everything
    replicates under MQA and at tp == 1."""
    kv = kv_sharded(cfg, tp)

    def spec(names, leaf):
        name = names[-1] if names else ""
        if kv and name in ("k_pages", "v_pages"):
            return _dim_spec(leaf.dim(), leaf.dim() - 2, axis)
        if kv and name in ("k_scale", "v_scale"):
            return _dim_spec(leaf.dim(), leaf.dim() - 1, axis)
        return ()
    return map_named(spec, cache)


def shard_leaf(leaf: torch.Tensor, spec: Tuple, mesh) -> torch.Tensor:
    """This rank's slice of ``leaf`` under ``spec`` (an entry per dim: an
    axis name, a tuple of names, or None), as a contiguous tensor on the
    mesh's device (a strided view would reach the kernels' TMA
    descriptors)."""
    out = leaf
    for d, axes in enumerate(spec):
        if axes is not None:
            out = mesh.group(axes).chunk(out, d)
    return out.to(mesh.device).contiguous()


def shard_tree(tree, specs, mesh):
    """``shard_leaf`` over a tree and its spec tree."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [shard_tree(v, s, mesh) for v, s in zip(tree, specs)]
    return shard_leaf(tree, specs, mesh)


def shard_params(params, cfg, mesh, *, axis: str = AXIS):
    """This rank's tensor-parallel shards of a float params tree."""
    return shard_tree(params, param_pspecs(params, cfg, mesh.shape[axis],
                                           axis=axis), mesh)


def shard_cache(cache, cfg, mesh, *, axis: str = AXIS):
    """This rank's slices of a paged cache tree."""
    return shard_tree(cache, cache_pspecs(cache, cfg, mesh.shape[axis],
                                          axis=axis), mesh)


# --------------------------------------------------------------------------
# the sharded steps
# --------------------------------------------------------------------------

def sharded_paged_fns(model, mesh, *, axis: str = AXIS):
    """(decode_fn, prefill_fn): the model's paged steps on this rank's
    shards (``shard_params`` / ``shard_cache``) inside
    ``dispatch.tp_scope``.  They take ``Model.decode_step``'s and
    ``Model.prefill_step_paged``'s arguments and return the replicated
    logits (equal bits on every rank); the cache slices are written in
    place."""
    err = tp_error(model.cfg, mesh.shape[axis])
    if err:
        raise ValueError(err)
    group = mesh.group(axis)

    def decode(params, cache, tokens, **kw) -> Any:
        with dispatch.tp_scope(group):
            return model.decode_step(params, cache, tokens, **kw)

    def prefill(params, cache, *args) -> Any:
        with dispatch.tp_scope(group):
            return model.prefill_step_paged(params, cache, *args)
    return decode, prefill
