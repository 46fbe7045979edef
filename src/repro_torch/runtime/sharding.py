"""Sharding rules: DP / FSDP / TP / EP mapped onto a mesh of ranks -- the
port of ``repro/runtime/sharding.py``.

The rules are the JAX package's, leaf for leaf: the ``model`` axis
stripes the parallel dimensions (heads, FFN hidden, experts, vocab), the
``data`` (+ ``pod``) axes stripe the batch and, with ``fsdp``, the
weights and optimizer moments (ZeRO-3); small leaves replicate.  Rules
are divisibility-guarded: a dim is sharded only where the axis size
divides it, and an axis of size 1 shards nothing.

A spec is a :class:`P`, one entry per dim: an axis name, a tuple of
names, or None (JAX's ``PartitionSpec``).  ``tree_specs`` gives a state
tree's spec tree by the leaves' paths, which are the strings JAX builds
(list indices kept, ``AdamWState``'s ``count``/``m``/``v``,
``QuantizedBlock``'s ``q``/``scale``).

JAX lays the state out with ``device_put`` and lets GSPMD choose the
collectives.  Here each rank stores its shards (``shard_state``) and
:class:`TrainSharding` says how the train step uses them: a leaf is
gathered at its use over the axes that split the batch (FSDP), with the
transpose its axes need, and used as its shard on ``model``, whose
ranks split the layer's work (``runtime/model_axis.py``); so its
gradient comes back in the stored layout.  ``gather_state`` brings
whole leaves back, one at a time; ``tp.shard_leaf`` cuts one.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch

from ..core import tree as tree_mod
from ..core.memory import QuantizedBlock, dequantize_block, quantize_block
from . import collectives as coll
from .tp import shard_leaf

Axis = Union[None, str, Tuple[str, ...]]
DATA_AXES = ("pod", "data")


class P(tuple):
    """A leaf's partition spec: for each dim an axis name, a tuple of
    names, or None (a one-name tuple is the name, as in JAX)."""

    def __new__(cls, *axes):
        return super().__new__(cls, (a[0] if isinstance(a, tuple)
                                     and len(a) == 1 else a for a in axes))

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


def is_spec(x) -> bool:
    return isinstance(x, P)


def _names(entry: Axis) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True)
class MeshRules:
    """The rules over ``mesh`` (``launch/mesh.Mesh``, or anything with its
    ``shape`` dict and ``axes``), with JAX's two knobs that only
    ``launch/{perf,dryrun}.py`` set: ``stripe_embed`` (the embedding and
    the head also stripe d over the FSDP axes) and ``attn_prefer_seq``
    (``attn_spec``: q/k/v stay sequence-striped at attention entry)."""
    mesh: Any
    dp_axes: Tuple[str, ...]              # ("pod", "data") or ("data",)
    model_axis: str = "model"
    fsdp: bool = True
    fsdp_axes: Tuple[str, ...] = ("data",)
    ep_axes: Tuple[str, ...] = ("model",)
    stripe_embed: bool = True
    attn_prefer_seq: bool = False

    @property
    def fsdp_axis(self) -> Axis:
        if not self.fsdp:
            return None
        return self.fsdp_axes if len(self.fsdp_axes) > 1 \
            else self.fsdp_axes[0]

    def axis_size(self, name: Axis) -> int:
        if name is None:
            return 1
        if isinstance(name, tuple):
            return math.prod(self.mesh.shape[a] for a in name)
        return self.mesh.shape[name]

    def _fit(self, dim: int, axis: Axis) -> Axis:
        size = self.axis_size(axis)
        if axis is None or size == 1 or dim % size != 0:
            return None
        return axis

    def spec_for(self, path: str, shape: Tuple[int, ...]) -> P:
        """The spec of a parameter leaf, by its tree path."""
        model, fsdp = self.model_axis, self.fsdp_axis
        stacked = ".stack." in path or path.startswith("stack.")
        base = shape[1:] if stacked else shape

        def out(*axes):
            axes = list(axes) + [None] * (len(base) - len(axes))
            axes = [self._fit(d, a) for d, a in zip(base, axes)]
            if stacked:
                axes = [None] + axes
            return P(*axes)

        name = path.rsplit(".", 1)[-1]
        if name == "embed":
            return out(model, fsdp if self.stripe_embed else None)  # (V, d)
        if name == "head":
            return out(fsdp if self.stripe_embed else None, model)  # (d, V)
        if ".attn." in path:
            if name in ("wq", "wk", "wv"):
                # prefer TP on heads; MQA/GQA fall back to head_dim
                if base[1] % self.axis_size(model) == 0:
                    return out(fsdp, model, None)      # (d, H, hd)
                return out(fsdp, None, model)
            if name == "wo":
                if base[0] % self.axis_size(model) == 0:
                    return out(model, None, fsdp)      # (H, hd, d)
                return out(None, model, fsdp)
            if name in ("bq", "bk", "bv"):
                return out(model, None)                # (H, hd)
        if ".mlp." in path or ".shared." in path or ".cm." in path:
            if name in ("wg", "wu", "wi", "wk"):
                return out(fsdp, model)                # (d, ff)
            if name in ("wd", "wv"):
                return out(model, fsdp)                # (ff, d)
            if name == "wr":
                return out(fsdp, model)                # (d, d)
        if ".moe." in path:
            # moe_sharded's layout: experts over the EP axes, d_expert
            # over ``data``
            ep = self.ep_axes if len(self.ep_axes) > 1 else self.ep_axes[0]
            if name in ("wg", "wu"):
                return out(ep, None, "data")           # (E, d, f)
            if name == "wd":
                return out(ep, "data", None)           # (E, f, d)
            if name == "router":
                return out(None, None)                 # (d, E)
        if ".tm." in path:                             # rwkv time mix
            if name in ("wr", "wk", "wv", "wg"):
                return out(fsdp, model)                # (d, d)
            if name == "wo":
                return out(model, fsdp)
            if name == "wa":
                return out(fsdp, None)                 # (d, lora)
            if name == "wb":
                return out(None, model)                # (lora, d)
            if name == "u":
                return out(model, None)                # (H, hd)
        if ".rec." in path:                            # griffin
            if name in ("w_main", "w_gate"):
                return out(fsdp, model)                # (d, lru)
            if name == "w_out":
                return out(model, fsdp)                # (lru, d)
            if name in ("wa", "wx"):
                return out(model, None, None)          # (nb, bw, bw)
            if name == "conv_w":
                return out(None, model)                # (K, lru)
            if name in ("lam", "ba", "bx", "conv_b"):
                return out(model)                      # (lru,)
        # norms, mu, scalars, everything small: replicate
        return P(*([None] * len(shape)))

    def batch_spec(self, shape: Tuple[int, ...]) -> P:
        dp: Axis = self.dp_axes
        if shape[0] % self.axis_size(dp) != 0:
            # the intra-pod data axis alone, else replicate (batch 1)
            dp = "data" if shape[0] % self.axis_size("data") == 0 else None
        return P(*([dp] + [None] * (len(shape) - 1)))

    def activation_spec(self, shape: Tuple[int, ...]) -> Optional[P]:
        """Residual stream (B, S, d): batch over DP, sequence over model
        (Megatron-SP striping).  None if nothing fits."""
        if len(shape) != 3:
            return None
        dp: Axis = self.dp_axes
        if shape[0] % self.axis_size(dp) != 0:
            dp = None
        seq = self.model_axis \
            if shape[1] % self.axis_size(self.model_axis) == 0 \
            and shape[1] > 1 else None
        if dp is None and seq is None:
            return None
        return P(dp, seq, None)

    def attn_spec(self, shape: Tuple[int, ...], role: str) -> Optional[P]:
        """q (``role`` "q") or k/v (B, S, H, hd) at attention entry (JAX's
        ``attn_hook``, the Megatron SP -> TP transition): heads over
        ``model`` where they divide it; else q over the sequence (its rows
        are independent) and k/v replicated; under ``attn_prefer_seq``
        (and a sequence that splits) q over the sequence with every head,
        k/v replicated.  None for anything not 4-D."""
        if len(shape) != 4:
            return None
        model = self.model_axis
        msz = self.axis_size(model)
        b, sq, h, _ = shape
        dp: Axis = self.dp_axes if b % self.axis_size(self.dp_axes) == 0 \
            else ("data" if b % self.axis_size("data") == 0 else None)
        seq_ok = sq > 1 and sq % msz == 0
        if self.attn_prefer_seq and seq_ok:
            return P(dp, model, None, None) if role == "q" \
                else P(dp, None, None, None)
        if h % msz == 0:
            return P(dp, None, model, None)
        if role == "q" and seq_ok:
            return P(dp, model, None, None)
        return P(dp, None, None, None)

    def cache_spec(self, path: str, shape: Tuple[int, ...]) -> P:
        """KV/state caches: batch over DP; heads (or sequence) over
        model."""
        stacked = ".stack." in path or path.startswith("stack.")
        base = shape[1:] if stacked else shape
        name = path.rsplit(".", 1)[-1]
        dp: Axis = self.dp_axes
        if base[0] % self.axis_size(dp) != 0:
            dp = "data" if base[0] % self.axis_size("data") == 0 else None
        axes: list = [dp] + [None] * (len(base) - 1)
        model = self.model_axis
        msz = self.axis_size(model)
        if name in ("k", "v") and len(base) == 4:      # (B, S, Hkv, hd)
            if base[2] % msz == 0:
                axes[2] = model
            elif base[1] % msz == 0:
                axes[1] = model                        # flash-decode S-shard
        elif name == "state" and len(base) == 4:       # rwkv (B, H, k, v)
            if base[1] % msz == 0:
                axes[1] = model
        elif name == "h" and len(base) == 2:           # rglru (B, lru)
            if base[1] % msz == 0:
                axes[1] = model
        elif name == "conv" and len(base) == 3:        # (B, K-1, lru)
            if base[2] % msz == 0:
                axes[2] = model
        elif name in ("xprev", "cm_xprev") and len(base) == 2:
            if base[1] % msz == 0:
                axes[1] = model
        if stacked:
            axes = [None] + axes
        return P(*axes)


def make_rules(mesh, *, fsdp: bool = True,
               fsdp_axes: Optional[Tuple[str, ...]] = None,
               ep_axes: Optional[Tuple[str, ...]] = None) -> MeshRules:
    names = tuple(mesh.axes)
    dp = tuple(a for a in names if a in DATA_AXES)
    fsdp_axes = tuple(a for a in (fsdp_axes or ("data",)) if a in names)
    ep_axes = tuple(a for a in (ep_axes or ("model",)) if a in names)
    return MeshRules(mesh=mesh, dp_axes=dp, fsdp=fsdp,
                     fsdp_axes=fsdp_axes or ("data",),
                     ep_axes=ep_axes or ("model",))


# --------------------------------------------------------------------------
# tree -> specs
# --------------------------------------------------------------------------

def _children(node) -> Optional[List[Tuple[str, Any]]]:
    """(path part, child) pairs of a node in ``core.tree``'s order, the
    parts JAX's key paths print; None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, QuantizedBlock):
        return [("q", node.q), ("scale", node.scale)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def map_with_path(fn: Callable[[str, Any], Any], tree: Any,
                  path: str = "") -> Any:
    """``fn(path, leaf)`` over a tree, in a tree of its structure; the
    path is JAX's ``_path_str`` of the leaf's key path."""
    kids = _children(tree)
    if kids is None:
        return fn(path, tree)
    out = [map_with_path(fn, v, f"{path}.{k}" if path else k)
           for k, v in kids]
    if isinstance(tree, dict):
        return dict(zip((k for k, _ in kids), out))
    if isinstance(tree, QuantizedBlock):
        return QuantizedBlock(out[0], out[1], tree.block)
    if hasattr(tree, "_fields"):
        return type(tree)(*out)
    return type(tree)(out)


def leaf_paths(tree: Any) -> List[str]:
    """The paths of ``tree``'s leaves, in ``core.tree``'s order."""
    paths: List[str] = []
    map_with_path(lambda p, x: paths.append(p), tree)
    return paths


def tree_specs(rules: MeshRules, tree: Any, kind: str = "param") -> Any:
    """The spec of every leaf of a tree of global-shaped leaves (anything
    with a ``shape``); JAX's ``tree_shardings``.

    kind: "param" | "batch" | "cache".  Optimizer moments reuse the param
    rules; a ``QuantizedBlock``'s ``q`` keeps the param's shape and spec,
    its ``scale`` (blocks along the last axis) takes the param's rule at
    its own shape."""

    return map_with_path(
        lambda path, x: leaf_spec(rules, path, tuple(x.shape), kind), tree)


def leaf_spec(rules: MeshRules, path: str, shape: Tuple[int, ...],
              kind: str = "param") -> P:
    """One leaf's spec in ``tree_specs``."""
    if kind == "batch":
        return rules.batch_spec(shape)
    if kind == "cache":
        return rules.cache_spec(path, shape)
    if path.endswith(".scale"):
        return rules.spec_for(path[: -len(".scale")], shape)
    return rules.spec_for(path[:-2] if path.endswith(".q") else path, shape)


def replicated(rules: MeshRules, tree: Any) -> Any:
    return map_with_path(lambda p, x: P(), tree)


def spec_leaves(specs: Any) -> List[P]:
    return tree_mod.leaves(specs, is_spec)


def sharded_axes(spec: P, mesh) -> Tuple[str, ...]:
    """The axes (of size > 1) ``spec`` shards on, in mesh order."""
    used = {a for entry in spec for a in _names(entry)}
    return tuple(a for a in mesh.axes if a in used and mesh.shape[a] > 1)


def _dim_axes(spec: P, mesh) -> List[Tuple[int, Tuple[str, ...]]]:
    """(dim, the axes of size > 1 that split it) for each split dim."""
    out = []
    for d, entry in enumerate(spec):
        names = tuple(a for a in _names(entry) if mesh.shape[a] > 1)
        if names:
            out.append((d, names))
    return out


def global_shape(shape, spec: P, mesh) -> Tuple[int, ...]:
    """The whole leaf's shape of a shard of ``shape`` under ``spec``."""
    shape = list(shape)
    for d, names in _dim_axes(spec, mesh):
        shape[d] *= math.prod(mesh.shape[a] for a in names)
    return tuple(shape)


def global_like(tree: Any, specs: Any, mesh) -> Any:
    """A tree of ``meta`` tensors of the whole leaves' shapes and dtypes
    of a sharded tree (what ``tree_specs`` and ``restore_on_mesh``
    read)."""
    flat, rebuild = tree_mod.flatten(tree)
    return rebuild([torch.empty(global_shape(x.shape, s, mesh),
                                dtype=x.dtype, device="meta")
                    for x, s in zip(flat, spec_leaves(specs))])


def gather_leaf(leaf: torch.Tensor, spec: P, mesh,
                device=None) -> torch.Tensor:
    """The whole leaf from every rank's block, as a new tensor (on
    ``device``, default the block's); not differentiable.  Under gloo a
    block bound for the host is gathered there (no round trip through
    the card)."""
    out = leaf
    if device is not None and mesh.backend != "nccl":
        out = out.to(device)
    for d, names in _dim_axes(spec, mesh):
        out = mesh.group(names).all_gather(out, d)
    if device is not None:
        out = out.to(device)
    return out.clone() if out is leaf else out


def shard_state(tree: Any, specs: Any, mesh) -> Any:
    """This rank's blocks of a tree of whole leaves (JAX's ``device_put``
    with a sharding)."""
    flat, rebuild = tree_mod.flatten(tree)
    return rebuild([shard_leaf(x, s, mesh) if isinstance(x, torch.Tensor)
                    else x for x, s in zip(flat, spec_leaves(specs))])


def gather_state(tree: Any, specs: Any, mesh, device=None) -> Any:
    """The whole leaves of a sharded tree, new tensors gathered leaf by
    leaf (under gloo a CUDA leaf goes through host memory;
    ``device="cpu"`` keeps the whole leaves there)."""
    flat, rebuild = tree_mod.flatten(tree)
    return rebuild([gather_leaf(x, s, mesh, device)
                    if isinstance(x, torch.Tensor) else x
                    for x, s in zip(flat, spec_leaves(specs))])


# --------------------------------------------------------------------------
# block quantization of shards (int8 moments, gradient compression)
# --------------------------------------------------------------------------

def _last_group(spec: P, ndim: int, mesh):
    """The group that splits the last dim, or None."""
    if ndim == 0 or len(spec) < ndim:
        return None
    names = tuple(a for a in _names(spec[ndim - 1]) if mesh.shape[a] > 1)
    return mesh.group(names) if names else None


def quantize_shard(x: torch.Tensor, block: int, spec: P, scale_spec: P,
                   mesh) -> QuantizedBlock:
    """``quantize_block`` of the whole leaf, as this rank's blocks: the
    shard's own blocks where its last dim is whole or splits on block
    edges, else the last dim gathered, quantized and cut again (q by
    ``spec``, the scales by ``scale_spec``)."""
    group = _last_group(spec, x.dim(), mesh)
    if group is None or x.shape[-1] % block == 0:
        return quantize_block(x, block)
    d = x.dim() - 1
    qb = quantize_block(group.all_gather(x, d), block)
    sgroup = _last_group(scale_spec, qb.scale.dim(), mesh)
    scale = qb.scale if sgroup is None else sgroup.chunk(qb.scale, d)
    return QuantizedBlock(group.chunk(qb.q, d), scale.contiguous(), block)


def dequantize_shard(qb: QuantizedBlock, spec: P, scale_spec: P,
                     mesh) -> torch.Tensor:
    """This rank's block of the whole leaf's ``dequantize_block``
    (``quantize_shard``'s inverse)."""
    group = _last_group(spec, qb.q.dim(), mesh)
    if group is None or qb.q.shape[-1] % qb.block == 0:
        return dequantize_block(qb)
    d = qb.q.dim() - 1
    sgroup = _last_group(scale_spec, qb.scale.dim(), mesh)
    scale = qb.scale if sgroup is None else sgroup.all_gather(qb.scale, d)
    whole = dequantize_block(QuantizedBlock(group.all_gather(qb.q, d),
                                            scale, qb.block))
    return group.chunk(whole, d)


# --------------------------------------------------------------------------
# the sharded train step's layout
# --------------------------------------------------------------------------

def batch_axes(rules: MeshRules, rows: int) -> Tuple[str, ...]:
    """The mesh axes (of size > 1) that split a batch of ``rows`` rows
    (``batch_spec``'s first entry)."""
    names = _names(rules.batch_spec((rows,))[0])
    return tuple(a for a in names if rules.axis_size(a) > 1)


# leaves gathered whole over the model axis by ``TrainSharding.gather``
# (a dim split over the model axis together with another axis outside
# the batch's) since the last reset: the steps split the model axis's
# work, so this stays 0
_MODEL_GATHERS = [0]


def model_gathers() -> int:
    return _MODEL_GATHERS[0]


def reset_model_gathers() -> None:
    _MODEL_GATHERS[0] = 0


@dataclasses.dataclass(frozen=True, eq=False)
class TrainSharding:
    """How the sharded steps store and use the params (the port's
    ``grad_shardings``): ``specs`` is the params' spec tree
    (``tree_specs``), ``paths`` their leaf paths, ``batch`` the axes that
    split each (micro)batch's rows, and ``cache`` the dense decode
    cache's spec tree (``tree_specs(kind="cache")``, JAX's
    ``MeshRules.cache_spec``) for the decode step, or None.

    Every leaf is stored as its shard and gathered at its use over the
    axes that split the batch with ``gather_shards`` (its backward
    reduce-scatters the ranks' parts of the gradient); a leaf not split
    over a batch axis goes through ``broadcast`` there (the backward adds
    the ranks' parts).  On the model axis the leaf stays the rank's
    shard: the ranks split the layer's work (``runtime/model_axis.py``),
    each shard's gradient is its rank's own, and a replicated leaf's is
    whole on every rank, or (``partial``, the striped layout) the rank's
    part, added over ``model``.  So the gradients come back in the stored
    layout, with the bits of a rank-ordered sum.

    The serving steps (the dry run's prefill and decode cells) use the
    same layout under ``torch.no_grad``: the prefill splits each layer's
    work as the train step's forward does, and the decode step runs on
    the rank's shards and its block of the cache
    (``models/transformer.layer_decode_split``)."""
    rules: MeshRules
    specs: Any
    paths: Tuple[str, ...]
    batch: Tuple[str, ...]
    cache: Any = None

    @property
    def mesh(self):
        return self.rules.mesh

    @property
    def model_size(self) -> int:
        return self.mesh.shape.get(self.rules.model_axis, 1)

    @functools.cached_property
    def leaf_specs(self) -> List[P]:
        """The specs in ``core.tree``'s leaf order."""
        return spec_leaves(self.specs)

    def gather(self, t: torch.Tensor, spec: P, keep: bool = False,
               partial: bool = False) -> torch.Tensor:
        """Shard ``t`` at its use: gathered over the batch axes, the
        rank's shard on ``model`` (``keep``: the shard itself, for the
        expert leaves ``moe_apply_sharded`` takes as shards), with the
        transposes above; with ``partial``
        (the model axis's striped layout, where a rank's gradient of a
        leaf replicated over ``model`` is its part) such a leaf also goes
        through ``broadcast`` over ``model``."""
        mesh, model = self.mesh, self.rules.model_axis
        split_on = sharded_axes(spec, mesh)
        rest = tuple(a for a in self.batch if a not in split_on)
        if partial and self.model_size > 1 and model not in split_on:
            rest = tuple(a for a in mesh.axes if a in rest + (model,))
        if rest:
            t = coll.broadcast(t, mesh.group(rest))
        if keep:
            return t
        dims = _dim_axes(spec, mesh)
        # the batch axes' gathers first, so their reduce-scatters run on
        # the smaller cotangent
        for d, names in sorted(dims, key=lambda dn: not set(dn[1])
                               <= set(self.batch)):
            group = mesh.group(names)
            if set(names) <= set(self.batch):
                t = coll.gather_shards(t, group, d)
            elif names == (model,):
                continue
            elif set(names).isdisjoint(self.batch):
                if model in names:
                    _MODEL_GATHERS[0] += 1
                t = coll.unsplit(t, group, d)
            else:
                raise ValueError(f"dim {d} of spec {spec} mixes batch and "
                                 f"model axes ({self.batch})")
        return t

    def gather_tree(self, tree: Any, specs: Any, keep_experts: bool = False,
                    partial: bool = False) -> Any:
        """``gather`` over a (layer's) subtree and its spec tree; with
        ``keep_experts`` a MoE layer's expert leaves stay shards."""
        def walk(node, spec, names):
            if isinstance(node, dict):
                return {k: walk(v, spec[k], names + (k,))
                        for k, v in node.items()}
            keep = keep_experts and "moe" in names \
                and "shared" not in names and names[-1] in ("wg", "wu",
                                                             "wd")
            return self.gather(node, spec, keep, partial)
        return walk(tree, specs, ())

    def model_split(self, shape: Tuple[int, ...], constrain=None,
                    attn_constrain=None):
        """The ``model_axis.ModelSplit`` of a forward whose residual stream
        is (B, S, d) ``shape`` on this layout (None without a model axis
        of two or more ranks): the residual striped over the sequence
        where ``constrain`` (JAX's ``make_constrain``: a (B, S, d) shape's
        spec, or None) puts S on ``model``, else replicated; attention
        laid out by ``attn_constrain`` (JAX's ``attn_hook``: a q/k/v
        shape's spec; default ``MeshRules.attn_spec``)."""
        if self.model_size <= 1:
            return None
        from .model_axis import ModelSplit
        model = self.rules.model_axis
        spec = constrain(tuple(shape)) if constrain is not None else None
        seq = spec is not None and model in _names(spec[1])
        return ModelSplit(self.mesh.group(model), seq=seq,
                          attn=attn_constrain or self.rules.attn_spec,
                          model_axis=model)

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean over the batch axes of a per-rank value (the loss);
        the backward gives each rank its share."""
        if not self.batch:
            return t
        return coll.pmean(t, self.mesh.group(self.batch))

    def split_batch(self, batch: Dict[str, torch.Tensor],
                    microbatches: int = 1) -> Dict[str, torch.Tensor]:
        """This rank's rows of a whole batch: each microbatch's rows
        split over the batch axes (as JAX splits each microbatch of the
        global batch), the rank's parts of the microbatches in order."""
        if not self.batch:
            return batch
        group = self.mesh.group(self.batch)

        def cut(v):
            mb = v.reshape((microbatches, v.shape[0] // microbatches)
                           + v.shape[1:])
            return group.chunk(mb, 1).reshape((-1,) + v.shape[1:])
        return {k: cut(v) for k, v in batch.items()}

    def norm_sq(self, leaves: List[torch.Tensor]) -> List[torch.Tensor]:
        """Each leaf's sum of squares over the whole leaf, in fp32: the
        shard's own, added over the axes the leaf is split on (one psum
        per set of axes, rank order: the same bits on every rank)."""
        mesh = self.mesh
        sums = [g.float().square().sum() for g in leaves]
        by_axes: Dict[Tuple[str, ...], List[int]] = {}
        for i, spec in enumerate(self.leaf_specs):
            axes = sharded_axes(spec, mesh)
            if axes:
                by_axes.setdefault(axes, []).append(i)
        for axes, idx in by_axes.items():
            total = mesh.group(axes).psum(torch.stack([sums[i]
                                                       for i in idx]))
            for j, i in enumerate(idx):
                sums[i] = total[j]
        return sums

    def numel(self, i: int, t: torch.Tensor) -> int:
        """The whole leaf's element count of leaf ``i``'s shard ``t``."""
        return math.prod(global_shape(t.shape, self.leaf_specs[i],
                                      self.mesh))

    def scale_spec(self, i: int, t: torch.Tensor, block: int) -> P:
        """The spec of leaf ``i``'s block scales (``tree_specs`` of a
        ``QuantizedBlock``), from its shard ``t``."""
        shape = global_shape(t.shape, self.leaf_specs[i], self.mesh)
        if not shape:
            shape = (1,)
        scale = shape[:-1] + (-(-shape[-1] // block),)
        return self.rules.spec_for(self.paths[i], scale)

    def quantize(self, i: int, x: torch.Tensor, block: int
                 ) -> QuantizedBlock:
        spec = self.leaf_specs[i]
        return quantize_shard(x, block, spec,
                              self.scale_spec(i, x, block), self.mesh)

    def dequantize(self, i: int, qb: QuantizedBlock) -> torch.Tensor:
        spec = self.leaf_specs[i]
        return dequantize_shard(qb, spec,
                                self.scale_spec(i, qb.q, qb.block),
                                self.mesh)


def train_sharding(rules: MeshRules, params: Any, rows: int,
                   cache: Any = None) -> TrainSharding:
    """The layout of a whole (global-shaped) params tree on
    ``rules.mesh``, for (micro)batches of ``rows`` rows; ``cache``: a
    whole dense decode cache tree (``Model.cache_specs``) whose blocks the
    decode step takes."""
    return TrainSharding(rules, tree_specs(rules, params),
                         tuple(leaf_paths(params)), batch_axes(rules, rows),
                         None if cache is None
                         else tree_specs(rules, cache, kind="cache"))
