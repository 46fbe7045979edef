"""Params of the JAX package's ``Model.init`` as the port's params.

The JAX tree (``repro/models/transformer.py::Model.init``), handed over
as numpy arrays, maps one to one: same keys, same ``prefix``/``stack``/
``tail`` nesting, same leading period axis on stacked layers (a MoE
layer's ``moe`` subtree, its ``router``, stacked experts ``wg``/``wu``/
``wd`` and ``shared`` MLP, included, also with its experts padded by
``ExecOptions.expert_pad``).  The JAX tree is mesh-free (global arrays);
``shards_from_jax`` slices it into one rank's shards.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .core.device import DeviceLike, resolve_device


def params_from_jax(tree: Any, device: DeviceLike,
                    dtype: torch.dtype) -> Any:
    """Nested dicts/lists of numpy arrays -> the same nesting of torch
    tensors of ``dtype`` on ``device``."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        # via fp32: numpy has no bfloat16 of its own
        arr = np.asarray(node, dtype=np.float32)
        return torch.from_numpy(arr.copy()).to(device=dev, dtype=dtype)
    return conv(tree)


def dense_cache_from_jax(tree: Any, device: DeviceLike,
                         dtype: torch.dtype) -> Any:
    """A JAX dense decode cache (``Model.init_cache``: ``prefix`` /
    ``stack`` / ``tail`` lists of per-layer dicts, stacked periods with a
    leading period axis), handed over as numpy arrays, filled or not, as
    the port's cache of the same nesting
    (``repro_torch.models.transformer.Model.init_cache``), so both
    packages can decode on from one state (a wrapped rolling buffer, a
    carried recurrent state).  A layer holds attention's ``k`` and ``v``
    (B, cap, Hkv, hd), RWKV's ``state``, ``xprev`` and ``cm_xprev``, or
    the RG-LRU's ``h`` and ``conv``.  ``state`` and ``h`` stay fp32, as
    the port keeps them; every other leaf becomes ``dtype``."""
    out = {}
    for group in ("prefix", "stack", "tail"):
        out[group] = []
        for layer in tree[group]:
            if not (set(layer) in _DENSE_LAYERS and np.shape(
                    layer.get("k")) == np.shape(layer.get("v"))):
                shapes = {k: np.shape(v) for k, v in layer.items()}
                raise ValueError(f"not a dense decode cache layer: "
                                 f"{shapes}")
            out[group].append({
                k: params_from_jax(v, device, torch.float32
                                   if k in _FP32_STATE else dtype)
                for k, v in layer.items()})
    return out


# the leaf sets of one dense cache layer: attention; RWKV (time mix and
# channel mix); RG-LRU
_DENSE_LAYERS = ({"k", "v"}, {"state", "xprev", "cm_xprev"}, {"h", "conv"})
_FP32_STATE = ("state", "h")


def shards_from_jax(tree: Any, specs_of, mesh, dtype: torch.dtype) -> Any:
    """This rank's shards of a global JAX tree (numpy arrays): the tree
    converted, then each leaf sliced onto the mesh's device by the spec
    tree ``specs_of(converted tree)`` gives (``runtime/tp.py``'s
    ``param_pspecs`` / ``cache_pspecs``, ``models/moe_sharded.py``'s
    ``moe_pspecs``), so both packages run on the same weights."""
    from .runtime.tp import shard_tree
    full = params_from_jax(tree, "cpu", dtype)
    return shard_tree(full, specs_of(full), mesh)
