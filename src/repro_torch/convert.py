"""Params of the JAX package's ``Model.init`` as the port's params.

The JAX tree (``repro/models/transformer.py::Model.init``), handed over
as numpy arrays, maps one to one: same keys, same ``prefix``/``stack``/
``tail`` nesting, same leading period axis on stacked layers (a MoE
layer's ``moe`` subtree, its ``router``, stacked experts ``wg``/``wu``/
``wd`` and ``shared`` MLP, included).
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
    ``stack`` / ``tail`` lists of ``{"k", "v"}`` (B, cap, Hkv, hd) arrays,
    stacked periods with a leading period axis), handed over as numpy
    arrays, filled or not, as the port's cache of the same nesting
    (``repro_torch.models.transformer.Model.init_cache``), so both
    packages can decode on from one state (a wrapped rolling buffer, say).
    """
    for group in ("prefix", "stack", "tail"):
        for layer in tree[group]:
            if set(layer) != {"k", "v"} or layer["k"].shape \
                    != layer["v"].shape:
                shapes = {k: np.shape(v) for k, v in layer.items()}
                raise ValueError(f"not a dense attention cache layer: "
                                 f"{shapes}")
    return params_from_jax(tree, device, dtype)
