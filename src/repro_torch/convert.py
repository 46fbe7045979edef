"""Params of the JAX package's ``Model.init`` as the port's params.

The JAX tree (``repro/models/transformer.py::Model.init``), handed over
as numpy arrays, maps one to one: same keys, same ``prefix``/``stack``/
``tail`` nesting, same leading period axis on stacked layers.
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
