"""KV-pool storage dtypes.  Float pools only; int8 pools with their
per-page scales come with the quantized-serving slice."""
from __future__ import annotations

import torch

_ALIASES = {"fp32": torch.float32, "float32": torch.float32,
            "bf16": torch.bfloat16, "bfloat16": torch.bfloat16}


def kv_dtype_of(name: str, compute_dtype: torch.dtype) -> torch.dtype:
    """Resolve an ``ArchConfig.kv_dtype`` string ("" = model compute
    dtype) to a torch dtype."""
    if not name:
        return compute_dtype
    if name not in _ALIASES:
        raise ValueError(f"kv_dtype {name!r} is not supported by this port "
                         f"(float pools only: {sorted(_ALIASES)})")
    return _ALIASES[name]
