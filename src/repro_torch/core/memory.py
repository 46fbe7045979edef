"""Type demotion (paper §4.4): which dtype each class of tensor uses."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class DtypePolicy:
    """Which dtype each class of tensor uses (the demotion decisions)."""

    param: torch.dtype = torch.float32       # master weights
    compute: torch.dtype = torch.bfloat16    # matmul inputs and activations
    # accumulators are fp32 throughout: the kernels and their plain
    # versions accumulate and take softmax in fp32 (the JAX ``accum``)


BF16_POLICY = DtypePolicy()
F32_POLICY = DtypePolicy(compute=torch.float32)
