"""The GEMMs as public ops of the kernel library -- the port of
``repro/kernels/matmul/ops.py``'s ``matmul`` and ``quantized_matmul``.

Each takes the paper's ``level`` and a ``plan``, as the JAX ops do: T0
and T1 run the plain PyTorch version (the JAX ops' XLA oracle), T2 and T3
the kernel on CUDA tensors (B1 and B5, written at T3) and the plain
version on CPU tensors.  ``plan`` is ``"heuristic"`` (the kernel's own
split plan, the default), ``"tuned"`` (the tuned-plan cache: exact key,
nearest feasible shape, then the heuristic) or a dict such as
``{"split": 4}``.  The model's calls go through ``kernels.dispatch``.
"""
from __future__ import annotations

from typing import Union

import torch

from ...core.plan import Level
from .. import registry
from .matmul import (matmul_cuda, matmul_plain, quantized_matmul_cuda,
                     quantized_matmul_plain)

Plan = Union[str, dict, None]


def matmul(a: torch.Tensor, b: torch.Tensor, *,
           level: Level = Level.T3_REPLICATED,
           plan: Plan = "heuristic") -> torch.Tensor:
    """C = A @ B at a paper-§6.2 stage: a (M, K) @ b (K, N), accumulated
    in fp32, in the promoted dtype."""
    kernel, kw = registry.route("matmul", a, b, level=level, plan=plan)
    if kernel:
        return matmul_cuda(a.contiguous(), b, plan=kw)
    return matmul_plain(a, b)


def quantized_matmul(a: torch.Tensor, b_q: torch.Tensor,
                     b_scale: torch.Tensor, *,
                     level: Level = Level.T3_REPLICATED,
                     plan: Plan = "heuristic") -> torch.Tensor:
    """C = A @ dequant(B), int8 B with per-column fp32 scales (§4.4):
    (M, N) fp32.  Plans live in their own ``quantized_matmul``
    namespace."""
    kernel, kw = registry.route("quantized_matmul", a, b_q, b_scale,
                                level=level, plan=plan)
    if kernel:
        return quantized_matmul_cuda(a.contiguous(), b_q, b_scale, plan=kw)
    return quantized_matmul_plain(a, b_q, b_scale)
