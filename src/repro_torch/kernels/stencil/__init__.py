"""The 4-point Jacobi stencil, a public op of the kernel library
(``repro.kernels.stencil``)."""
from typing import Union

import torch

from ...core.plan import Level
from .. import registry
from .stencil import jacobi4_cuda, jacobi4_plain


def jacobi4(x: torch.Tensor, *, steps: int = 1,
            level: Level = Level.T3_REPLICATED,
            plan: Union[str, dict, None] = "heuristic") -> torch.Tensor:
    """``steps`` sweeps of the 4-point Jacobi stencil over a (rows, cols)
    grid, boundary copied through (``repro/kernels/stencil/ops.py``),
    routed by the device of ``x`` (a view, such as a sub-grid, is made
    contiguous for the kernel).  ``level`` T0/T1 run the plain version,
    as the JAX op runs its oracle; the kernel takes no plan but the
    heuristic's (``plan`` ``"heuristic"``, ``"tuned"`` or ``{}``)."""
    kernel, _ = registry.route("stencil", x, level=level, plan=plan)
    if kernel:
        return jacobi4_cuda(x.contiguous(), steps=steps)
    return jacobi4_plain(x, steps=steps)
