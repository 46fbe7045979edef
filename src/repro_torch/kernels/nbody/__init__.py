"""N-body accelerations, a public op of the kernel library
(``repro.kernels.nbody``)."""
from typing import Union

import torch

from ...core.plan import Level
from .. import registry
from .nbody import SOFTENING, nbody_accel_cuda, nbody_accel_plain


def nbody_accel(pos: torch.Tensor, mass: torch.Tensor, *,
                eps: float = SOFTENING,
                level: Level = Level.T3_REPLICATED,
                plan: Union[str, dict, None] = "heuristic") -> torch.Tensor:
    """Softened gravitational accelerations: pos (3, N), mass (N,) fp32
    -> (3, N) fp32 (``repro/kernels/nbody/ops.py``), routed by the device
    of ``pos`` (views, such as ``x.T`` of positions kept as (N, 3), are
    made contiguous for the kernel).  ``level`` T0/T1 run the plain
    version, as the JAX op runs its oracle; ``plan`` is ``"heuristic"``,
    ``"tuned"`` or ``{"splits": s}`` (``registry.route``)."""
    kernel, kw = registry.route("nbody", pos, mass, level=level, plan=plan)
    if kernel:
        return nbody_accel_cuda(pos.contiguous(), mass.contiguous(), eps=eps,
                                plan=kw)
    return nbody_accel_plain(pos, mass, eps=eps)
