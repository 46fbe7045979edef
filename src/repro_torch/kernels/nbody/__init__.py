"""N-body accelerations, a public op of the kernel library
(``repro.kernels.nbody``)."""
import torch

from .. import dispatch
from .nbody import SOFTENING, nbody_accel_cuda, nbody_accel_plain


def nbody_accel(pos: torch.Tensor, mass: torch.Tensor, *,
                eps: float = SOFTENING) -> torch.Tensor:
    """Softened gravitational accelerations: pos (3, N), mass (N,) fp32
    -> (3, N) fp32 (``repro/kernels/nbody/ops.py``), routed by the device
    of ``pos`` (views, such as ``x.T`` of positions kept as (N, 3), are
    made contiguous for the kernel)."""
    if dispatch._on_card("nbody", pos):
        return nbody_accel_cuda(pos.contiguous(), mass.contiguous(), eps=eps)
    return nbody_accel_plain(pos, mass, eps=eps)
