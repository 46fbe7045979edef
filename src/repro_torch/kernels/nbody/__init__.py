"""N-body accelerations, a public op of the kernel library
(``repro.kernels.nbody``)."""
import torch

from .. import dispatch
from .nbody import SOFTENING, nbody_accel_cuda, nbody_accel_plain


def nbody_accel(pos: torch.Tensor, mass: torch.Tensor, *,
                eps: float = SOFTENING) -> torch.Tensor:
    """Softened gravitational accelerations: pos (3, N), mass (N,) fp32
    -> (3, N) fp32 (``repro/kernels/nbody/ops.py``), routed by the device
    of ``pos``."""
    on_card = dispatch._on_card("nbody", pos)
    fn = nbody_accel_cuda if on_card else nbody_accel_plain
    return fn(pos, mass, eps=eps)
