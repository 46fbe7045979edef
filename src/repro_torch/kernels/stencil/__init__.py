"""The 4-point Jacobi stencil, a public op of the kernel library
(``repro.kernels.stencil``)."""
import torch

from .. import dispatch
from .stencil import jacobi4_cuda, jacobi4_plain


def jacobi4(x: torch.Tensor, *, steps: int = 1) -> torch.Tensor:
    """``steps`` sweeps of the 4-point Jacobi stencil over a (rows, cols)
    grid, boundary copied through (``repro/kernels/stencil/ops.py``),
    routed by the device of ``x``."""
    fn = jacobi4_cuda if dispatch._on_card("stencil", x) else jacobi4_plain
    return fn(x, steps=steps)
