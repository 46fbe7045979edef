"""The 4-point Jacobi stencil, a public op of the kernel library
(``repro.kernels.stencil``)."""
import torch

from .. import dispatch
from .stencil import jacobi4_cuda, jacobi4_plain


def jacobi4(x: torch.Tensor, *, steps: int = 1) -> torch.Tensor:
    """``steps`` sweeps of the 4-point Jacobi stencil over a (rows, cols)
    grid, boundary copied through (``repro/kernels/stencil/ops.py``),
    routed by the device of ``x`` (a view, such as a sub-grid, is made
    contiguous for the kernel)."""
    if dispatch._on_card("stencil", x):
        return jacobi4_cuda(x.contiguous(), steps=steps)
    return jacobi4_plain(x, steps=steps)
