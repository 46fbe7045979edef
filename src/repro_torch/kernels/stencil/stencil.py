"""The 4-point 2D Jacobi stencil (paper §6.1): the CUDA kernel's wrapper
and its plain PyTorch version.

Replaces ``repro/kernels/stencil/stencil.py::jacobi4_pallas`` (one sweep
per launch); the kernel is ``kernels/csrc/stencil.cu``; the plain version
is the port of ``repro/kernels/stencil/ref.py::jacobi4_iter_ref``.

x is (rows, cols), fp32 or bf16, any shape.  A sweep sets each interior
cell to 0.25 * (north + south + west + east) and copies the boundary rows
and columns through.  Both versions compute a sweep in fp32 and round to
x's type once, so they agree bit for bit; the JAX op adds in x's type.
"""
from __future__ import annotations

import torch

from .. import cuda


def jacobi4_plain(x: torch.Tensor, *, steps: int = 1) -> torch.Tensor:
    """``steps`` sweeps; returns a new tensor of x's shape and type."""
    y = x.clone()
    for _ in range(steps):
        xf = y.float()
        # the whole interior is computed from the old grid before any of
        # it is written back
        y[1:-1, 1:-1] = (0.25 * (xf[:-2, 1:-1] + xf[2:, 1:-1]
                                 + xf[1:-1, :-2] + xf[1:-1, 2:])).to(x.dtype)
    return y


def jacobi4_cuda(x: torch.Tensor, *, steps: int = 1) -> torch.Tensor:
    """Launch ``repro_jacobi4`` once per sweep, ping-ponging two new
    buffers (the update reads only the old grid, so a sweep never writes
    its input): x (rows, cols) contiguous fp32 or bf16 on a CUDA device.
    Returns a new tensor; raises on anything the kernel does not take."""
    cuda.require_cuda("jacobi4", x)
    if x.dim() != 2:
        raise ValueError(f"jacobi4: want a (rows, cols) grid, got "
                         f"{tuple(x.shape)}")
    if steps < 0:
        raise ValueError(f"jacobi4: steps {steps} < 0")
    code = cuda.dtype_code(x)
    rows, cols = cuda.c_ints("jacobi4", *x.shape)
    if steps == 0 or x.numel() == 0:
        return x.clone()
    lib, stream = cuda.library(), cuda.stream_of(x)
    bufs = [torch.empty_like(x), torch.empty_like(x) if steps > 1 else None]
    src = x
    for step in range(steps):
        dst = bufs[step % 2]
        cuda.check(lib.repro_jacobi4(src.data_ptr(), dst.data_ptr(), rows,
                                     cols, code, stream), "jacobi4")
        jacobi4_cuda.launches += 1
        src = dst
    return src


jacobi4_cuda.launches = 0
