"""C = A @ B with fp32 accumulation: the CUDA kernel's wrapper and its
plain PyTorch version.

Replaces ``repro/kernels/matmul/matmul.py::matmul_pallas``; the kernel is
``kernels/csrc/matmul.cu``.  Both versions return A's dtype, the JAX
lowering's ``astype(result_type(x, w))`` of the fp32 accumulator.
"""
from __future__ import annotations

import torch

from .. import cuda


def matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) @ b (K, N), accumulated in fp32, in the promoted dtype."""
    out_dtype = torch.promote_types(a.dtype, b.dtype)
    return (a.float() @ b.float()).to(out_dtype)


def matmul_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch ``repro_matmul``: a (M, K) contiguous, b (K, N) at any
    strides (the tied head passes ``embed.T``), both bf16 or both fp32, on
    one CUDA device.  Returns a new (M, N) tensor of a's dtype."""
    cuda.require_cuda("matmul", a, b, contiguous=False)
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul: want (M, K) @ (K, N), got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype != b.dtype:
        raise TypeError(f"matmul: operand dtypes differ ({a.dtype}, "
                        f"{b.dtype})")
    if not a.is_contiguous():
        raise ValueError("matmul: A must be contiguous")
    m, k = a.shape
    n = b.shape[1]
    c = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if m == 0 or n == 0:
        return c
    if -(-m // 64) > 65535:                    # the grid's row-tile axis
        raise ValueError(f"matmul: M={m} exceeds 65535 row tiles of 64")
    rc = cuda.library().repro_matmul(
        a.data_ptr(), b.data_ptr(), c.data_ptr(),
        *cuda.c_ints("matmul", m, n, k, k, b.stride(0), b.stride(1)),
        cuda.dtype_code(a), cuda.stream_of(a))
    cuda.check(rc, "matmul")
    matmul_cuda.launches += 1
    return c


matmul_cuda.launches = 0
