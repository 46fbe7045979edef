"""Histogram of int32 values (paper §2.3): the CUDA kernel's wrapper and
its plain PyTorch version.

Replaces ``repro/kernels/histogram/histogram.py::histogram_pallas``; the
kernel is ``kernels/csrc/histogram.cu``.  values (N,) int32 -> counts
(n_bins,) int32.  A value outside [0, n_bins) is dropped, negative ones
included, as the TPU kernel's one-hot compare drops it (its oracle,
``ref.py::histogram_ref``, would count a negative value into bin 0;
the public JAX op runs the kernel, and the port follows the kernel).
"""
from __future__ import annotations

import torch

from .. import cuda


def _check_bins(n_bins: int) -> None:
    if n_bins < 1:
        raise ValueError(f"histogram: n_bins {n_bins} < 1")


def histogram_plain(values: torch.Tensor, n_bins: int = 256) -> torch.Tensor:
    _check_bins(n_bins)
    kept = values[(values >= 0) & (values < n_bins)]
    return torch.bincount(kept, minlength=n_bins).to(torch.int32)


def bin_window(n_bins: int) -> int:
    """The bins one block's shared memory holds, at most ``n_bins``: the
    shared route of csrc/histogram.cu takes ``n_bins`` when they all fit."""
    _check_bins(n_bins)
    return min(n_bins, cuda.MAX_SMEM_BYTES // 4)


# csrc/histogram.cu's routes, by their C codes
ROUTES = {"shared": 0, "global": 1}


def histogram_route(n_bins: int) -> str:
    """The kernel's route, a function of ``n_bins`` alone: ``shared`` (a
    private histogram per block in shared memory, added to the output once
    per bin) while every bin fits one block's shared memory, else
    ``global`` (one pass over the values, one atomic per run of equal
    values straight into the output, which L2 holds)."""
    return "shared" if bin_window(n_bins) == n_bins else "global"


def planned_route(n_bins: int, plan) -> str:
    """The route of a call: ``histogram_route``'s without a plan, else the
    plan's ``{"route": r}``, ``shared`` only where every bin fits one
    block's shared memory."""
    if not plan:
        return histogram_route(n_bins)
    route = plan["route"]
    if route not in ROUTES or (route == "shared"
                               and bin_window(n_bins) != n_bins):
        raise ValueError(f"histogram: route {route!r} does not take "
                         f"{n_bins} bins")
    return route


def histogram_cuda(values: torch.Tensor, n_bins: int = 256, *,
                   plan=None) -> torch.Tensor:
    """Launch ``repro_histogram`` on the route ``histogram_route(n_bins)``
    names, or ``plan``'s ``{"route": r}`` (``shared`` only where
    ``bin_window`` holds every bin): values (N,) contiguous int32 on a
    CUDA device, any ``n_bins >= 1``.  Returns a new (n_bins,) int32
    tensor; raises on anything the kernel does not take."""
    cuda.require_cuda("histogram", values)
    if values.dim() != 1:
        raise ValueError(f"histogram: want values (N,), got "
                         f"{tuple(values.shape)}")
    if values.dtype != torch.int32:
        raise TypeError(f"histogram: want int32 values, got {values.dtype}")
    route = ROUTES[planned_route(n_bins, plan)]
    n, bins = cuda.c_ints("histogram", values.shape[0], n_bins)
    out = torch.zeros(bins, dtype=torch.int32, device=values.device)
    if n == 0:
        return out
    rc = cuda.library().repro_histogram(values.data_ptr(), out.data_ptr(),
                                        n, bins, route,
                                        cuda.stream_of(values))
    cuda.check(rc, "histogram")
    histogram_cuda.launches += 1
    return out


histogram_cuda.launches = 0
