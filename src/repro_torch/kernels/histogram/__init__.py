"""The int32 histogram, a public op of the kernel library
(``repro.kernels.histogram``)."""
import torch

from .. import dispatch
from .histogram import histogram_cuda, histogram_plain


def histogram(values: torch.Tensor, n_bins: int = 256) -> torch.Tensor:
    """Integer (N,) -> int32 (n_bins,) counts, values outside [0, n_bins)
    dropped (``repro/kernels/histogram/ops.py``), routed by the device of
    ``values``.  The kernel counts contiguous int32: other integer types
    are narrowed after every value outside [0, n_bins) is mapped to -1,
    so no cast can wrap an out-of-range value (an int64 of 2^32 + 3, say)
    into range."""
    if not dispatch._on_card("histogram", values):
        return histogram_plain(values, n_bins)
    if values.dtype != torch.int32 and not values.is_floating_point():
        wide = values.long()
        values = torch.where((wide >= 0) & (wide < n_bins), wide,
                             -1).to(torch.int32)
    return histogram_cuda(values.contiguous(), n_bins)
