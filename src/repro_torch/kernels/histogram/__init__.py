"""The int32 histogram, a public op of the kernel library
(``repro.kernels.histogram``)."""
import torch

from .. import dispatch
from .histogram import histogram_cuda, histogram_plain


def histogram(values: torch.Tensor, n_bins: int = 256) -> torch.Tensor:
    """int32 (N,) -> int32 (n_bins,) counts, values outside [0, n_bins)
    dropped (``repro/kernels/histogram/ops.py``), routed by the device of
    ``values``."""
    on_card = dispatch._on_card("histogram", values)
    fn = histogram_cuda if on_card else histogram_plain
    return fn(values, n_bins)
