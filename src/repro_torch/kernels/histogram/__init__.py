"""The int32 histogram, a public op of the kernel library
(``repro.kernels.histogram``)."""
from typing import Union

import torch

from ...core.plan import Level
from .. import registry
from .histogram import histogram_cuda, histogram_plain


def histogram(values: torch.Tensor, n_bins: int = 256, *,
              level: Level = Level.T3_REPLICATED,
              plan: Union[str, dict, None] = "heuristic") -> torch.Tensor:
    """Integer (N,) -> int32 (n_bins,) counts, values outside [0, n_bins)
    dropped (``repro/kernels/histogram/ops.py``), routed by the device of
    ``values``.  The kernel counts contiguous int32: other integer types
    are narrowed after every value outside [0, n_bins) is mapped to -1,
    so no cast can wrap an out-of-range value (an int64 of 2^32 + 3, say)
    into range.  ``level`` T0/T1 run the plain version, as the JAX op runs
    its oracle; ``plan`` is ``"heuristic"``, ``"tuned"`` or
    ``{"route": "shared" | "global"}`` (``registry.route``)."""
    kernel, kw = registry.route("histogram", values, n_bins, level=level,
                                plan=plan)
    if not kernel:
        return histogram_plain(values, n_bins)
    if values.dtype != torch.int32 and not values.is_floating_point():
        wide = values.long()
        values = torch.where((wide >= 0) & (wide < n_bins), wide,
                             -1).to(torch.int32)
    return histogram_cuda(values.contiguous(), n_bins, plan=kw)
