"""Data-sheet peaks of the cards a cell may run on (NVIDIA H100 SXM5,
dense rates without sparsity, at the full 700 W power limit).  A share
of a peak is stated against these, with the card's power limit beside
it."""
from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12,
        "fp32_flops": 67e12,
        "hbm_bytes_per_s": 3.35e12,
        "hbm_bytes": 80e9,
    },
}


def peaks(kind: str) -> dict:
    """The peaks of the card named ``kind``; a card not listed takes the
    H100's (every number is then a share of an H100)."""
    return PEAKS.get(kind, PEAKS["NVIDIA H100 80GB HBM3"])
