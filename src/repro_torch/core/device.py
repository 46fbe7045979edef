"""Device resolution for the port's entry points.

Everything runs on the CUDA card unless the caller asks for the CPU by
name.  With no card and no explicit CPU request the entry points raise:
they never fall back to the CPU quietly.  ``meta`` holds shapes and
dtypes only: the dry run (``launch/dryrun.py``) runs the step there.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (or --device "
            "cpu) to run the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev
