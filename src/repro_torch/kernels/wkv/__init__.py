"""RWKV6 WKV, a public op of the kernel library (``repro.kernels.wkv``);
the model's differentiable WKV is ``kernels.dispatch.wkv``."""
import torch

from .. import dispatch
from .wkv import (aligned, wkv_bwd_chunked, wkv_bwd_cuda, wkv_bwd_plain,
                  wkv_cuda, wkv_plain)


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lw: torch.Tensor,
        u: torch.Tensor, *, chunk: int = 64,
        subchunk: int = 16) -> torch.Tensor:
    """RWKV6 WKV recurrence (``repro/kernels/wkv/ops.py``), routed by the
    device of ``r``.  r, k, v (B, S, H, hd) fp32 or bf16; lw (B, S, H, hd)
    log-decays (<= 0, cast to fp32); u (H, hd) bonus (cast to fp32).
    Returns (B, S, H, hd) fp32.  ``subchunk`` sets the sub-chunks of the
    TPU kernel's intra-chunk form (``subchunk_len``), which the card's mma
    route computes; it changes which intra-chunk weights are clamped at
    e^-60 (those of one sub-chunk) and nothing else above that.  The plain
    version (the direct form, every intra-chunk weight clamped) and the
    simt route do not read it."""
    if subchunk < 1:
        raise ValueError(f"wkv: subchunk {subchunk} < 1")
    if dispatch._on_card("wkv", r):
        # the kernel reads dense rows, and its mma route copies them with
        # cp.async: views are made contiguous, data off a 16-byte boundary
        # (a contiguous view at an odd offset) is copied
        return wkv_cuda(*(aligned(t) for t in (r, k, v, lw.float(),
                                                u.float())),
                        chunk=chunk, subchunk=subchunk)
    return wkv_plain(r, k, v, lw.float(), u.float(), chunk=chunk)
