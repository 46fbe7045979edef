"""RWKV6 WKV, a public op of the kernel library (``repro.kernels.wkv``)."""
import torch

from .. import dispatch
from .wkv import wkv_cuda, wkv_plain


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lw: torch.Tensor,
        u: torch.Tensor, *, chunk: int = 64,
        subchunk: int = 16) -> torch.Tensor:
    """RWKV6 WKV recurrence (``repro/kernels/wkv/ops.py``), routed by the
    device of ``r``.  r, k, v (B, S, H, hd) fp32 or bf16; lw (B, S, H, hd)
    log-decays (<= 0, cast to fp32); u (H, hd) bonus (cast to fp32).
    Returns (B, S, H, hd) fp32.  ``subchunk`` is checked and otherwise has
    no effect: it tiles the TPU kernel's intra-chunk term without changing
    the result, and both routes here compute that term in the direct form
    until B8 is redesigned around the sub-chunked one."""
    if subchunk < 1:
        raise ValueError(f"wkv: subchunk {subchunk} < 1")
    fn = wkv_cuda if dispatch._on_card("wkv", r) else wkv_plain
    return fn(r, k, v, lw.float(), u.float(), chunk=chunk)
