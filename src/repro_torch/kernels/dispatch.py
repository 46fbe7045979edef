"""Kernel dispatch: the one entry point the model uses for its hot
contractions.

The route is chosen by the device of the tensors and by nothing else: a
CPU tensor takes the kernel's plain PyTorch version, a CUDA tensor takes
the hand-written CUDA kernel (whose wrapper raises on what it does not
take; there is no fallback).  Each call ticks an ``(op, route)`` counter,
route "kernel" or "plain", so a run can show which path it took;
``stats_scope`` isolates the counters for a probe.
"""
from __future__ import annotations

import contextlib
from collections import Counter
from typing import Dict, Optional, Tuple

import torch

from .attention import (decode_attention_cuda, decode_attention_int8_cuda,
                        decode_attention_plain, prefill_attention_cuda,
                        prefill_attention_int8_cuda, prefill_attention_plain)
from .matmul import (matmul_cuda, matmul_plain, quantized_matmul_cuda,
                     quantized_matmul_plain)

_stats: Counter = Counter()

# every kernel wrapper, by op name; each carries its launch count.  The
# int8 attention branches count under their own names, so a run shows
# which branch launched.
KERNELS = {"matmul": matmul_cuda,
           "quantized_matmul": quantized_matmul_cuda,
           "decode_attention": decode_attention_cuda,
           "decode_attention_int8": decode_attention_int8_cuda,
           "prefill_attention": prefill_attention_cuda,
           "prefill_attention_int8": prefill_attention_int8_cuda}


def reset_stats() -> None:
    _stats.clear()


def stats() -> Dict[Tuple[str, str], int]:
    return dict(_stats)


@contextlib.contextmanager
def stats_scope():
    """Isolated counter scope: zeroed on entry, restored on exit."""
    saved = Counter(_stats)
    reset_stats()
    try:
        yield stats
    finally:
        _stats.clear()
        _stats.update(saved)


def launch_counts() -> Dict[str, int]:
    return {op: fn.launches for op, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def _on_card(op: str, t: torch.Tensor) -> bool:
    kernel = t.is_cuda
    _stats[(op, "kernel" if kernel else "plain")] += 1
    return kernel


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Contract the last axis of ``x`` with the first axis of ``w``.

    x: (..., K); w: (K, N1[, N2, ...]).  Returns x.shape[:-1] + w.shape[1:]
    in the promoted input dtype."""
    k = x.shape[-1]
    a, b = x.reshape(-1, k), w.reshape(k, -1)
    out = matmul_cuda(a, b) if _on_card("matmul", x) else matmul_plain(a, b)
    return out.reshape(x.shape[:-1] + w.shape[1:])


def quantized_matmul(x: torch.Tensor, w_q: torch.Tensor,
                     w_scale: torch.Tensor) -> torch.Tensor:
    """Int8-weight matmul with per-output-channel dequant (§4.4 type
    demotion).  x: (..., K) float; w_q: (K, N) int8; w_scale: (N,) fp32
    (``core.quant.quantize_channelwise``).  Returns x.shape[:-1] + (N,)
    fp32."""
    k = x.shape[-1]
    a = x.reshape(-1, k)
    fn = quantized_matmul_cuda if _on_card("quantized_matmul", x) \
        else quantized_matmul_plain
    return fn(a, w_q, w_scale).reshape(x.shape[:-1] + w_q.shape[1:])


def decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                     v_pages: torch.Tensor, table: torch.Tensor,
                     lengths: torch.Tensor,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None, *,
                     window: int = 0,
                     out_dtype: Optional[torch.dtype] = None
                     ) -> torch.Tensor:
    """Ragged decode attention over a paged KV cache (layout in
    ``attention/decode.py``).  int8 pools pass their (P, Hkv) fp32
    ``k_scale`` / ``v_scale`` (both or neither) and take the int8 branch,
    op ``decode_attention_int8``.  Returns (B, H, hd) in ``out_dtype``
    (default q's dtype)."""
    if k_scale is None:
        fn = decode_attention_cuda if _on_card("decode_attention", q) \
            else decode_attention_plain
        out = fn(q, k_pages, v_pages, table, lengths, window=window)
    elif _on_card("decode_attention_int8", q):
        out = decode_attention_int8_cuda(q, k_pages, v_pages, table, lengths,
                                         k_scale, v_scale, window=window)
    else:
        out = decode_attention_plain(q, k_pages, v_pages, table, lengths,
                                     k_scale, v_scale, window=window)
    return out.to(q.dtype if out_dtype is None else out_dtype)


def prefill_attention(q: torch.Tensor, k_pages: torch.Tensor,
                      v_pages: torch.Tensor, table: torch.Tensor,
                      starts: torch.Tensor,
                      k_scale: Optional[torch.Tensor] = None,
                      v_scale: Optional[torch.Tensor] = None, *,
                      window: int = 0,
                      out_dtype: Optional[torch.dtype] = None
                      ) -> torch.Tensor:
    """Ragged multi-token prefill attention over a paged KV cache (layout
    in ``attention/prefill.py``); int8 pools as in ``decode_attention``
    (op ``prefill_attention_int8``).  Returns (B, C, H, hd) in
    ``out_dtype`` (default q's dtype)."""
    if k_scale is None:
        fn = prefill_attention_cuda if _on_card("prefill_attention", q) \
            else prefill_attention_plain
        out = fn(q, k_pages, v_pages, table, starts, window=window)
    elif _on_card("prefill_attention_int8", q):
        out = prefill_attention_int8_cuda(q, k_pages, v_pages, table, starts,
                                          k_scale, v_scale, window=window)
    else:
        out = prefill_attention_plain(q, k_pages, v_pages, table, starts,
                                      k_scale, v_scale, window=window)
    return out.to(q.dtype if out_dtype is None else out_dtype)
