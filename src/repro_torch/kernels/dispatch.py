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

from .attention import (decode_attention_cuda, decode_attention_plain,
                        prefill_attention_cuda, prefill_attention_plain)
from .matmul import matmul_cuda, matmul_plain

_stats: Counter = Counter()

# every kernel wrapper, by op name; each carries its launch count
KERNELS = {"matmul": matmul_cuda,
           "decode_attention": decode_attention_cuda,
           "prefill_attention": prefill_attention_cuda}


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


def decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                     v_pages: torch.Tensor, table: torch.Tensor,
                     lengths: torch.Tensor, *, window: int = 0,
                     out_dtype: Optional[torch.dtype] = None
                     ) -> torch.Tensor:
    """Ragged decode attention over a paged KV cache (layout in
    ``attention/decode.py``).  Returns (B, H, hd) in ``out_dtype``
    (default q's dtype)."""
    fn = decode_attention_cuda if _on_card("decode_attention", q) \
        else decode_attention_plain
    out = fn(q, k_pages, v_pages, table, lengths, window=window)
    return out.to(q.dtype if out_dtype is None else out_dtype)


def prefill_attention(q: torch.Tensor, k_pages: torch.Tensor,
                      v_pages: torch.Tensor, table: torch.Tensor,
                      starts: torch.Tensor, *, window: int = 0,
                      out_dtype: Optional[torch.dtype] = None
                      ) -> torch.Tensor:
    """Ragged multi-token prefill attention over a paged KV cache (layout
    in ``attention/prefill.py``).  Returns (B, C, H, hd) in ``out_dtype``
    (default q's dtype)."""
    fn = prefill_attention_cuda if _on_card("prefill_attention", q) \
        else prefill_attention_plain
    out = fn(q, k_pages, v_pages, table, starts, window=window)
    return out.to(q.dtype if out_dtype is None else out_dtype)
