"""The attention kernels as public ops of the kernel library -- the port
of ``repro/kernels/attention/ops.py``'s ``flash_attention``,
``flash_attention_bwd``, ``decode_attention`` and ``prefill_attention``.

Each takes the paper's ``level`` and a ``plan``, as the JAX ops do: T0
and T1 run the plain PyTorch version, T2 and T3 the kernel on CUDA
tensors (B6, B7, B2/B4a, B3/B4b) and the plain version on CPU tensors.
``plan`` is ``"heuristic"`` (the default), ``"tuned"`` or a dict: the
paged ops' ``{"split_keys": n}`` (keyed by the table's and pools' shapes
and the pools' dtype); the flash kernels take no plan but ``{}``.  The
model's calls go through ``kernels.dispatch``.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from ...core.plan import Level
from .. import registry
from .backward import flash_attention_bwd_cuda, flash_attention_bwd_plain
from .decode import (decode_attention_cuda, decode_attention_int8_cuda,
                     decode_attention_plain)
from .flash import flash_attention_cuda, flash_attention_plain
from .prefill import (prefill_attention_cuda, prefill_attention_int8_cuda,
                      prefill_attention_plain)

Plan = Union[str, dict, None]
T3 = Level.T3_REPLICATED


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, level: Level = T3,
                    plan: Plan = "heuristic", return_lse: bool = False):
    """(B, H, S, hd) attention -> o (B, H, S, hd) fp32 (and lse)."""
    kernel, _ = registry.route("flash_attention", q, k, v, level=level,
                               plan=plan)
    fn = flash_attention_cuda if kernel else flash_attention_plain
    return fn(q, k, v, causal=causal, window=window, return_lse=return_lse)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, *, causal: bool = True,
                        window: int = 0, level: Level = T3,
                        plan: Plan = "heuristic"):
    """(dq, dk, dv) fp32 of ``flash_attention`` from its residuals."""
    kernel, _ = registry.route("flash_attention_bwd", q, k, v, o, lse, do,
                               level=level, plan=plan)
    fn = flash_attention_bwd_cuda if kernel else flash_attention_bwd_plain
    return fn(q, k, v, o, lse, do, causal=causal, window=window)


def decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                     v_pages: torch.Tensor, table: torch.Tensor,
                     lengths: torch.Tensor,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None, *,
                     window: int = 0, level: Level = T3,
                     plan: Plan = "heuristic") -> torch.Tensor:
    """Ragged one-token attention over a paged cache: (B, H, hd) fp32;
    int8 pools with their scales take B4a."""
    int8 = k_scale is not None
    name = "decode_attention_int8" if int8 else "decode_attention"
    scales = (k_scale, v_scale) if int8 else ()
    kernel, kw = registry.route(name, q, k_pages, v_pages, table, lengths,
                                *scales, level=level, plan=plan)
    if not kernel:
        return decode_attention_plain(q, k_pages, v_pages, table, lengths,
                                      k_scale, v_scale, window=window)
    fn = decode_attention_int8_cuda if int8 else decode_attention_cuda
    return fn(q, k_pages, v_pages, table, lengths, *scales, window=window,
              plan=kw)


def prefill_attention(q: torch.Tensor, k_pages: torch.Tensor,
                      v_pages: torch.Tensor, table: torch.Tensor,
                      starts: torch.Tensor,
                      k_scale: Optional[torch.Tensor] = None,
                      v_scale: Optional[torch.Tensor] = None, *,
                      window: int = 0, level: Level = T3,
                      plan: Plan = "heuristic") -> torch.Tensor:
    """Ragged chunked causal prefill over a paged cache: (B, C, H, hd)
    fp32; int8 pools with their scales take B4b."""
    int8 = k_scale is not None
    name = "prefill_attention_int8" if int8 else "prefill_attention"
    scales = (k_scale, v_scale) if int8 else ()
    kernel, kw = registry.route(name, q, k_pages, v_pages, table, starts,
                                *scales, level=level, plan=plan)
    if not kernel:
        return prefill_attention_plain(q, k_pages, v_pages, table, starts,
                                       k_scale, v_scale, window=window)
    fn = prefill_attention_int8_cuda if int8 else prefill_attention_cuda
    return fn(q, k_pages, v_pages, table, starts, *scales, window=window,
              plan=kw)
