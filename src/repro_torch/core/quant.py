"""Symmetric int8 quantization of KV pages and weights (paper §4.4): the
port of ``repro/core/quant.py``.

* **KV pages** quantize per (page, kv head): one f32 scale per (physical
  page, Hkv) cell.  Prefill writes whole pages (clean abs-max scales);
  decode appends one token at a time with a running-max rescale: a page's
  scale only grows, its ints are rescaled by ``old_scale / new_scale``, and
  a freed page's scale is reset to 0, so the first append into it wipes
  any stale payload (ratio 0 zeroes the ints).
* **Weights** quantize per output channel (one f32 per N column), the
  layout ``quantized_matmul`` applies once at its K flush.

Every op runs in fp32 in the JAX package's order, so the int8 tensors and
scales are the JAX package's bit for bit (``torch.round`` and
``jnp.round`` both round half to even).
"""
from __future__ import annotations

from typing import Tuple

import torch

# x ~= q * scale with q in [-127, 127], scale = amax / 127
INT8_MAX = 127.0

_ALIASES = {"fp32": torch.float32, "float32": torch.float32,
            "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
            "int8": torch.int8}


def _quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Round to nearest even at a (broadcast) scale; a zero scale means an
    all-zero block, so the divide is guarded."""
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    return torch.clamp(torch.round(x.float() / safe),
                       -INT8_MAX, INT8_MAX).to(torch.int8)


def quantize_pages(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Whole-page quantize: x (..., page, Hkv, hd) float -> (int8 of x's
    shape, f32 scales (..., Hkv)), abs-max over the (page, hd) axes."""
    amax = x.float().abs().amax(dim=(-3, -1))
    scale = amax / INT8_MAX
    return _quantize(x, scale[..., None, :, None]), scale


def append_token_quantized(page_q: torch.Tensor, page_scale: torch.Tensor,
                           token: torch.Tensor, off: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode append: write one token into slot ``off`` of each gathered
    page with a running-max rescale.

    page_q (B, page, Hkv, hd) int8; page_scale (B, Hkv) f32; token
    (B, Hkv, hd) float; off (B,) int.  Returns new (pages, scales)."""
    b = page_q.shape[0]
    tok_amax = token.float().abs().amax(dim=-1)
    new_scale = torch.maximum(page_scale, tok_amax / INT8_MAX)   # (B, Hkv)
    pos = new_scale > 0
    ratio = torch.where(
        pos, page_scale / torch.where(pos, new_scale,
                                      torch.ones_like(new_scale)),
        torch.zeros_like(new_scale))
    page_q = torch.clamp(torch.round(page_q.float()
                                     * ratio[:, None, :, None]),
                         -INT8_MAX, INT8_MAX).to(torch.int8)
    page_q[torch.arange(b, device=page_q.device), off.long()] = \
        _quantize(token, new_scale[..., None])
    return page_q, new_scale


def quantize_channelwise(w: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weight quantize: w (..., K, N) float -> (int8 (..., K, N), f32
    scales (..., N)), one scale per output channel.  Leading axes (a
    stacked period axis) quantize independently."""
    scale = w.float().abs().amax(dim=-2) / INT8_MAX
    return _quantize(w, scale[..., None, :]), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Reference dequant: broadcast-multiply back to f32."""
    return q.float() * scale


def kv_dtype_of(name: str, compute_dtype: torch.dtype) -> torch.dtype:
    """Resolve an ``ArchConfig.kv_dtype`` string ("" = model compute
    dtype) to a torch dtype."""
    if not name:
        return compute_dtype
    if name not in _ALIASES:
        raise ValueError(f"kv_dtype {name!r} is not supported "
                         f"(one of {sorted(_ALIASES)})")
    return _ALIASES[name]
