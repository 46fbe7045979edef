"""Ragged multi-token prefill attention over a paged KV cache: the CUDA
kernel's wrapper and its plain PyTorch version.

Replaces ``repro/kernels/attention/prefill.py::prefill_attention_pallas``;
the kernel is ``kernels/csrc/prefill_attention.cu``; the plain version is
the port of ``repro/kernels/attention/ref.py::prefill_attention_ref``.

Layout: q (B, C, H, hd) -- a chunk of C tokens per slot, already written
into the pools; k_pages / v_pages (P, page, Hkv, hd); table (B, n_pages)
int32; starts (B,) int32 chunk offsets -- slot b's queries sit at
positions ``starts[b] + [0, C)`` and attend causally over the cached
history plus the chunk itself (padded tail positions are hidden by
causality).  Returns (B, C, H, hd) fp32.  int8 pools come with k_scale /
v_scale (P, Hkv) f32, as in ``decode.py``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .. import cuda
from .decode import _check_paged, expand_kv, gather_pages


def prefill_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                            v_pages: torch.Tensor, table: torch.Tensor,
                            starts: torch.Tensor,
                            k_scale: Optional[torch.Tensor] = None,
                            v_scale: Optional[torch.Tensor] = None, *,
                            window: int = 0) -> torch.Tensor:
    """Gather pages to a dense view (dequantizing int8 pools), mask
    causally against each chunk's positions (and by the window), fp32
    softmax; P is cast to V's dtype before the P @ V product, as in the
    kernel (fp32 for dequantized int8 pools)."""
    b, c, h, hd = q.shape
    k = expand_kv(gather_pages(k_pages, table, k_scale), h)
    v = expand_kv(gather_pages(v_pages, table, v_scale), h)
    scores = torch.einsum("bqhd,bshd->bhqs", q.float(), k.float()) \
        / math.sqrt(hd)
    qpos = starts.long()[:, None] + torch.arange(c, device=q.device)[None]
    kpos = torch.arange(k.shape[1], device=q.device)
    mask = kpos[None, None, :] <= qpos[:, :, None]            # (B, C, S)
    if window > 0:
        mask &= kpos[None, None, :] > qpos[:, :, None] - window
    scores = torch.where(mask[:, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqs,bshd->bqhd", probs.float(), v.float())


def _launch(wrapper, q, k_pages, v_pages, table, starts, k_scale, v_scale,
            window: int) -> torch.Tensor:
    """Launch ``repro_prefill_attention`` (float pools) or its int8 entry
    (grid: slot x kv head x tiles of 32 flattened query rows) and count it
    on ``wrapper``."""
    name = "prefill_attention" if k_scale is None \
        else "prefill_attention_int8"
    _check_paged(name, q, k_pages, v_pages, table, starts, 2, k_scale,
                 v_scale)
    b, c, h, hd = q.shape
    _, page, hkv, _ = k_pages.shape
    smem = 4 * (2 * 32 * hd + 32 * (2 * hd + 1) + 32 * 32 + 3 * 32)
    if smem > cuda.MAX_SMEM_BYTES:
        raise ValueError(f"{name}: head width {hd} needs {smem} bytes of "
                         f"shared memory")
    out = torch.empty((b, c, h, hd), dtype=torch.float32, device=q.device)
    if b == 0 or c == 0:
        return out
    lib = cuda.library()
    sizes = cuda.c_ints(name, b, c, h, hkv, hd, page, table.shape[1],
                        k_pages.shape[0], max(0, int(window)))
    if k_scale is None:
        rc = lib.repro_prefill_attention(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            table.data_ptr(), starts.data_ptr(), out.data_ptr(), *sizes,
            cuda.dtype_code(q), cuda.stream_of(q))
    else:
        rc = lib.repro_prefill_attention_int8(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_scale.data_ptr(), v_scale.data_ptr(), table.data_ptr(),
            starts.data_ptr(), out.data_ptr(), *sizes, cuda.dtype_code(q),
            cuda.stream_of(q))
    cuda.check(rc, name)
    wrapper.launches += 1
    return out


def prefill_attention_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, table: torch.Tensor,
                           starts: torch.Tensor, *,
                           window: int = 0) -> torch.Tensor:
    """Launch the float-pool kernel; raises on anything it does not
    take."""
    return _launch(prefill_attention_cuda, q, k_pages, v_pages, table,
                   starts, None, None, window)


def prefill_attention_int8_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                                v_pages: torch.Tensor, table: torch.Tensor,
                                starts: torch.Tensor, k_scale: torch.Tensor,
                                v_scale: torch.Tensor, *,
                                window: int = 0) -> torch.Tensor:
    """Launch the int8-pool kernel (B4b): int8 pools with their (P, Hkv)
    fp32 scales, a bf16 or fp32 q; raises on anything it does not take."""
    if k_scale is None or v_scale is None:
        raise ValueError("prefill_attention_int8: k_scale and v_scale are "
                         "required")
    return _launch(prefill_attention_int8_cuda, q, k_pages, v_pages, table,
                   starts, k_scale, v_scale, window)


prefill_attention_cuda.launches = 0
prefill_attention_int8_cuda.launches = 0
