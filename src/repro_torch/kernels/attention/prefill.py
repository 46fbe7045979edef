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
causality).  Returns (B, C, H, hd) fp32.
"""
from __future__ import annotations

import math

import torch

from .. import cuda
from .decode import _check_paged, expand_kv, gather_pages


def prefill_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                            v_pages: torch.Tensor, table: torch.Tensor,
                            starts: torch.Tensor, *,
                            window: int = 0) -> torch.Tensor:
    """Gather pages to a dense view, mask causally against each chunk's
    positions (and by the window), fp32 softmax; P is cast to V's dtype
    before the P @ V product, as in the kernel."""
    b, c, h, hd = q.shape
    k = expand_kv(gather_pages(k_pages, table), h)
    v = expand_kv(gather_pages(v_pages, table), h)
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


def prefill_attention_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, table: torch.Tensor,
                           starts: torch.Tensor, *,
                           window: int = 0) -> torch.Tensor:
    """Launch ``repro_prefill_attention`` (grid: slot x kv head x tiles of
    32 flattened query rows); raises on anything the kernel does not
    take."""
    _check_paged("prefill_attention", q, k_pages, v_pages, table, starts,
                 q_heads_dim=2)
    b, c, h, hd = q.shape
    _, page, hkv, _ = k_pages.shape
    smem = 4 * (2 * 32 * hd + 32 * (2 * hd + 1) + 32 * 32 + 3 * 32)
    if smem > cuda.MAX_SMEM_BYTES:
        raise ValueError(f"prefill_attention: head width {hd} needs {smem} "
                         f"bytes of shared memory")
    out = torch.empty((b, c, h, hd), dtype=torch.float32, device=q.device)
    if b == 0 or c == 0:
        return out
    rc = cuda.library().repro_prefill_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        table.data_ptr(), starts.data_ptr(), out.data_ptr(),
        *cuda.c_ints("prefill_attention", b, c, h, hkv, hd, page,
                     table.shape[1], k_pages.shape[0], max(0, int(window))),
        cuda.dtype_code(q), cuda.stream_of(q))
    cuda.check(rc, "prefill_attention")
    prefill_attention_cuda.launches += 1
    return out


prefill_attention_cuda.launches = 0
