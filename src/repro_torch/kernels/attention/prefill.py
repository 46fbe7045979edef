"""Ragged multi-token prefill attention over a paged KV cache: the CUDA
kernel's wrapper and its plain PyTorch version.

Replaces ``repro/kernels/attention/prefill.py::prefill_attention_pallas``;
the kernel is ``kernels/csrc/prefill_attention.cu``, one per route
(``prefill_route``: ``wgmma`` for bf16 q at head widths 64, 128 and 256
with the GQA group dividing 64, ``simt`` otherwise; the wgmma route splits
a slot's keys by ``prefill_split_plan``); the plain version is the port
of ``repro/kernels/attention/ref.py::prefill_attention_ref``.

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
from . import flash
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


# the wgmma route's split plan (csrc/prefill_attention.cu): about
# SPLIT_BLOCKS blocks a slot (128-row tiles x kv heads x splits), each split
# a whole number of pages and of 64-key tiles, of MIN_SPLIT_KEYS x 256 / hd
# (a block's fixed cost against its tiles' work) to MAX_SPLIT_KEYS keys and
# about MAX_SPLIT_PAGES pages (the page list a block keeps in shared
# memory).  Measured on the card (PERF.md): 512 keys at gemma-2b's heads
# and 8192 keys, 4096 at codeqwen1.5-7b's.
SPLIT_BLOCKS, MIN_SPLIT_KEYS, MAX_SPLIT_KEYS = 64, 512, 4096
MAX_SPLIT_PAGES = 1024
ROUTES = {"simt": 0, "wgmma": 1}
BLOCK_ROWS = 128    # flattened query rows a block of the wgmma route


def prefill_route(dtype: torch.dtype, hd: int, grp: int) -> str:
    """The kernel's route from the query type, head width and GQA group
    alone: ``wgmma`` (tensor cores, TMA through the page table) for bf16
    at the head widths it is built for (``flash.WGMMA_HEAD_DIMS``) where
    64-row tiles hold whole tokens (grp divides 64), float or int8 pools;
    ``simt`` (fp32 FMA units) for fp32 and every other shape."""
    return ("wgmma" if dtype == torch.bfloat16
            and hd in flash.WGMMA_HEAD_DIMS and 0 < grp <= 64
            and 64 % grp == 0 else "simt")


def prefill_split_plan(n_pages: int, page: int, hkv: int, grp: int, c: int,
                       hd: int) -> tuple:
    """(split_keys, splits) of the wgmma route: block r of a (slot, kv
    head, row tile) takes the table's key positions [r * split_keys,
    (r + 1) * split_keys), and the splits cover the table's n_pages * page
    keys.  A function of the table's, the pools' and the chunk's shapes
    only, never of the batch or the starts, so a slot's bits do not depend
    on which slots share its call."""
    unit = math.lcm(max(1, page), 64)
    keys = n_pages * page
    if keys <= 0:
        return unit, 1
    blocks = -(-c * grp // BLOCK_ROWS) * max(1, hkv)
    want = -(-keys // max(1, -(-SPLIT_BLOCKS // blocks)))
    want = min(MAX_SPLIT_KEYS, MAX_SPLIT_PAGES * page,
               max(MIN_SPLIT_KEYS * 256 // hd, want))
    split = -(-want // unit) * unit
    return split, -(-keys // split)


def _launch(wrapper, q, k_pages, v_pages, table, starts, k_scale, v_scale,
            window: int) -> torch.Tensor:
    """Launch ``repro_prefill_attention`` (float pools) or its int8 entry
    on the route ``prefill_route`` names (wgmma: the split kernel, then the
    rank-order combine where the plan splits; simt: grid slot x kv head x
    tiles of 32 rows) and count the call on ``wrapper``."""
    name = "prefill_attention" if k_scale is None \
        else "prefill_attention_int8"
    _check_paged(name, q, k_pages, v_pages, table, starts, 2, k_scale,
                 v_scale)
    b, c, h, hd = q.shape
    n_pool, page, hkv, _ = k_pages.shape
    n_pages = table.shape[1]
    route = prefill_route(q.dtype, hd, h // hkv)
    if route == "wgmma":
        flash.check_aligned16(name, q, k_pages, v_pages)
        split_keys, splits = prefill_split_plan(n_pages, page, hkv, h // hkv,
                                                c, hd)
    elif flash.simt_smem_bytes(hd) > cuda.MAX_SMEM_BYTES:
        # the simt kernel keeps the tiles of flash.py's simt forward
        raise ValueError(f"{name}: head width {hd} needs "
                         f"{flash.simt_smem_bytes(hd)} bytes of shared "
                         f"memory on the simt route")
    else:
        split_keys, splits = 0, 1
    # one allocation: the output, then (several splits) the splits' fp32
    # partials (acc, then m and l), merged by the combine kernel
    n_out = b * c * h * hd
    n_part = b * c * h * splits * (hd + 2) if splits > 1 else 0
    buf = torch.empty(n_out + n_part, dtype=torch.float32, device=q.device)
    out = buf[:n_out].view(b, c, h, hd)
    if b == 0 or c == 0:
        return out
    lib = cuda.library()
    scratch = buf.data_ptr() + 4 * n_out
    sizes = cuda.c_ints(name, b, c, h, hkv, hd, page, n_pages, n_pool,
                        max(0, int(window)), split_keys, splits,
                        ROUTES[route])
    cuda.c_ints(name, n_pool * page, b * c)
    if k_scale is None:
        rc = lib.repro_prefill_attention(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            table.data_ptr(), starts.data_ptr(), out.data_ptr(), scratch,
            *sizes, cuda.dtype_code(q), cuda.stream_of(q))
    else:
        rc = lib.repro_prefill_attention_int8(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_scale.data_ptr(), v_scale.data_ptr(), table.data_ptr(),
            starts.data_ptr(), out.data_ptr(), scratch, *sizes,
            cuda.dtype_code(q), cuda.stream_of(q))
    cuda.check(rc, name)
    wrapper.launches += 1
    wrapper.routes[route] += 1
    return out


def prefill_attention_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, table: torch.Tensor,
                           starts: torch.Tensor, *,
                           window: int = 0) -> torch.Tensor:
    """Launch the float-pool kernel (B3); counts one launch per call, and
    one on its route in ``.routes``; raises on anything it does not
    take."""
    return _launch(prefill_attention_cuda, q, k_pages, v_pages, table,
                   starts, None, None, window)


def prefill_attention_int8_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                                v_pages: torch.Tensor, table: torch.Tensor,
                                starts: torch.Tensor, k_scale: torch.Tensor,
                                v_scale: torch.Tensor, *,
                                window: int = 0) -> torch.Tensor:
    """Launch the int8-pool kernel (B4b): int8 pools with their (P, Hkv)
    fp32 scales, a bf16 or fp32 q; counts as ``prefill_attention_cuda``
    does; raises on anything it does not take."""
    if k_scale is None or v_scale is None:
        raise ValueError("prefill_attention_int8: k_scale and v_scale are "
                         "required")
    return _launch(prefill_attention_int8_cuda, q, k_pages, v_pages, table,
                   starts, k_scale, v_scale, window)


prefill_attention_cuda.launches = 0
prefill_attention_cuda.routes = {"wgmma": 0, "simt": 0}
prefill_attention_int8_cuda.launches = 0
prefill_attention_int8_cuda.routes = {"wgmma": 0, "simt": 0}
