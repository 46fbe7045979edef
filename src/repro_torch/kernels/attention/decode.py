"""Ragged decode attention over a paged KV cache: the CUDA kernel's
wrapper and its plain PyTorch version.

Replaces ``repro/kernels/attention/decode.py::decode_attention_pallas``;
the kernel is ``kernels/csrc/decode_attention.cu``; the plain version is
the port of ``repro/kernels/attention/ref.py::decode_attention_ref``.

Layout: q (B, H, hd) -- one token per slot, GQA-grouped so that head h
reads kv head h // grp; k_pages / v_pages (P, page, Hkv, hd); table
(B, n_pages) int32 page ids; lengths (B,) int32 valid tokens per slot
(0 = inactive slot -> zero output, no NaNs).  Returns (B, H, hd) fp32.

int8 pools (the quantized branch of the TPU kernel) come with k_scale /
v_scale (P, Hkv) f32, one scale per (page, kv head): the plain version
dequantizes at gather time, the kernel folds them into each key's score
and P (``decode_attention_int8_cuda``); q stays float.

The kernel splits each slot's key range across blocks by
``decode_split_plan`` and merges the splits in rank order.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .. import cuda


def gather_pages(pages: torch.Tensor, table: torch.Tensor,
                 scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Each slot's pages in logical order: (B, n_pages * page, Hkv, hd).
    int8 pools dequantize to fp32 through their (P, Hkv) ``scale``."""
    b = table.shape[0]
    idx = table.long()
    g = pages[idx]                       # (B, n_pages, page, Hkv, hd)
    if scale is not None:
        g = g.float() * scale[idx][:, :, None, :, None]
    return g.reshape(b, -1, pages.shape[2], pages.shape[3])


def expand_kv(kv: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, Hkv, hd) -> (B, S, H, hd): query head h reads kv head
    h // grp, the (B, Hkv, grp, hd) grouping of the kernels."""
    return kv.repeat_interleave(n_heads // kv.shape[2], dim=2)


def decode_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, table: torch.Tensor,
                           lengths: torch.Tensor,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None, *,
                           window: int = 0) -> torch.Tensor:
    """Gather pages to a dense view (dequantizing int8 pools), mask keys
    past each slot's length (and older than its window), fp32 softmax; P
    is cast to V's dtype before the P @ V product, as in the kernel (fp32
    for dequantized int8 pools)."""
    b, h, hd = q.shape
    k = expand_kv(gather_pages(k_pages, table, k_scale), h)
    v = expand_kv(gather_pages(v_pages, table, v_scale), h)
    scores = torch.einsum("bhd,bshd->bhs", q.float(), k.float()) \
        / math.sqrt(hd)
    kpos = torch.arange(k.shape[1], device=q.device)[None, :]
    lengths = lengths.long()[:, None]
    mask = kpos < lengths
    if window > 0:
        mask &= kpos >= lengths - window
    scores = torch.where(mask[:, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhs,bshd->bhd", probs.float(), v.float())
    # fully-masked rows (inactive slots, lengths == 0) -> exact zeros
    return torch.where(lengths[:, :, None] > 0, out, 0.0)


def _check_paged(name: str, q, k_pages, v_pages, table, lengths,
                 q_heads_dim: int, k_scale=None, v_scale=None,
                 device: bool = True) -> None:
    """Shapes, dtypes and (with ``device``) devices the attention kernels
    take: float pools of q's dtype, or int8 pools with their (P, Hkv)
    fp32 scales."""
    scales = () if k_scale is None and v_scale is None else (k_scale,
                                                             v_scale)
    if any(s is None for s in scales):
        raise ValueError(f"{name}: pass both k_scale and v_scale or neither")
    if device:
        cuda.require_cuda(name, q, k_pages, v_pages, table, lengths,
                          *scales)
    if q.dim() != q_heads_dim + 2:
        raise ValueError(f"{name}: q has shape {tuple(q.shape)}")
    if k_pages.shape != v_pages.shape or k_pages.dim() != 4:
        raise ValueError(f"{name}: k/v pools must share one (P, page, Hkv, "
                         f"hd) shape, got {tuple(k_pages.shape)} and "
                         f"{tuple(v_pages.shape)}")
    if not scales and not (q.dtype == k_pages.dtype == v_pages.dtype):
        raise TypeError(f"{name}: q and the pools must share one dtype")
    if scales:
        if q.dtype not in cuda.DTYPE_CODES or k_pages.dtype != torch.int8 \
                or v_pages.dtype != torch.int8:
            raise TypeError(f"{name}: scales come with int8 pools and a "
                            f"float q, got {q.dtype} and {k_pages.dtype}")
        cell = (k_pages.shape[0], k_pages.shape[2])
        for s in scales:
            if s.dtype != torch.float32 or tuple(s.shape) != cell:
                raise ValueError(f"{name}: scales must be fp32 {cell}, got "
                                 f"{s.dtype} {tuple(s.shape)}")
    if table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError(f"{name}: table and lengths/starts must be int32")
    h, hd = q.shape[q_heads_dim], q.shape[-1]
    hkv = k_pages.shape[2]
    if hd != k_pages.shape[3] or hkv == 0 or h % hkv:
        raise ValueError(f"{name}: {h} query heads of width {hd} do not "
                         f"group over pools {tuple(k_pages.shape)}")
    if table.dim() != 2 or table.shape[0] != q.shape[0] \
            or lengths.shape != (q.shape[0],):
        raise ValueError(f"{name}: table (B, n_pages) and (B,) lengths "
                         f"must match q's batch")


# the split plan (csrc/decode_attention.cu): about SPLITS blocks a slot
# (splits x kv heads), each split a whole number of pages and
# MIN_SPLIT_KEYS to MAX_SPLIT_KEYS keys.  Measured on the card (PERF.md):
# gemma-2b's one kv head runs best at 64 keys on the 256-key serving table
# and 128 at 8192; 8 and 16 kv heads at 8192 keys at 1024, 32 at 512-1024.
SPLITS, MIN_SPLIT_KEYS, MAX_SPLIT_KEYS = 64, 64, 1024
# the kernel keeps a row's columns in registers, at most 32 a lane
MAX_HEAD_DIM = 1024


def decode_split_plan(n_pages: int, page: int, hkv: int) -> tuple:
    """(split_keys, splits): block r of a slot and kv head takes the table's
    key positions [r * split_keys, (r + 1) * split_keys), and the splits
    cover the table's n_pages * page keys.  A function of the table's and
    the pools' shapes only, never of the batch or the lengths, so a slot's
    bits do not depend on which slots share its call."""
    if page <= 0:
        return 0, 1
    keys = n_pages * page
    want = min(MAX_SPLIT_KEYS,
               max(MIN_SPLIT_KEYS, -(-keys * max(1, hkv) // SPLITS)))
    per = max(1, -(-want // page))         # pages a split
    return per * page, max(1, -(-n_pages // per))


def split_keys_range(page: int) -> tuple:
    """The split sizes the kernel takes at ``page``: whole pages from
    ``MIN_SPLIT_KEYS`` to ``MAX_SPLIT_KEYS`` (each rounded up to a page),
    the range ``decode_split_plan`` chooses in.  The upper end bounds the
    key offsets a block keeps in shared memory, the lower the splits'
    fp32 partials."""
    page = max(1, page)
    return (page * max(1, -(-MIN_SPLIT_KEYS // page)),
            page * max(1, -(-MAX_SPLIT_KEYS // page)))


def planned_split(name: str, n_pages: int, page: int, hkv: int,
                  plan) -> tuple:
    """(split_keys, splits) of a call: ``decode_split_plan``'s without a
    plan, else the plan's ``{"split_keys": n}`` (a whole number of pages
    within ``split_keys_range``) applied to the call's table."""
    if not plan:
        return decode_split_plan(n_pages, page, hkv)
    n = plan["split_keys"]
    lo, hi = split_keys_range(page)
    if n % page or not lo <= n <= hi:
        raise ValueError(f"{name}: plan split_keys {n} is not a whole "
                         f"number of {page}-key pages in [{lo}, {hi}]")
    return n, max(1, -(-n_pages // (n // page)))


def _launch(wrapper, q, k_pages, v_pages, table, lengths, k_scale, v_scale,
            window: int, plan) -> torch.Tensor:
    """Launch ``repro_decode_attention`` (float pools) or its int8 entry
    (the split kernel, then the rank-order combine) and count the call on
    ``wrapper``."""
    name = "decode_attention" if k_scale is None else "decode_attention_int8"
    _check_paged(name, q, k_pages, v_pages, table, lengths, 1, k_scale,
                 v_scale)
    b, h, hd = q.shape
    _, page, hkv, _ = k_pages.shape
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head width {hd} is past the kernel's "
                         f"{MAX_HEAD_DIM} (32 columns a lane)")
    n_pages = table.shape[1]
    split_keys, splits = planned_split(name, n_pages, page, hkv, plan)
    # one allocation on the host's hot path: the output, then the splits'
    # fp32 partials (acc, then m and l), merged by the combine kernel
    n_out = b * h * hd
    n_part = b * h * splits * (hd + 2)
    buf = torch.empty(n_out + n_part, dtype=torch.float32, device=q.device)
    out = buf[:n_out].view(b, h, hd)
    if n_out == 0:
        return out
    lib = cuda.library()
    scratch = buf.data_ptr() + 4 * n_out
    sizes = cuda.c_ints(name, b, h, hkv, hd, page, n_pages,
                        k_pages.shape[0], max(0, int(window)), split_keys,
                        splits)
    if k_scale is None:
        rc = lib.repro_decode_attention(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            table.data_ptr(), lengths.data_ptr(), out.data_ptr(), scratch,
            *sizes, cuda.dtype_code(q), cuda.stream_of(q))
    else:
        rc = lib.repro_decode_attention_int8(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_scale.data_ptr(), v_scale.data_ptr(), table.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), scratch, *sizes,
            cuda.dtype_code(q), cuda.stream_of(q))
    cuda.check(rc, name)
    wrapper.launches += 1
    return out


def decode_attention_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, table: torch.Tensor,
                          lengths: torch.Tensor, *, window: int = 0,
                          plan=None) -> torch.Tensor:
    """Launch the float-pool kernel, its keys split by
    ``decode_split_plan`` or ``plan``; raises on anything it does not
    take."""
    return _launch(decode_attention_cuda, q, k_pages, v_pages, table,
                   lengths, None, None, window, plan)


def decode_attention_int8_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                               v_pages: torch.Tensor, table: torch.Tensor,
                               lengths: torch.Tensor, k_scale: torch.Tensor,
                               v_scale: torch.Tensor, *,
                               window: int = 0, plan=None) -> torch.Tensor:
    """Launch the int8-pool kernel (B4a): int8 pools with their (P, Hkv)
    fp32 scales, a bf16 or fp32 q; raises on anything it does not take."""
    if k_scale is None or v_scale is None:
        raise ValueError("decode_attention_int8: k_scale and v_scale are "
                         "required")
    return _launch(decode_attention_int8_cuda, q, k_pages, v_pages, table,
                   lengths, k_scale, v_scale, window, plan)


decode_attention_cuda.launches = 0
decode_attention_int8_cuda.launches = 0
