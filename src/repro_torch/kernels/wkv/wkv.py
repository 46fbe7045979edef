"""RWKV6 chunked WKV: the CUDA kernel's wrapper and its plain PyTorch
version.

Replaces ``repro/kernels/wkv/wkv.py::wkv_pallas``; the kernel is
``kernels/csrc/wkv.cu``; the plain version is ``models/rwkv.py``'s
``wkv_chunked`` in its direct form, the oracle
``repro/kernels/wkv/ref.py`` names.

Layout, as the JAX op's (``repro/kernels/wkv/ops.py``): r, k, v
(B, S, H, hd) fp32 or bf16, one type for all three; lw (B, S, H, hd) fp32
log-decays (<= 0); u (H, hd) fp32.  Returns o (B, S, H, hd) fp32.  The
chunk length is ``models.rwkv.chunk_len(S, chunk)``.
"""
from __future__ import annotations

import torch

from .. import cuda
from ...models.rwkv import chunk_len, wkv_chunked

# csrc/wkv.cu's tile edges: row pieces and value-column blocks of at most
# 64, key-side channels staged 64 at a time
TILE = 64


def wkv_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              lw: torch.Tensor, u: torch.Tensor, *,
              chunk: int = 64) -> torch.Tensor:
    return wkv_chunked(r, k, v, lw, u, chunk=chunk, intra="direct")[0]


def smem_bytes(rows: int, cols: int, hd: int) -> int:
    """csrc/wkv.cu's shared memory per block for row pieces of ``rows``
    and blocks of ``cols`` value columns."""
    p = min(hd, TILE)
    return 4 * (3 * rows * (p + 1) + rows * (cols + 1) + rows * (rows + 1)
                + hd * (cols + 1) + hd)


def wkv_tiles(c: int, hd: int) -> tuple:
    """(rows, cols) of csrc/wkv.cu's grid for chunk ``c`` and head width
    ``hd``: row pieces of min(c, 64) rows, and value-column blocks of
    min(hd, 64) columns, halved while the state's columns (hd x cols)
    and the tiles do not fit a block's shared memory (from hd = 566 on).
    Raises only past hd = 13,781, where even one column of the state and
    the tiles exceed it (the TPU kernel would need an hd^2 state in VMEM
    of over 600 MB there)."""
    rows, cols = min(c, TILE), min(hd, TILE)
    while cols > 1 and smem_bytes(rows, cols, hd) > cuda.MAX_SMEM_BYTES:
        cols = (cols + 1) // 2
    if smem_bytes(rows, cols, hd) > cuda.MAX_SMEM_BYTES:
        raise ValueError(f"wkv: head width {hd} leaves no room for one "
                         f"column of the state in shared memory")
    return rows, cols


def wkv_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             lw: torch.Tensor, u: torch.Tensor, *,
             chunk: int = 64) -> torch.Tensor:
    """Launch ``repro_wkv`` (one block per (batch, head, block of value
    columns), looping over the chunks with its columns of the state in
    shared memory; tiles from ``wkv_tiles``): inputs contiguous on one
    CUDA device.  Returns a new fp32 (B, S, H, hd) tensor; raises on
    anything the kernel does not take."""
    cuda.require_cuda("wkv", r, k, v, lw, u)
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, lw)):
        raise ValueError(f"wkv: want equal (B, S, H, hd) shapes for r, k, "
                         f"v and lw, got "
                         f"{[tuple(t.shape) for t in (r, k, v, lw)]}")
    b, s, h, hd = r.shape
    if u.shape != (h, hd):
        raise ValueError(f"wkv: want u of shape {(h, hd)}, got "
                         f"{tuple(u.shape)}")
    if k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"wkv: r, k and v must share one dtype, got "
                        f"{[t.dtype for t in (r, k, v)]}")
    if lw.dtype != torch.float32 or u.dtype != torch.float32:
        raise TypeError(f"wkv: lw and u must be float32, got {lw.dtype} "
                        f"and {u.dtype}")
    if chunk < 1:
        raise ValueError(f"wkv: chunk {chunk} < 1")
    out = torch.empty(r.shape, dtype=torch.float32, device=r.device)
    if out.numel() == 0:
        return out
    c = chunk_len(s, chunk)
    rows, cols = wkv_tiles(c, hd)
    rc = cuda.library().repro_wkv(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
        u.data_ptr(), out.data_ptr(),
        *cuda.c_ints("wkv", b, s, h, hd, c, rows, cols),
        cuda.dtype_code(r), cuda.stream_of(r))
    cuda.check(rc, "wkv")
    wkv_cuda.launches += 1
    return out


wkv_cuda.launches = 0
