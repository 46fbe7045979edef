"""RWKV6 chunked WKV: the CUDA kernels' wrappers (the forward and its
backward) and their plain PyTorch versions.

Replaces ``repro/kernels/wkv/wkv.py::wkv_pallas``; the kernel is
``kernels/csrc/wkv.cu``, one per route (``wkv_route``: ``mma``, the TPU
kernel's sub-chunked form on the tensor cores, at head widths 64 and 128
with sub-chunks of 8 to 64 rows; ``simt``, the direct form on the FMA
units, for every other shape); the plain version is ``models/rwkv.py``'s
``wkv_chunked`` in its direct form, the oracle
``repro/kernels/wkv/ref.py`` names.

Layout, as the JAX op's (``repro/kernels/wkv/ops.py``): r, k, v
(B, S, H, hd) fp32 or bf16, one type for all three; lw (B, S, H, hd) fp32
log-decays (<= 0); u (H, hd) fp32.  Returns o (B, S, H, hd) fp32.  The
chunk length is ``models.rwkv.chunk_len(S, chunk)``, the sub-chunk length
``subchunk_len(c, subchunk)``.

The backward (``wkv_bwd_cuda``, ``kernels/csrc/wkv_bwd.cu``) replaces no
TPU kernel: the JAX package differentiates ``wkv_chunked`` by autodiff
(``repro/models/rwkv.py:171``), and its plain version here is the
autograd of ``wkv_chunked`` (``wkv_bwd_plain``).
"""
from __future__ import annotations

import torch

from .. import cuda
# the module, not its names: models.rwkv imports dispatch, which imports
# this module, so its functions are looked up when called
from ...models import rwkv

# csrc/wkv.cu's tile edges: row pieces and value-column blocks of at most
# 64, key-side channels staged 64 at a time
TILE = 64
ROUTES = ("mma", "simt")
# the mma route's head widths (16-column tiles of the state over 8 warps,
# pairs of 8-column tiles a warp) and piece lengths (rows walked at a
# time, whole sub-chunks)
MMA_HEAD_DIMS = (64, 128)
MMA_PIECES = (64, 32, 16)


# csrc/wkv_bwd.cu: the state is stored every BWD_SEGMENT steps; head
# widths a warp's lanes split evenly, at most 4 columns (or rows) a lane
BWD_SEGMENT = 64
BWD_HEAD_DIMS = (32, 64, 128)


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a contiguous tensor whose data starts on a 16-byte
    boundary (a copy only where ``t`` is not one already)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def wkv_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              lw: torch.Tensor, u: torch.Tensor, *,
              chunk: int = 64, intra: str = "direct",
              subchunk: int = 16) -> torch.Tensor:
    """The chunked WKV from a zero state (``models.rwkv.wkv_chunked``,
    its final state dropped): o (B, S, H, hd) fp32 (fp64 for fp64
    inputs)."""
    return rwkv.wkv_chunked(r, k, v, lw, u, chunk=chunk, intra=intra,
                            subchunk=subchunk)[0]


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


def subchunk_len(c: int, subchunk: int) -> int:
    """The sub-chunk length of a chunk of ``c`` rows:
    ``min(subchunk, c)``, halved until it divides ``c``, as
    ``repro/kernels/wkv/wkv.py:106-111`` resolves it."""
    if subchunk < 1:
        raise ValueError(f"wkv: subchunk {subchunk} < 1")
    sc = min(subchunk, c)
    while sc > 1 and c % sc:
        sc //= 2
    return sc


def wkv_piece(c: int, sc: int) -> int:
    """Rows the mma route walks at a time: the largest of 64, 32 and 16
    that divides the chunk and is a whole number of sub-chunks; 0 if
    none is."""
    return next((p for p in MMA_PIECES if c % p == 0 and p % sc == 0), 0)


def wkv_route(c: int, sc: int, hd: int, dtype: torch.dtype) -> str:
    """``mma`` where the tensor-core kernel takes the shape: hd 64 or 128,
    sub-chunks a multiple of 8 rows inside a piece of 64, 32 or 16
    rows (``wkv_piece``), fp32 or bf16 inputs but not fp32 at hd 128,
    whose block does not fit shared memory (csrc/wkv.cu builds no such
    kernel); ``simt`` otherwise.  By shape alone, never by data."""
    if (hd in MMA_HEAD_DIMS and sc % 8 == 0 and wkv_piece(c, sc)
            and dtype in cuda.DTYPE_CODES
            and not (hd == 128 and dtype == torch.float32)):
        return "mma"
    return "simt"


def wkv_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             lw: torch.Tensor, u: torch.Tensor, *, chunk: int = 64,
             subchunk: int = 16) -> torch.Tensor:
    """Launch the route ``wkv_route`` names: ``repro_wkv_mma`` (one block
    of 8 warps per (batch, head), the sub-chunked form on the tensor
    cores, the state in registers) or ``repro_wkv`` (one block per
    (batch, head, block of value columns), the direct form with its
    columns of the state in shared memory; tiles from ``wkv_tiles``):
    inputs contiguous on one CUDA device, 16-byte aligned on the mma
    route.  Counts the launch in ``.launches`` and on its route in
    ``.routes``.  Returns a new fp32 (B, S, H, hd) tensor; raises on
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
    c = rwkv.chunk_len(s, chunk)
    sc = subchunk_len(c, subchunk)
    route = wkv_route(c, sc, hd, r.dtype)
    ptrs = [t.data_ptr() for t in (r, k, v, lw, u, out)]
    if route == "mma":
        if any(p % 16 for p in ptrs):
            raise ValueError("wkv: the mma route needs 16-byte aligned "
                             "inputs (cp.async copies)")
        rc = cuda.library().repro_wkv_mma(
            *ptrs, *cuda.c_ints("wkv", b, s, h, hd, sc, wkv_piece(c, sc)),
            cuda.dtype_code(r), cuda.stream_of(r))
    else:
        rows, cols = wkv_tiles(c, hd)
        rc = cuda.library().repro_wkv(
            *ptrs, *cuda.c_ints("wkv", b, s, h, hd, c, rows, cols),
            cuda.dtype_code(r), cuda.stream_of(r))
    cuda.check(rc, "wkv")
    wkv_cuda.launches += 1
    wkv_cuda.routes[route] += 1
    return out


wkv_cuda.launches = 0
wkv_cuda.routes = {route: 0 for route in ROUTES}


def wkv_bwd_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  lw: torch.Tensor, u: torch.Tensor, do: torch.Tensor, *,
                  chunk: int = 64, intra: str = "direct",
                  subchunk: int = 16) -> tuple:
    """The gradients (dr, dk, dv, dlw, du) of sum(o * do) where o =
    ``wkv_chunked(r, k, v, lw, u, ...)`` from a zero state (its final
    state unused): the autograd of the chunked form, recomputed here in
    fp32 (fp64 for fp64 inputs), the type of every gradient."""
    acc = torch.promote_types(r.dtype, torch.float32)
    with torch.enable_grad():
        leaves = [t.detach().to(acc).requires_grad_(True)
                  for t in (r, k, v, lw, u)]
        o = wkv_plain(*leaves, chunk=chunk, intra=intra,
                      subchunk=subchunk)
        return torch.autograd.grad(o, leaves, do.to(acc))


def wkv_bwd_scratch_floats(b: int, s: int, h: int, hd: int) -> int:
    """csrc/wkv_bwd.cu's scratch: the (hd, hd) state of every (batch,
    head) at each segment start, and each (batch, head)'s partial du."""
    segments = -(-s // BWD_SEGMENT)
    return b * h * (segments * hd * hd + hd)


def wkv_bwd_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lw: torch.Tensor, u: torch.Tensor,
                 do: torch.Tensor) -> tuple:
    """Launch ``repro_wkv_bwd``: the gradients (dr, dk, dv, dlw (B, S, H,
    hd), du (H, hd)), new fp32 tensors, of sum(o * do) for o the WKV
    recurrence from a zero state.  r, k, v (B, S, H, hd) one float type;
    lw, do (B, S, H, hd) and u (H, hd) fp32; all contiguous on one CUDA
    device; hd in ``BWD_HEAD_DIMS``.  The kernel computes the exact
    recurrence's gradient; the chunked forward's e^-60 clamp moves it by
    less than e^-60 of a term.  Counts the launch in ``.launches`` and on
    its one route in ``.routes``; raises on anything the kernel does not
    take."""
    cuda.require_cuda("wkv_bwd", r, k, v, lw, u, do)
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, lw, do)):
        raise ValueError(f"wkv_bwd: want equal (B, S, H, hd) shapes for r, "
                         f"k, v, lw and do, got "
                         f"{[tuple(t.shape) for t in (r, k, v, lw, do)]}")
    b, s, h, hd = r.shape
    if u.shape != (h, hd):
        raise ValueError(f"wkv_bwd: want u of shape {(h, hd)}, got "
                         f"{tuple(u.shape)}")
    if hd not in BWD_HEAD_DIMS:
        raise ValueError(f"wkv_bwd: head width {hd} is not one of "
                         f"{BWD_HEAD_DIMS}")
    if k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"wkv_bwd: r, k and v must share one dtype, got "
                        f"{[t.dtype for t in (r, k, v)]}")
    if any(t.dtype != torch.float32 for t in (lw, u, do)):
        raise TypeError(f"wkv_bwd: lw, u and do must be float32, got "
                        f"{[t.dtype for t in (lw, u, do)]}")
    grads = [torch.empty(r.shape, dtype=torch.float32, device=r.device)
             for _ in range(4)]
    du = torch.zeros((h, hd), dtype=torch.float32, device=r.device)
    if r.numel() == 0:
        return (*grads, du)
    scratch = torch.empty(wkv_bwd_scratch_floats(b, s, h, hd),
                          dtype=torch.float32, device=r.device)
    rc = cuda.library().repro_wkv_bwd(
        *(t.data_ptr() for t in (r, k, v, lw, u, do, *grads, du, scratch)),
        *cuda.c_ints("wkv_bwd", b, s, h, hd), cuda.dtype_code(r),
        cuda.stream_of(r))
    cuda.check(rc, "wkv_bwd")
    wkv_bwd_cuda.launches += 1
    wkv_bwd_cuda.routes["simt"] += 1
    return (*grads, du)


wkv_bwd_cuda.launches = 0
wkv_bwd_cuda.routes = {"simt": 0}
