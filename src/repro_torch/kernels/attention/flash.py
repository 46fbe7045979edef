"""Dense causal / sliding-window flash attention with the logsumexp
residual: the CUDA kernel's wrapper and its plain PyTorch version.

Replaces ``repro/kernels/attention/flash.py::flash_attention_pallas``;
the kernels are ``kernels/csrc/flash_attention.cu``, one per route
(``flash_route``: ``wgmma`` for bf16 at head widths 64, 128 and 256,
``simt`` otherwise); the plain version is
the port of ``repro/kernels/attention/ref.py::attention_ref`` and
``::attention_lse_ref``.

Layout: q (B, H, Sq, hd), k, v (B, H, Sk, hd), bf16 or fp32, one type
for all three.  q's rows sit at key positions ``q_offset .. q_offset +
Sq - 1`` (default 0; Sq == Sk is self-attention over the whole
sequence, a smaller Sq one rank's block of a sequence-striped layer),
and the causal and window masks read those positions.  Returns o (B, H,
Sq, hd) fp32 and, with ``return_lse``, the per-row logsumexp of the
masked scaled scores, lse (B, H, Sq) fp32 -- the only forward state the
fused backward (``backward.py``) needs beyond q/k/v/o.
"""
from __future__ import annotations

import math

import torch

from .. import cuda


def masked_scores(q: torch.Tensor, k: torch.Tensor, causal: bool,
                  window: int, q_offset: int = 0) -> torch.Tensor:
    """Dense (B, H, Sq, Sk) fp32 scaled scores, masked to -1e30 outside
    the causal / window band of q's rows at positions ``q_offset + i``:
    the one definition of the mask semantics."""
    sq, hd, sk = q.shape[2], q.shape[3], k.shape[2]
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) \
        / math.sqrt(hd)
    qpos = torch.arange(q_offset, q_offset + sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    return torch.where(mask, scores, -1e30)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          return_lse: bool = False, q_offset: int = 0):
    """Dense fp32 softmax over the masked scores; P is cast to V's dtype
    before the P @ V product, as in the kernel."""
    scores = masked_scores(q, k, causal, window, q_offset)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", probs.float(), v.float())
    if return_lse:
        return out, torch.logsumexp(scores, dim=-1)
    return out


def check_bhsd(name: str, q: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor, q_offset: int = 0) -> None:
    """q (B, H, Sq, hd) and equal k, v (B, H, Sk, hd) of one float dtype,
    q's rows inside the keys: 0 <= q_offset, q_offset + Sq <= Sk."""
    tensors = (q, k, v)
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 \
            or q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"{name}: want q (B, H, Sq, hd) and k, v (B, H, "
                         f"Sk, hd), got {[tuple(t.shape) for t in tensors]}")
    if q_offset < 0 or q_offset + q.shape[2] > k.shape[2]:
        raise ValueError(f"{name}: q's {q.shape[2]} rows at offset "
                         f"{q_offset} do not lie in {k.shape[2]} keys")
    if any(t.dtype != q.dtype for t in tensors):
        raise TypeError(f"{name}: q, k and v must share one dtype, got "
                        f"{[t.dtype for t in tensors]}")
    cuda.dtype_code(q)


# head widths the wgmma kernels are instantiated for (the repo's archs)
WGMMA_HEAD_DIMS = (64, 128, 256)


def flash_route(dtype: torch.dtype, hd: int) -> str:
    """The route of both flash kernels (forward and backward), from the
    input type and head width alone: ``wgmma`` (tensor cores, TMA) for
    bf16 at the head widths it is built for, ``simt`` (fp32 FMA units)
    for fp32 and every other head width."""
    return ("wgmma" if dtype == torch.bfloat16 and hd in WGMMA_HEAD_DIMS
            else "simt")


def simt_smem_bytes(hd: int, bwd: bool = False) -> int:
    """Shared memory per block of the simt route's forward, or with
    ``bwd`` of its larger (dK/dV) backward kernel; the wrappers raise
    where it exceeds a block's limit (hd > 445 forward, > 291 backward)."""
    if bwd:
        return 4 * (2 * 32 * (hd + 1) + 4 * 32 * hd + 2 * 32 * 32 + 2 * 32)
    return 4 * (2 * 32 * hd + 32 * (hd + 1) + 32 * hd + 32 * 32 + 3 * 32)


def check_route(name: str, dtype: torch.dtype, hd: int,
                bwd: bool = False) -> str:
    """The route for (dtype, hd); raises where the simt route's tiles do
    not fit a block's shared memory."""
    route = flash_route(dtype, hd)
    if route == "simt" and simt_smem_bytes(hd, bwd) > cuda.MAX_SMEM_BYTES:
        raise ValueError(f"{name}: head width {hd} needs "
                         f"{simt_smem_bytes(hd, bwd)} bytes of shared "
                         f"memory on the simt route")
    return route


def check_aligned16(name: str, *tensors: torch.Tensor) -> None:
    """The wgmma route's inputs start on 16-byte boundaries (TMA and the
    16-byte loads read only from such); raises otherwise."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: the wgmma route needs inputs whose data "
                         f"starts on a 16-byte boundary")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         return_lse: bool = False, q_offset: int = 0):
    """Launch ``repro_flash_attention_wgmma`` (grid: batch x head, tiles
    of 64 query rows) or ``repro_flash_attention`` (tiles of 32), as
    ``flash_route`` names: q (B, H, Sq, hd) and k, v (B, H, Sk, hd)
    contiguous, of one type on one CUDA device, q's rows at key positions
    ``q_offset ..``.  Counts one launch per call, and one on its route in
    ``flash_attention_cuda.routes``.  Returns new fp32 o (and lse); raises
    on anything the kernels do not take."""
    cuda.require_cuda("flash_attention", q, k, v)
    check_bhsd("flash_attention", q, k, v, q_offset)
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")
    b, h, s, hd = q.shape
    route = check_route("flash_attention", q.dtype, hd)
    if route == "wgmma":
        check_aligned16("flash_attention", q, k, v)
    out = torch.empty((b, h, s, hd), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    sizes = cuda.c_ints("flash_attention", b * h, s, k.shape[2], q_offset,
                        hd, int(causal), window)
    lib = cuda.library()
    if route == "wgmma":
        rc = lib.repro_flash_attention_wgmma(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), *sizes, cuda.stream_of(q))
    else:
        rc = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), *sizes, cuda.dtype_code(q), cuda.stream_of(q))
    cuda.check(rc, "flash_attention")
    flash_attention_cuda.launches += 1
    flash_attention_cuda.routes[route] += 1
    return (out, lse) if return_lse else out


flash_attention_cuda.launches = 0
flash_attention_cuda.routes = {"wgmma": 0, "simt": 0}
