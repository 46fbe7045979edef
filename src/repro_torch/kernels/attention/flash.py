"""Dense causal / sliding-window flash attention with the logsumexp
residual: the CUDA kernel's wrapper and its plain PyTorch version.

Replaces ``repro/kernels/attention/flash.py::flash_attention_pallas``;
the kernel is ``kernels/csrc/flash_attention.cu``; the plain version is
the port of ``repro/kernels/attention/ref.py::attention_ref`` and
``::attention_lse_ref``.

Layout: q, k, v (B, H, S, hd), bf16 or fp32, one type for all three.
Returns o (B, H, S, hd) fp32 and, with ``return_lse``, the per-row
logsumexp of the masked scaled scores, lse (B, H, S) fp32 -- the only
forward state the fused backward (``backward.py``) needs beyond q/k/v/o.
"""
from __future__ import annotations

import math

import torch

from .. import cuda


def masked_scores(q: torch.Tensor, k: torch.Tensor, causal: bool,
                  window: int) -> torch.Tensor:
    """Dense (B, H, S, S) fp32 scaled scores, masked to -1e30 outside the
    causal / window band: the one definition of the mask semantics."""
    s, hd = q.shape[2], q.shape[3]
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) \
        / math.sqrt(hd)
    pos = torch.arange(s, device=q.device)
    qpos, kpos = pos[:, None], pos[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    return torch.where(mask, scores, -1e30)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          return_lse: bool = False):
    """Dense fp32 softmax over the masked scores; P is cast to V's dtype
    before the P @ V product, as in the kernel."""
    scores = masked_scores(q, k, causal, window)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", probs.float(), v.float())
    if return_lse:
        return out, torch.logsumexp(scores, dim=-1)
    return out


def check_bhsd(name: str, *tensors: torch.Tensor) -> None:
    """Equal (B, H, S, hd) shapes of one float dtype, and a head width
    whose tiles fit a block's shared memory."""
    q = tensors[0]
    if q.dim() != 4 or any(t.shape != q.shape for t in tensors):
        raise ValueError(f"{name}: want equal (B, H, S, hd) shapes, got "
                         f"{[tuple(t.shape) for t in tensors]}")
    if any(t.dtype != q.dtype for t in tensors):
        raise TypeError(f"{name}: q, k and v must share one dtype, got "
                        f"{[t.dtype for t in tensors]}")
    cuda.dtype_code(q)


def _smem_bytes(hd: int) -> int:
    """csrc/flash_attention.cu's shared memory per block."""
    return 4 * (2 * 32 * hd + 32 * (hd + 1) + 32 * hd + 32 * 32 + 3 * 32)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         return_lse: bool = False):
    """Launch ``repro_flash_attention`` (grid: batch x head, tiles of 32
    query rows): q, k, v contiguous (B, H, S, hd) of one type on one CUDA
    device.  Returns new fp32 o (and lse); raises on anything the kernel
    does not take."""
    cuda.require_cuda("flash_attention", q, k, v)
    check_bhsd("flash_attention", q, k, v)
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")
    b, h, s, hd = q.shape
    if _smem_bytes(hd) > cuda.MAX_SMEM_BYTES:
        raise ValueError(f"flash_attention: head width {hd} needs "
                         f"{_smem_bytes(hd)} bytes of shared memory")
    out = torch.empty((b, h, s, hd), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    rc = cuda.library().repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(),
        *cuda.c_ints("flash_attention", b * h, s, hd, int(causal), window),
        cuda.dtype_code(q), cuda.stream_of(q))
    cuda.check(rc, "flash_attention")
    flash_attention_cuda.launches += 1
    return (out, lse) if return_lse else out


flash_attention_cuda.launches = 0
