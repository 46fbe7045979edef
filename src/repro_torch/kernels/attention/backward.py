"""The fused recompute backward of flash attention: the CUDA kernels'
wrapper and its plain PyTorch version.

Replaces ``repro/kernels/attention/backward.py::flash_attention_bwd_pallas``
(``_dq_kernel`` and ``_dkv_kernel``); the kernels are
``kernels/csrc/flash_attention_bwd.cu``.  The forward saved only the
per-row logsumexp; both versions recompute P from (q, k, lse) and fold the
softmax-gradient correction dS = P (dP - delta), with
``delta = rowsum(dO O)`` computed here in PyTorch, as the JAX function
does outside its kernels.

Layout: q (B, H, Sq, hd), k, v (B, H, Sk, hd) bf16 or fp32 (one type),
q's rows at key positions ``q_offset ..`` as in the forward; o, do (B,
H, Sq, hd) fp32; lse (B, H, Sq) fp32.  Returns dq (B, H, Sq, hd) and
dk, dv (B, H, Sk, hd) fp32 -- with Sq < Sk, this query block's part of
k/v's gradient; callers cast back to the primal dtypes.  GQA: k and v arrive expanded to
H heads, and the reduction of dk/dv over a kv head's query heads happens
outside, in autograd's backward of that expansion.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from .. import cuda
from .flash import check_aligned16, check_bhsd, check_route, masked_scores

Grads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    return (o.float() * do.float()).sum(dim=-1)


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor, *,
                              causal: bool = True, window: int = 0,
                              q_offset: int = 0) -> Grads:
    """Dense recompute, as ``backward.py:_p_and_ds`` over one tile the
    size of the sequence: P = exp(scores - lse) under the mask, dS rounded
    to q/k's type before the products with K and Q, P to dO's type."""
    hd = q.shape[-1]
    scale = 1.0 / math.sqrt(hd)
    scores = masked_scores(q, k, causal, window, q_offset)
    p = torch.where(scores > -1e30, torch.exp(scores - lse[..., None]), 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    ds = p * (dp - _delta(o, do)[..., None])
    ds_r = ds.to(q.dtype).float()
    dq = torch.einsum("bhqk,bhkd->bhqd", ds_r, k.float()) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds_r, q.float()) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(do.dtype).float(),
                      do.float())
    return dq, dk, dv


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, do: torch.Tensor, *,
                             causal: bool = True, window: int = 0,
                             q_offset: int = 0) -> Grads:
    """Launch ``repro_flash_attention_bwd_wgmma`` (dO's bf16 halves, the
    dQ sweep, then the dK/dV sweep) or ``repro_flash_attention_bwd`` (the
    two sweeps), as ``flash.flash_route`` names: q (B, H, Sq, hd) and k, v
    (B, H, Sk, hd) contiguous of one type, q's rows at key positions
    ``q_offset ..``, o and do fp32 of q's shape, lse (B, H, Sq) fp32, all
    on one CUDA device.  Counts one launch per call, and one on its route
    in ``flash_attention_bwd_cuda.routes``.  Returns new fp32 (dq, dk,
    dv); raises on anything the kernels do not take."""
    name = "flash_attention_bwd"
    cuda.require_cuda(name, q, k, v, o, lse, do)
    check_bhsd(name, q, k, v, q_offset)
    b, h, s, hd = q.shape
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (b, h, s):
        raise ValueError(f"{name}: o/do must be {tuple(q.shape)} and lse "
                         f"{(b, h, s)}, got {tuple(o.shape)}, "
                         f"{tuple(do.shape)}, {tuple(lse.shape)}")
    if any(t.dtype != torch.float32 for t in (o, lse, do)):
        raise TypeError(f"{name}: o, lse and do must be float32")
    if window < 0:
        raise ValueError(f"{name}: window {window} < 0")
    route = check_route(name, q.dtype, hd, bwd=True)
    if route == "wgmma":
        check_aligned16(name, q, k, v, do)
    delta = _delta(o, do)
    sk = k.shape[2]
    dq = torch.empty((b, h, s, hd), dtype=torch.float32, device=q.device)
    dk, dv = (torch.empty((b, h, sk, hd), dtype=torch.float32,
                          device=q.device) for _ in range(2))
    sizes = cuda.c_ints(name, b * h, s, sk, q_offset, hd, int(causal),
                        window)
    lib = cuda.library()
    if route == "wgmma":
        # dO's bf16 halves (hi, lo), written by the first kernel
        split = torch.empty((2, b, h, s, hd), dtype=torch.bfloat16,
                            device=q.device)
        rc = lib.repro_flash_attention_bwd_wgmma(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), split.data_ptr(), *sizes, cuda.stream_of(q))
    else:
        rc = lib.repro_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), *sizes, cuda.dtype_code(q), cuda.stream_of(q))
    cuda.check(rc, name)
    flash_attention_bwd_cuda.launches += 1
    flash_attention_bwd_cuda.routes[route] += 1
    return dq, dk, dv


flash_attention_bwd_cuda.launches = 0
flash_attention_bwd_cuda.routes = {"wgmma": 0, "simt": 0}
