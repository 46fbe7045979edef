"""Flash attention's forward and backward on ``meta`` tensors: what the
CUDA kernels hold and move, for the dry run (``launch/dryrun.py``).

On ``meta`` nothing runs, so the plain versions' dense (B, H, S, S)
scores would only inflate the dry run's account: the kernels keep their
tiles on the chip and write nothing of that size.  Here each of them is
one op (``repro_torch::flash_attention_meta`` and ``..._bwd_meta``)
whose outputs are the kernel wrapper's: out and lse (fp32) forward; the
fp32 dq, dk, dv backward, with ``delta = rowsum(dO O)`` computed before
it and the wgmma route's bf16 halves of dO allocated around it, as
``flash_attention_bwd_cuda`` does.  So ``roofline.analysis`` counts the
kernels' operand and output bytes and their live set.

The FLOP formulas are the plain versions' dense products, as
``FlopCounterMode`` counts them: 4 B H Sq Sk hd forward (Q K^T, P V; a
query block at an offset has Sq < Sk) and 10 backward (S recomputed, then dP, dV, dQ, dK); masked tiles are
counted, as in the JAX reference lowering.  The ops have no kernel on
any other device.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from .backward import Grads, _delta
from .flash import flash_route

_FWD = "repro_torch::flash_attention_meta"
_BWD = "repro_torch::flash_attention_bwd_meta"


@torch.library.custom_op(_FWD, mutates_args=())
def _fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
         window: int, q_offset: int) -> Tuple[torch.Tensor, torch.Tensor]:
    raise RuntimeError(f"{_FWD} runs on meta tensors only")


@_fwd.register_fake
def _fwd_fake(q, k, v, causal, window, q_offset):
    b, h, s, hd = q.shape
    return (q.new_empty((b, h, s, hd), dtype=torch.float32),
            q.new_empty((b, h, s), dtype=torch.float32))


@torch.library.custom_op(_BWD, mutates_args=())
def _bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         o: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
         do: torch.Tensor, causal: bool, window: int, q_offset: int
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    raise RuntimeError(f"{_BWD} runs on meta tensors only")


@_bwd.register_fake
def _bwd_fake(q, k, v, o, lse, delta, do, causal, window, q_offset):
    return tuple(q.new_empty(t.shape, dtype=torch.float32)
                 for t in (q, k, v))


@register_flop_formula(torch.ops.repro_torch.flash_attention_meta)
def _fwd_flops(q_shape, k_shape, *args, out_shape=None, **kwargs) -> int:
    b, h, sq, hd = q_shape
    return 4 * b * h * sq * k_shape[2] * hd


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd_meta)
def _bwd_flops(q_shape, k_shape, *args, out_shape=None, **kwargs) -> int:
    b, h, sq, hd = q_shape
    return 10 * b * h * sq * k_shape[2] * hd


def flash_attention_meta(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         return_lse: bool = False, q_offset: int = 0):
    """``flash_attention_cuda``'s outputs on meta q (B, H, Sq, hd), k, v
    (B, H, Sk, hd) tensors."""
    out, lse = torch.ops.repro_torch.flash_attention_meta(
        q, k, v, bool(causal), int(window), int(q_offset))
    return (out, lse) if return_lse else out


def flash_attention_bwd_meta(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, do: torch.Tensor, *,
                             causal: bool = True, window: int = 0,
                             q_offset: int = 0) -> Grads:
    """``flash_attention_bwd_cuda``'s outputs and scratch on meta
    tensors."""
    delta = _delta(o, do)
    split = (q.new_empty((2, *q.shape), dtype=torch.bfloat16)
             if flash_route(q.dtype, q.shape[-1]) == "wgmma" else None)
    grads = torch.ops.repro_torch.flash_attention_bwd_meta(
        q, k, v, o, lse, delta, do, bool(causal), int(window),
        int(q_offset))
    del split
    return grads
