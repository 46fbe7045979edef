"""Memory transformations (paper §4) -- the port of
``repro/core/memory.py``.

* §4.4 type demotion: which dtype each class of tensor uses
  (``DtypePolicy``), and the block-scaled int8 container of int8 Adam
  moments and gradient compression (``QuantizedBlock``); on the card
  also the int8-weight GEMM (B5) and the int8 KV pools (B4a/B4b).
* §4.3 striping: sharding is striping (``runtime/sharding.py``); here
  the byte accounting used for napkin math.
* §4.1/4.2 access extraction and oversubscription: the kernels' own
  ``cp.async`` / TMA rings on the card; ``prefetched_scan`` is the
  pattern on the host.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Optional

import torch


@dataclasses.dataclass(frozen=True)
class DtypePolicy:
    """Which dtype each class of tensor uses (the demotion decisions)."""

    param: torch.dtype = torch.float32       # master weights
    compute: torch.dtype = torch.bfloat16    # matmul inputs and activations
    # accumulators are fp32 throughout: the kernels and their plain
    # versions accumulate and take softmax in fp32 (the JAX ``accum``)
    moment: torch.dtype = torch.float32      # optimizer moments

    def bytes_per_param(self, *, adam: bool = True,
                        int8_moments: bool = False) -> float:
        """Napkin math for HBM residency per parameter."""
        b = self.param.itemsize + self.compute.itemsize
        if adam:
            per_moment = 1 + 4 / 128 if int8_moments \
                else self.moment.itemsize
            b += 2 * per_moment
        return float(b)


BF16_POLICY = DtypePolicy()
F32_POLICY = DtypePolicy(compute=torch.float32)


# --------------------------------------------------------------------------
# §4.4 Type demotion: block-scaled int8 container
# --------------------------------------------------------------------------

class QuantizedBlock:
    """Block-scaled int8: values in [-127, 127] with one fp32 scale per
    block of ``block`` elements along the last axis.  Symmetric,
    round-to-nearest-even.  Used by int8 Adam moments
    (``optim/adamw.py``) and gradient compression (``optim/compress.py``);
    ``core/tree.py`` flattens it to its (q, scale) leaves."""

    __slots__ = ("q", "scale", "block")

    def __init__(self, q: torch.Tensor, scale: torch.Tensor,
                 block: int = 128):
        self.q = q            # int8, the original shape
        self.scale = scale    # fp32, (*lead, n_blocks)
        self.block = block

    def __repr__(self):
        return (f"QuantizedBlock(q={tuple(self.q.shape)}, "
                f"scale={tuple(self.scale.shape)}, block={self.block})")


def _pad_last(x: torch.Tensor, block: int) -> torch.Tensor:
    pad = (-x.shape[-1]) % block
    return torch.nn.functional.pad(x, (0, pad)) if pad else x


def quantize_block(x: torch.Tensor, block: int = 128) -> QuantizedBlock:
    """The JAX package's ``quantize_block``: blocks run along the last
    axis only, so every leading axis keeps its layout."""
    squeeze = x.dim() == 0
    if squeeze:
        x = x[None]
    last = x.shape[-1]
    xf = _pad_last(x.float(), block)
    blocks = xf.reshape(xf.shape[:-1] + (-1, block))
    amax = blocks.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, 1.0)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    q = q.reshape(xf.shape)[..., :last]
    return QuantizedBlock(q[0] if squeeze else q, scale[..., 0], block)


def dequantize_block(qb: QuantizedBlock) -> torch.Tensor:
    q = qb.q[None] if qb.q.dim() == 0 else qb.q
    last = q.shape[-1]
    qf = _pad_last(q.float(), qb.block)
    blocks = qf.reshape(qf.shape[:-1] + (-1, qb.block))
    out = (blocks * qb.scale[..., None]).reshape(qf.shape)[..., :last]
    return out[0] if qb.q.dim() == 0 else out


def quantized_bytes(n_elems: int, block: int = 128) -> float:
    """Wire/HBM bytes for a block-int8 tensor (napkin math)."""
    return n_elems * (1 + 4.0 / block)


# --------------------------------------------------------------------------
# §4.3 Striping: byte accounting for sharded residency
# --------------------------------------------------------------------------

def striped_bytes_per_chip(total_bytes: float, stripe_ways: int) -> float:
    """RAID-0 over the mesh: each card holds 1/stripe_ways of the array."""
    return total_bytes / max(stripe_ways, 1)


# --------------------------------------------------------------------------
# §4.1/4.2 Access extraction + oversubscription: a prefetching scan
# --------------------------------------------------------------------------

def _stack(ys: list):
    """Stack a scan's per-step outputs: tensors along a new leading axis,
    tuples and lists element by element, ``None`` stays ``None``."""
    first = ys[0]
    if first is None:
        return None
    if isinstance(first, (tuple, list)):
        return type(first)(_stack([y[i] for y in ys])
                           for i in range(len(first)))
    return torch.stack(ys)


def prefetched_scan(body: Callable, init, xs, *, prefetch: int = 1,
                    device: Optional[torch.device] = None):
    """``jax.lax.scan`` on the host, with the load of elements
    t+1..t+prefetch issued before the body of step t runs.

    ``body(carry, x) -> (carry, y)``; ``xs`` is a tensor or a tuple/list
    of tensors scanned along their leading axis.  Returns the final carry
    and the stacked ``y``s.  With ``device``, each element is copied
    there with ``non_blocking=True`` ``prefetch`` steps ahead of its use,
    so a copy from pinned host memory overlaps the steps before it (the
    TPU package leaves this to XLA's software pipelining and
    ``pallas_call``'s DMA pipeline)."""
    seq = tuple(xs) if isinstance(xs, (tuple, list)) else (xs,)
    n = seq[0].shape[0]

    def load(t):
        items = tuple(x[t] if device is None
                      else x[t].to(device, non_blocking=True) for x in seq)
        return type(xs)(items) if isinstance(xs, (tuple, list)) \
            else items[0]

    ahead = collections.deque(load(t) for t in range(min(n, prefetch + 1)))
    carry, ys = init, []
    for t in range(n):
        carry, y = body(carry, ahead.popleft())
        ys.append(y)
        if t + prefetch + 1 < n:
            ahead.append(load(t + prefetch + 1))
    return carry, (_stack(ys) if ys else None)
