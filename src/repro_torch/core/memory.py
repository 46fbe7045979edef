"""Type demotion (paper §4.4): which dtype each class of tensor uses, and
the block-scaled int8 container of int8 Adam moments and gradient
compression -- the port of ``repro/core/memory.py``'s policy and
``QuantizedBlock``."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class DtypePolicy:
    """Which dtype each class of tensor uses (the demotion decisions)."""

    param: torch.dtype = torch.float32       # master weights
    compute: torch.dtype = torch.bfloat16    # matmul inputs and activations
    # accumulators are fp32 throughout: the kernels and their plain
    # versions accumulate and take softmax in fp32 (the JAX ``accum``)


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
