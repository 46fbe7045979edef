"""Error-feedback int8 gradient compression (type demotion §4.4 on the
wire): the port of ``repro/optim/compress.py``.

Each gradient leaf of at least ``min_size`` elements is corrected by the
residual of the previous step, block-quantized to int8 and dequantized;
what the quantization lost becomes the next residual, so the bias does not
accumulate.  On one device nothing crosses a wire: this is the numerics
of the compressed all-reduce, and ``compressed_wire_bytes`` its volume.
With ``sharding`` (``runtime/sharding.TrainSharding``) the leaves are
shards: ``min_size`` judges the whole leaf, and the blocks are the whole
leaf's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from ..core import tree
from ..core.memory import dequantize_block, quantize_block

Params = Any


@dataclasses.dataclass(frozen=True)
class CompressorConfig:
    block: int = 128
    enabled: bool = True
    min_size: int = 4096     # don't compress small leaves (norms, biases)


def init_residual(params: Params) -> Params:
    return tree.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32,
                              device=p.device), params)


@torch.no_grad()
def compress_gradients(grads: Params, residual: Params,
                       cfg: CompressorConfig, sharding=None
                       ) -> Tuple[Params, Params]:
    """Returns (decompressed-after-compression grads, new residual)."""
    if not cfg.enabled:
        return grads, residual
    flat_g, rebuild = tree.flatten(grads)
    comp, res = [], []
    for i, (g, r) in enumerate(zip(flat_g, tree.leaves(residual))):
        g = g.float()
        size = g.numel() if sharding is None else sharding.numel(i, g)
        if size < cfg.min_size:
            comp.append(g)
            res.append(torch.zeros_like(g))
            continue
        corrected = g + r
        if sharding is None:
            deq = dequantize_block(quantize_block(corrected, cfg.block))
        else:
            deq = sharding.dequantize(i, sharding.quantize(i, corrected,
                                                           cfg.block))
        comp.append(deq)
        res.append(corrected - deq)
    return rebuild(comp), rebuild(res)


def compressed_wire_bytes(n_elems: int, block: int = 128) -> float:
    """Bytes on the wire: int8 payload + an f32 scale per block."""
    return n_elems * (1.0 + 4.0 / block)
