"""AdamW written out in PyTorch, with an int8-moment variant (§4.4):
the port of ``repro/optim/adamw.py``.

The int8 variant stores both moments as block-scaled int8
(``core.memory.QuantizedBlock``), re-quantized from the freshly updated
fp32 value every step.

Unlike the JAX function, ``adamw_update`` updates float params and fp32
moments in place (under ``torch.no_grad``) and returns the same tensors:
at full width a second copy of params and moments (30 GB for gemma-2b)
would not fit beside the first on one card.  The arithmetic is the JAX
package's, operation for operation.

With ``sharding`` (``runtime/sharding.TrainSharding``) every leaf is this
rank's shard: the global norm adds each leaf's squares over the ranks
that hold its parts (a replicated leaf counted once), and int8 moments
hold the whole leaf's blocks (``TrainSharding.quantize``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from ..core import tree
from ..core.memory import QuantizedBlock, dequantize_block, quantize_block

Params = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    int8_moments: bool = False
    moment_block: int = 128
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class AdamWState(NamedTuple):
    count: torch.Tensor  # int32 scalar on the params' device
    m: Params            # fp32 tree, or QuantizedBlock tree
    v: Params


def _q(x: torch.Tensor, cfg: AdamWConfig) -> QuantizedBlock:
    return quantize_block(x, cfg.moment_block)


def adamw_init(params: Params, cfg: AdamWConfig) -> AdamWState:
    def zero_like(p):
        z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return _q(z, cfg) if cfg.int8_moments else z

    flat = tree.leaves(params)
    device = flat[0].device if flat else None
    return AdamWState(
        count=torch.zeros((), dtype=torch.int32, device=device),
        m=tree.tree_map(zero_like, params), v=tree.tree_map(zero_like,
                                                            params))


def lr_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay to ``min_lr_ratio``, in fp32 (a 0-d
    tensor on ``step``'s device)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    scale = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * scale


def global_norm(grads: Params, sharding=None) -> torch.Tensor:
    """The norm of the whole gradient; with ``sharding``, of the leaves
    whose shards ``grads`` holds (the same bits on every rank)."""
    if sharding is None:
        return torch.sqrt(sum(g.float().square().sum()
                              for g in tree.leaves(grads)))
    return torch.sqrt(sum(sharding.norm_sq(tree.leaves(grads))))


def _clip_scale(gnorm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)


def clip_by_global_norm(grads: Params, max_norm: float
                        ) -> Tuple[Params, torch.Tensor]:
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, max_norm)
    return tree.tree_map(lambda g: g * scale.to(g.dtype), grads), gnorm


@torch.no_grad()
def adamw_update(grads: Params, state: AdamWState, params: Params,
                 cfg: AdamWConfig, sharding=None
                 ) -> Tuple[Params, AdamWState, Dict]:
    """One clipped AdamW step.  Float params and fp32 moments are updated
    in place; int8 moments are re-quantized into new blocks.  Returns
    (params, state, {"grad_norm", "lr"}).  ``sharding``: the leaves are
    shards laid out by it."""
    gnorm = global_norm(grads, sharding)
    scale = _clip_scale(gnorm, cfg.grad_clip)
    count = state.count + 1
    lr = lr_schedule(cfg, count)
    c1 = 1.0 - cfg.b1 ** count.to(torch.float32)
    c2 = 1.0 - cfg.b2 ** count.to(torch.float32)

    def deq(i, qb):
        return dequantize_block(qb) if sharding is None \
            else sharding.dequantize(i, qb)

    def req(i, x):
        return _q(x, cfg) if sharding is None \
            else sharding.quantize(i, x, cfg.moment_block)

    def upd(i, p, g, m, v):
        # the clip of clip_by_global_norm, one leaf at a time
        g = (g * scale.to(g.dtype)).float()
        quantized = isinstance(m, QuantizedBlock)
        mf = deq(i, m) if quantized else m
        vf = deq(i, v) if quantized else v
        mf.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        vf.mul_(cfg.b2).add_((1 - cfg.b2) * g.square())
        step_ = (mf / c1).div_((vf / c2).sqrt_().add_(cfg.eps))
        pf = p if p.dtype == torch.float32 else p.float()
        # decoupled weight decay on the master weight
        step_.add_(cfg.weight_decay * pf)
        pf.sub_(lr * step_)
        if pf is not p:
            p.copy_(pf)
        if quantized:
            return p, req(i, mf), req(i, vf)
        return p, mf, vf

    flat_p, rebuild = tree.flatten(params)
    flat_g = tree.leaves(grads)
    flat_m, rebuild_m = tree.flatten(state.m, _is_qb)
    flat_v, rebuild_v = tree.flatten(state.v, _is_qb)
    out = [upd(i, p, g, m, v) for i, (p, g, m, v)
           in enumerate(zip(flat_p, flat_g, flat_m, flat_v))]
    return (rebuild([o[0] for o in out]),
            AdamWState(count, rebuild_m([o[1] for o in out]),
                       rebuild_v([o[2] for o in out])),
            {"grad_norm": gnorm, "lr": lr})


def _is_qb(x) -> bool:
    return isinstance(x, QuantizedBlock)
