"""The training step: gradients of the loss, optional microbatch
accumulation and gradient compression, and the clipped AdamW update --
the port of ``repro/train/steps.py``.

JAX fuses the step into one jit; here it is eager.  Gradients come from
``torch.autograd.grad`` over the param leaves, and the update writes the
params and fp32 moments in place (``optim/adamw.py``).

With ``grad_shardings`` (``runtime/sharding.TrainSharding``) the params,
moments and residual are this rank's shards and the batch its rows: the
loss runs gather-at-use (``ExecOptions.sharding``), so every
microbatch's gradients arrive in the stored layout, as JAX constrains
them; the norm, the compression and the int8 moments see whole leaves.

``abstract_train_state`` is the dry run's currency: the state on
``meta``, nothing allocated.  ``make_serve_step`` is the one-token
decode step over the dense cache.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..core import tree
from ..models.transformer import Model
from ..optim.adamw import AdamWConfig, adamw_init, adamw_update
from ..optim.compress import (CompressorConfig, compress_gradients,
                              init_residual)


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    opt: AdamWConfig = AdamWConfig()
    microbatches: int = 1
    compress: Optional[CompressorConfig] = None
    # the params' layout on a mesh (runtime/sharding.train_sharding);
    # the gradients come back in it
    grad_shardings: Optional[Any] = None


def make_train_step(model: Model, cfg: TrainStepConfig = TrainStepConfig()
                    ) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt,
    metrics).  With compression on, opt_state is (AdamWState, residual).
    With ``cfg.grad_shardings`` the step runs ``model`` gather-at-use on
    this rank's shards and rows (``TrainSharding.split_batch``).
    """
    shd = cfg.grad_shardings
    if shd is not None:
        if shd.mesh.size > 1 and model.opts.moe_mesh is None and any(
                ffn == "moe" for _, ffn in model.cfg.layer_kinds()):
            raise ValueError("a sharded MoE model runs expert-parallel: "
                             "set ExecOptions.moe_mesh (and expert_pad)")
        model = Model(model.cfg, model.dt, model.device,
                      dataclasses.replace(model.opts, sharding=shd))

    def grads_of(flat, rebuild, batch):
        loss, metrics = model.loss_fn(rebuild(flat), batch)
        # a leaf the loss never reads (an embedding-input arch's untied
        # ``embed``) gets zeros, as jax.value_and_grad gives it; AdamW
        # then decays it as JAX's step does
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(flat, grads)]
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    def train_step(params, opt_state, batch: Dict[str, torch.Tensor]):
        residual = None
        if cfg.compress is not None:
            opt_state, residual = opt_state
        flat, rebuild = tree.flatten(params)
        for p in flat:
            p.requires_grad_(True)
        mb = cfg.microbatches
        if mb > 1:
            # accumulate in the gradient's own dtype, as the JAX step
            g_acc = [torch.zeros_like(p, requires_grad=False) for p in flat]
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=flat[0].device)
            for i in range(mb):
                part = {k: v.reshape((mb, v.shape[0] // mb) + v.shape[1:])[i]
                        for k, v in batch.items()}
                loss, metrics, g = grads_of(flat, rebuild, part)
                g_acc = [a + b for a, b in zip(g_acc, g)]
                loss_sum = loss_sum + loss
            grads = [g / mb for g in g_acc]
            metrics["loss"] = loss_sum / mb
        else:
            _, metrics, grads = grads_of(flat, rebuild, batch)
        for p in flat:
            p.requires_grad_(False)
        grads = rebuild(grads)
        if cfg.compress is not None:
            grads, residual = compress_gradients(grads, residual,
                                                 cfg.compress, shd)
        new_params, new_opt, opt_metrics = adamw_update(
            grads, opt_state, params, cfg.opt, shd)
        metrics = {**metrics, **opt_metrics}
        if cfg.compress is not None:
            new_opt = (new_opt, residual)
        return new_params, new_opt, metrics

    return train_step


def init_train_state(model: Model, cfg: TrainStepConfig, seed: int = 0
                     ) -> Tuple[Any, Any]:
    """Seeded params (``Model.init``) and a fresh optimizer state."""
    params = model.init(seed)
    opt = adamw_init(params, cfg.opt)
    if cfg.compress is not None:
        opt = (opt, init_residual(params))
    return params, opt


def abstract_train_state(model: Model, cfg: TrainStepConfig
                         ) -> Tuple[Any, Any]:
    """(params, opt_state) on ``meta`` (JAX's ``jax.eval_shape`` of
    ``init_train_state``): ``Model.param_specs`` and the optimizer state
    built from them, with the compression residual when ``cfg.compress``
    is set."""
    params = model.param_specs()
    opt = adamw_init(params, cfg.opt)
    if cfg.compress is not None:
        opt = (opt, init_residual(params))
    return params, opt


def make_serve_step(model: Model) -> Callable:
    """serve_step(params, cache, batch, pos) -> (logits (B, V), cache):
    one new token for every sequence of ``batch`` ("tokens" (B, 1), or
    "embeddings" (B, 1, d); "positions" (B, 1, 3) for an M-RoPE arch) at
    position ``pos`` against the resident dense cache, which is written
    in place and returned."""

    def serve_step(params, cache, batch: Dict[str, torch.Tensor], pos: int):
        logits = model.decode_step(params, cache, batch.get("tokens"),
                                   pos=pos,
                                   embeddings=batch.get("embeddings"),
                                   positions=batch.get("positions"))
        return logits, cache

    return serve_step
