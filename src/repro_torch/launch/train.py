"""End-to-end training entry point: the port of ``repro/launch/train.py``.

Trains any arch: attention archs with MLP or MoE FFNs, token- or
embedding-input (musicgen-large, qwen2-vl-2b with M-RoPE positions), and
the recurrent archs (rwkv6-7b, recurrentgemma-9b), at its published size
on the card (the recurrent archs' fp32 state fits one card only with
their depth cut) or at its smoke size on the CPU, with the training
stack of this package: AdamW (optionally int8 moments, gradient
compression), the deterministic synthetic data stream, atomic
checkpoints, supervised restart and the straggler watch.  Every
attention forward runs the flash kernel and every attention backward the
fused recompute backward; every projection, MoE router and the head run
the matmul kernel forward and backward, and the MoE experts its grouped
route; every RWKV time mix runs the WKV kernel forward and the WKV
backward kernel.  Routing is by device (``--device``, default
``cuda``): there is no ``--dispatch`` mode.  At start the CLI reloads
the tuned-plan cache (``tune.cache.preload``), so the first step already
runs the kernels at their tuned plans.

The state is laid out on the host mesh as the JAX CLI lays it out:
``make_host_mesh()`` over the ranks that run (one by default; ``torchrun
--nproc-per-node N`` for more, N = 2 giving (data 1, model 2)) and
``make_rules(mesh, fsdp=True)``.  Each rank stores its shards of the
params and the optimizer state, takes its rows of every batch, and
gathers each leaf at its use over the data axis
(``runtime/sharding.TrainSharding``); the model axis splits each
layer's work (``runtime/model_axis.py``), its residual stream
replicated, as JAX's CLI sets no ``constrain``; a MoE arch runs
expert-parallel.  On one rank every spec replicates and no
collective runs.  Only rank 0 prints.  Ranks on one card run gloo and
draw the state in turn.

Examples:
  python -m repro_torch.launch.train --arch gemma-2b --steps 3 --batch 2 \\
      --seq 512 --ckpt-dir /tmp/ck                 # full width, on the card
  python -m repro_torch.launch.train --arch gemma-2b --smoke --steps 3 \\
      --batch 2 --seq 32 --device cpu --ckpt-dir /tmp/ck
  python -m repro_torch.launch.train --arch qwen2-vl-2b --steps 3 \\
      --batch 2 --seq 512 --ckpt-dir /tmp/ck    # embeddings, M-RoPE
  python -m repro_torch.launch.train --arch rwkv6-7b --smoke --steps 3 \\
      --batch 2 --seq 32 --device cpu --ckpt-dir /tmp/ck   # recurrent
  torchrun --nproc-per-node 2 -m repro_torch.launch.train --arch \\
      gemma-2b --smoke --steps 3 --batch 4 --seq 32 --device cpu \\
      --ckpt-dir /tmp/ck                           # two ranks, (1, 2)
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..checkpoint.checkpoint import CheckpointManager
from ..configs import get_arch
from ..core import tree
from ..core.memory import DtypePolicy
from ..data.pipeline import DataConfig, SyntheticLM
from ..kernels import dispatch
from ..models.transformer import ExecOptions, Model
from ..optim.adamw import AdamWConfig
from ..optim.compress import CompressorConfig
from ..runtime.fault_tolerance import FailureInjector, Supervisor
from ..runtime.sharding import (make_rules, shard_state, train_sharding,
                                tree_specs)
from ..train.steps import TrainStepConfig, init_train_state, make_train_step
from ..tune.cache import preload as preload_tuned
from .mesh import in_turn, make_host_mesh


def _silent(*args, **kwargs) -> None:
    """The printer of ranks other than 0."""


def sharded_train_state(model: Model, ts_cfg: TrainStepConfig, rules,
                        rows: int, seed: int = 0):
    """``init_train_state`` laid out on ``rules.mesh`` as the CLI lays it
    out: ((params, opt) shards, their spec tree, the params'
    ``TrainSharding`` for (micro)batches of ``rows`` rows, the whole
    params' element count).  Ranks sharing a card draw the whole state in
    turn, each keeping only its shards."""
    mesh = rules.mesh
    for _ in in_turn(mesh):
        params, opt = init_train_state(model, ts_cfg, seed=seed)
        n_params = sum(p.numel() for p in tree.leaves(params))
        shd = train_sharding(rules, params, rows)
        specs = (shd.specs, tree_specs(rules, opt))
        state = shard_state((params, opt), specs, mesh)
        del params, opt
    return state, specs, shd, n_params


def main(argv=None, report: Optional[Dict] = None) -> List[float]:
    """Run the CLI; returns the per-step losses.  A ``report`` dict, when
    given, receives the param count, the mesh, this rank's stored state
    bytes, the per-step seconds and MoE aux losses (0 without MoE
    layers), the dispatch routes and the last checkpoint's bytes and
    seconds."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--int8-moments", action="store_true")
    ap.add_argument("--ckpt-dir", default="/tmp/repro_torch_ckpt")
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--inject-failures", default="",
                    help="comma-separated steps to fail at (tests restore)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--d-model", type=int, default=0,
                    help="override width (with --smoke)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    mesh = make_host_mesh(device=args.device)
    rules = make_rules(mesh, fsdp=True)
    device = mesh.device
    say = print if mesh.rank == 0 else _silent
    preload_tuned(log=say)
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
        if args.d_model:
            cfg = dataclasses.replace(
                cfg, d_model=args.d_model, d_ff=4 * args.d_model)

    opts = ExecOptions(block_q=min(512, args.seq),
                       block_kv=min(512, args.seq), remat=True)
    if mesh.size > 1 and any(f == "moe" for _, f in cfg.layer_kinds()):
        opts = dataclasses.replace(
            opts, moe_mesh=mesh, moe_dp_axes=rules.dp_axes,
            expert_pad=rules.axis_size(rules.ep_axes))
    model = Model(cfg, dt=DtypePolicy(), device=device, opts=opts)
    ts_cfg = TrainStepConfig(
        opt=AdamWConfig(lr=args.lr, int8_moments=args.int8_moments,
                        warmup_steps=max(10, args.steps // 20),
                        total_steps=args.steps),
        microbatches=args.microbatches,
        compress=CompressorConfig() if args.compress_grads else None)
    (params, opt), specs, shd, n_params = sharded_train_state(
        model, ts_cfg, rules, args.batch // args.microbatches)
    ts_cfg = dataclasses.replace(ts_cfg, grad_shardings=shd)
    step_fn_raw = make_train_step(model, ts_cfg)
    say(f"mesh: {mesh.shape}  device: {device}  arch: {cfg.name} "
        f"({n_params / 1e6:.1f}M params)")

    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=args.seq, global_batch=args.batch,
                                  input_mode=cfg.input_mode,
                                  d_model=cfg.d_model))
    ckpt = CheckpointManager(args.ckpt_dir, keep=3, async_save=False,
                             specs=specs, mesh=mesh)
    injector = FailureInjector(
        [int(s) for s in args.inject_failures.split(",") if s]) \
        if args.inject_failures else None
    sup = Supervisor(ckpt, save_every=args.save_every, injector=injector)

    losses: List[float] = []
    auxes: List[float] = []
    step_seconds: List[float] = []
    started = {}

    def one_step(state, step):
        params, opt = state
        started[step] = time.perf_counter()
        batch = shd.split_batch({k: torch.from_numpy(v) for k, v in
                                 data.batch_at(step).items()},
                                args.microbatches)
        batch = {k: v.to(device) for k, v in batch.items()}
        if cfg.mrope_sections:
            # every section's stream is the text position, as the JAX
            # CLI builds it
            b, s = batch["labels"].shape
            batch["positions"] = torch.arange(
                s, dtype=torch.int32, device=device)[None, :, None].expand(
                    b, s, len(cfg.mrope_sections))
        params, opt, metrics = step_fn_raw(params, opt, batch)
        return (params, opt), metrics

    def on_metrics(step, metrics):
        # reading the loss waits for every kernel the step enqueued
        loss = float(metrics["loss"])
        step_seconds.append(time.perf_counter() - started[step])
        losses.append(loss)
        auxes.append(float(metrics["aux"]))
        if step % args.log_every == 0:
            say(f"step {step:5d}  loss {loss:.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}  "
                  f"lr {float(metrics['lr']):.2e}")

    dispatch.reset_stats()
    t0 = time.time()
    (params, opt), final = sup.run((params, opt), one_step, args.steps,
                                   on_metrics=on_metrics)
    dt = time.time() - t0
    tok_s = args.steps * args.batch * args.seq / dt
    say(f"done: {final} steps in {dt:.1f}s ({tok_s:,.0f} tok/s); "
          f"loss {losses[0]:.3f} -> {np.mean(losses[-5:]):.3f}; "
          f"restarts={sup.restarts} stragglers={len(sup.stragglers.flags)}")
    routes = dispatch.stats()
    say("[dispatch] routes: "
          + (", ".join(f"{op}/{r}={n}" for (op, r), n in sorted(
              routes.items())) or "none"))
    if report is not None:
        report.update(params=n_params, step_seconds=step_seconds,
                      mesh=dict(mesh.shape),
                      state_bytes=sum(t.numel() * t.element_size()
                                      for t in tree.leaves((params, opt))),
                      aux=auxes, seconds=dt,
                      routes=routes,
                      restarts=sup.restarts,
                      checkpoint_bytes=ckpt.last_bytes,
                      checkpoint_seconds=ckpt.last_seconds)
    return losses


if __name__ == "__main__":
    main()
