"""Rank processes for the port's tensor- and expert-parallel tests.

``torch.multiprocessing.spawn`` imports the module of the function it
starts in every child, so the rank functions live here, in a module that
imports neither JAX nor the JAX package.  Each rank joins a gloo process
group through a ``file://`` store in the test's temporary directory (no
fixed port), runs one thread, computes what its test asks for from the
numpy inputs it was handed, and writes its results to
``<out_dir>/rank<r>.pt``; the test process compares them with the JAX
package.
"""
from __future__ import annotations

import dataclasses
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

SLOTS, MAX_LEN, PAGE = 2, 64, 16


def spawn(fn, world: int, tmp_path, *args) -> list:
    """Run ``fn(rank, world, store, out_dir, *args)`` on ``world`` ranks;
    returns each rank's saved results, in rank order."""
    import torch.multiprocessing as mp
    store = os.path.join(str(tmp_path), "store")
    mp.spawn(fn, args=(world, store, str(tmp_path)) + tuple(args),
             nprocs=world, join=True)
    return [torch.load(os.path.join(str(tmp_path), f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


def _join(rank: int, world: int, store: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(minutes=3))


def _leave(rank: int, out_dir: str, results) -> None:
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def requests(vocab: int):
    """The JAX TP gate's traffic: 3 requests of 6 prompt tokens, 4 new."""
    from repro_torch.launch.loadgen import Request
    rng = np.random.default_rng(0)
    return [Request(i, rng.integers(0, vocab, 6), 4) for i in range(3)]


def streams(done) -> list:
    return [list(r.out) for r in sorted(done, key=lambda r: r.rid)]


def smoke_cfg(arch: str, kv_dtype: str = "", weights_dtype: str = ""):
    """The smoke config the tests serve: its head untied, so a random
    model's streams carry information."""
    from repro_torch.configs import ARCHS
    return dataclasses.replace(ARCHS[arch].smoke(), kv_cache="paged",
                               kv_dtype=kv_dtype,
                               weights_dtype=weights_dtype,
                               tie_embeddings=False)


def serve_streams(cfg, np_params, mesh=None):
    """Greedy streams of the port's ``PagedScheduler`` on params given as
    numpy arrays (fp32 compute on the CPU)."""
    from repro_torch.convert import params_from_jax
    from repro_torch.core.memory import DtypePolicy
    from repro_torch.launch.serve import PagedScheduler
    from repro_torch.models.transformer import Model
    model = Model(cfg, dt=DtypePolicy(compute=torch.float32), device="cpu")
    params = params_from_jax(np_params, "cpu", torch.float32)
    sched = PagedScheduler(model, params, slots=SLOTS, max_len=MAX_LEN,
                           page_size=PAGE, mesh=mesh, log=None)
    return streams(sched.run(requests(cfg.vocab_size)))


def tp_worker(rank, world, store, out_dir, cases, mlp_case, cli_argv):
    """The tensor-parallel tests' two ranks: the paged streams of every
    (arch, kv_dtype, weights_dtype, numpy params) case on a ``--mesh 2``
    scheduler with the counters inside the scope; a row-parallel int8
    ``mlp_apply``; and ``serve.main`` on ``cli_argv``."""
    _join(rank, world, store)
    from repro_torch.core.memory import DtypePolicy
    from repro_torch.kernels import dispatch
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models import layers
    from repro_torch.runtime import tp
    mesh = make_serving_mesh(2, device="cpu")
    results = {"coords": mesh.coords, "backend": mesh.backend, "cases": []}
    for arch, kv_dtype, np_params in cases:
        dispatch.reset_stats()
        got = serve_streams(smoke_cfg(arch, kv_dtype), np_params, mesh)
        results["cases"].append((got, dispatch.tp_stats()))

    # int8 weights, row-parallel wd: quantized after sharding, from each
    # rank's own slice
    p, x = mlp_case
    p = {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in p.items()}
    p = tp.shard_tree(p, {"wg": (None, "model"), "wu": (None, "model"),
                          "wd": ("model", None)}, mesh)
    q = {k: layers.quantize_weight(w, 0, 1) for k, w in p.items()}
    with dispatch.tp_scope(mesh.group("model")):
        results["mlp_int8"] = layers.mlp_apply(
            q, torch.from_numpy(np.asarray(x, np.float32)), "swiglu",
            DtypePolicy(compute=torch.float32), "int8").numpy()

    rep = serve.main(cli_argv)
    results["cli"] = streams(rep["done"])
    results["cli_tp"] = rep["tp"]
    _leave(rank, out_dir, results)


def moe_worker(rank, world, store, out_dir, shape, spec_kw, np_p, np_x,
               model_case):
    """``moe_apply_sharded`` on a ``shape`` (data, model) mesh: the output,
    aux loss and the gradients of ``sum(out * out)`` (this rank's expert
    shards, the whole router and input); and with ``model_case``, a
    MoE ``Model.forward`` with ``ExecOptions.moe_mesh`` set."""
    _join(rank, world, store)
    from repro_torch.convert import shards_from_jax
    from repro_torch.core.memory import DtypePolicy
    from repro_torch.kernels import dispatch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.moe import MoESpec
    from repro_torch.models.moe_sharded import moe_apply_sharded, moe_pspecs
    from repro_torch.models.transformer import ExecOptions, Model
    f32 = DtypePolicy(compute=torch.float32)
    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    s = MoESpec(**spec_kw)
    p = shards_from_jax({"moe": np_p}, moe_pspecs, mesh,
                        torch.float32)["moe"]
    for v in p.values():
        v.requires_grad_(True)
    x = torch.from_numpy(np.asarray(np_x, np.float32)).requires_grad_(True)
    dispatch.reset_stats()
    out, aux = moe_apply_sharded(p, s, x, f32, mesh=mesh, dp_axes=("data",))
    (out * out).sum().backward()
    results = {"coords": mesh.coords, "out": out.detach().numpy(),
               "aux": aux.item(), "dx": x.grad.numpy(),
               "dp": {k: v.grad.numpy() for k, v in p.items()},
               "routes": dispatch.stats()}
    if model_case is not None:
        cfg, np_params, tokens, pad = model_case
        opts = ExecOptions(moe_mesh=mesh, moe_dp_axes=("data",),
                           expert_pad=pad)
        model = Model(cfg, dt=f32, device="cpu", opts=opts)
        params = shards_from_jax(np_params, moe_pspecs, mesh, torch.float32)
        dispatch.reset_stats()
        with torch.no_grad():
            logits = model.forward(params, {"tokens": torch.from_numpy(
                np.asarray(tokens, np.int32))})
        results["model_logits"] = logits.numpy()
        results["model_routes"] = dispatch.stats()
    _leave(rank, out_dir, results)

